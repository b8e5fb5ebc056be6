"""The port's textures and MIP maps against the reference's, on the CPU.

Each case compiles a one-quad scene whose matte Kd is the texture under
test in both packages (the tables are the reference's, bit for bit), then
evaluates every texture program with eval_textures at the same 512 seeded
(uv, p) points and, for the MIPMap lookups, the same seeded footprint
derivatives: every kind of pbrt_tpu/device/texture.py (constant, scale,
mix, bilerp, imagemap bilinear / trilinear / EWA under the repeat, clamp
and black wraps, uv, checkerboard 2D and 3D, dots, fbm, wrinkled, windy,
marble) under the uv, spherical, cylindrical and planar mappings. The
reference runs op by op (no jit), as does PyTorch, so both round each
operation; values agree within rtol 1e-5, atol 1e-5 (sin, log2, atan2 and
arccos differ by ulps between the two libraries; the EWA sum adds each
window row's eight taps before the row, the reference tap by tap).

The reference's known faults are reproduced, not fixed (ROADMAP C): the
noise textures' roughness, scale and variation are overwritten by the
texture matrix (so fbm's omega is the identity's m[1][2] = 0), the
texture-space transform is never applied (spherical, cylindrical and the
noise textures read world p), and checkerboard "aamode" is dropped.

build_pyramid gives the reference's levels bit for bit, also for images
whose sides are not powers of two (the Lanczos resampling), and
lookup_trilinear and lookup_ewa agree with the reference's on random
footprints.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.device import mipmap as ref_mipmap
from pbrt_tpu.device.texture import eval_textures as ref_eval_textures
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch.device import mipmap
from pbrt_tpu_torch.device.texture import eval_textures, prepare_atlases
from pbrt_tpu_torch.scene.builder import compile_scene
from pbrt_tpu_torch.scene.host import HostMaterial
from pbrt_tpu_torch.scenes import _texture, textured_gallery
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

RTOL, ATOL = 1e-5, 1e-5
N = 512


def _c(v):
    return ("const", np.asarray(v, np.float64))


def _image(h, w, seed=7):
    return np.random.RandomState(seed).uniform(0.05, 1.0, (h, w, 3)).astype(np.float32)


def _tex(case):
    """The texture of a case id: kind[-variant][-wrap]."""
    parts = case.split("-")
    kind = parts[0]
    if kind == "imagemap":
        _, filt, wrap = parts[:3]
        mapping = parts[3] if len(parts) > 3 else "uv"
        return _texture("imagemap", image=_image(20, 24), wrap=wrap, trilinear=filt == "trilinear",
                        uscale=1.5, vscale=0.75, udelta=0.1, mapping=mapping, max_aniso=4.0, scale=1.25)
    if kind == "uv":
        return _texture("uv", mapping=parts[1], uscale=2.0, vscale=3.0, udelta=0.25, vdelta=-0.5,
                        v1=np.array([0.3, 1.0, -0.2]), v2=np.array([-0.4, 0.1, 0.9]))
    if kind == "checkerboard":
        return _texture("checkerboard", dimension=int(parts[1][0]), tex1=_c([0.9, 0.8, 0.7]),
                        tex2=("texture", _texture("uv")), uscale=4.0, vscale=4.0, aa_mode="none")
    if kind == "constant":
        return _texture("constant", value=np.array([0.3, 0.6, 0.9]))
    if kind == "scale":
        return _texture("scale", tex1=("texture", _texture("uv")), tex2=_c([0.5, 2.0, 1.0]))
    if kind == "mix":
        return _texture("mix", tex1=_c([1.0, 0.0, 0.0]), tex2=("texture", _texture("uv")),
                        amount=("texture", _texture("fbm", is_float=True, octaves=3)))
    if kind == "bilerp":
        return _texture("bilerp", tex1=_c([1.0, 0.0, 0.0]), tex2=_c([0.0, 1.0, 0.0]), v01=_c([0.0, 0.0, 1.0]),
                        v10=("texture", _texture("uv")), uscale=2.0, vscale=2.0)
    if kind == "dots":
        return _texture("dots", tex1=_c([1.0, 1.0, 0.0]), tex2=_c([0.1, 0.1, 0.4]), uscale=6.0, vscale=6.0)
    if kind in ("fbm", "wrinkled", "windy"):
        return _texture(kind, is_float=True, octaves=5, roughness=0.7)
    assert kind == "marble"
    return _texture("marble", octaves=6, scale=3.0, variation=0.4)


CASES = ["constant", "scale", "mix", "bilerp", "uv-uv", "uv-spherical", "uv-cylindrical", "uv-planar",
         "checkerboard-2d", "checkerboard-3d", "dots", "fbm", "wrinkled", "windy", "marble"] + [
    f"imagemap-{f}-{w}" for f in ("bilinear", "trilinear", "ewa") for w in ("repeat", "clamp", "black")] + [
    "imagemap-ewa-repeat-planar"]


def _scenes(tex):
    desc = textured_gallery(8)
    desc.primitives = desc.primitives[:1]
    desc.primitives[0].material = HostMaterial(kind="matte", params={"Kd": ("texture", tex)})
    return compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))


def _inputs(seed=3):
    rs = np.random.RandomState(seed)
    uv = rs.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    p = rs.uniform(-6.0, 6.0, (N, 3)).astype(np.float32)
    # footprints from sub-texel to many texels, some very anisotropic
    scale = np.exp(rs.uniform(np.log(1e-4), np.log(0.5), (N, 1)))
    dx = (rs.normal(size=(N, 2)) * scale).astype(np.float32)
    dy = (rs.normal(size=(N, 2)) * scale * np.exp(rs.uniform(-3, 0, (N, 1)))).astype(np.float32)
    return uv, p, dx, dy


@pytest.mark.parametrize("case", CASES)
def test_eval_textures_matches_reference(case):
    cs, ref = _scenes(_tex(case))
    np.testing.assert_array_equal(cs.arrays.tex_param.numpy(), np.asarray(ref.arrays.tex_param))
    uv, p, dx, dy = _inputs()
    with_duv = "bilinear" not in case
    duv = (dx, dy) if with_duv else (None, None)
    got = eval_textures(cs.arrays, cs.static.tex_programs, torch.as_tensor(uv), torch.as_tensor(p),
                        *(None if x is None else torch.as_tensor(x) for x in duv),
                        atlases=prepare_atlases(cs.arrays, cs.static))
    want = np.asarray(ref_eval_textures(ref.arrays, ref.static.tex_programs, jnp.asarray(uv), jnp.asarray(p),
                                        *(None if x is None else jnp.asarray(x) for x in duv)))
    assert len(got) == want.shape[0] == len(cs.static.tex_programs)
    for x, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=f"program {x}")
    assert float(np.abs(want).max()) > 0 or case in ("fbm", "windy")


@pytest.mark.parametrize("shape", [(16, 16), (12, 20), (1, 5), (7, 1)])
def test_build_pyramid_bit_identical(shape):
    """Power-of-two images halve; the others are first resampled up to
    powers of two with the Lanczos filter (both bit for bit)."""
    img = _image(*shape, seed=11)
    got, want = mipmap.build_pyramid(img), ref_mipmap.build_pyramid(img)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
def test_mip_lookups_match_reference(wrap):
    levels = ref_mipmap.build_pyramid(_image(32, 64, seed=2))
    uv, _p, dx, dy = _inputs(seed=9)
    u, v = uv[:, 0], uv[:, 1]
    t_levels = [torch.as_tensor(x) for x in levels]
    j_levels = [jnp.asarray(x) for x in levels]
    width = (2.0 * np.maximum(np.abs(dx).max(-1), np.abs(dy).max(-1))).astype(np.float32)
    got = mipmap.lookup_trilinear(t_levels, torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(width), wrap)
    want = ref_mipmap.lookup_trilinear(j_levels, jnp.asarray(u), jnp.asarray(v), jnp.asarray(width), wrap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    got = mipmap.lookup_ewa(t_levels, torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(dx),
                            torch.as_tensor(dy), wrap, max_anisotropy=8.0)
    want = ref_mipmap.lookup_ewa(j_levels, jnp.asarray(u), jnp.asarray(v), jnp.asarray(dx), jnp.asarray(dy), wrap,
                                 max_anisotropy=8.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
