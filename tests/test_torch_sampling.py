"""The port's counter-based RNG, samplers and camera regeneration against
the reference's.

Hashes and sample values must be bit-exact: the port carries uint32 in
int64 and masks after every multiply, add and left shift. Camera rays agree
within atol 1e-6 (the same float32 operations in the same order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pbrt_tpu import render as ref_render
from pbrt_tpu.device import rng as ref_rng
from pbrt_tpu.device import sampler as ref_sampler
from pbrt_tpu.device.camera import make_camera as ref_make_camera
from pbrt_tpu_torch import render
from pbrt_tpu_torch.device import rng, sampler
from pbrt_tpu_torch.device.camera import make_camera
from pbrt_tpu_torch.scenes import mesh_room

SEED = 12345


def _grid():
    """(pixel, sample, dim) grid from a seed, uint32 pixels up to 2^32-1."""
    rs = np.random.RandomState(0)
    pixel = np.concatenate([rs.randint(0, 2 ** 32, 300, dtype=np.uint64),
                            [0, 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    sample = rs.randint(0, 1 << 20, pixel.size).astype(np.uint32)
    dims = rs.randint(0, 64, pixel.size).astype(np.int32)
    return pixel, sample, dims


def _t(x):
    return torch.as_tensor(x.astype(np.int64))


def test_pcg_hash_bit_exact():
    pixel, sample, _ = _grid()
    x = pixel ^ (sample * np.uint32(2654435761))
    np.testing.assert_array_equal(rng.pcg_hash(_t(x)).numpy(), np.asarray(ref_rng.pcg_hash(jnp.asarray(x))))


def test_hash_combine_bit_exact():
    pixel, sample, dims = _grid()
    ref = np.asarray(ref_rng.hash_combine(SEED, jnp.asarray(pixel), jnp.asarray(sample), jnp.asarray(dims)))
    got = rng.hash_combine(SEED, _t(pixel), _t(sample), torch.as_tensor(dims)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["zerotwosequence", "random"])
@pytest.mark.parametrize("dim_form", ["int", "tensor"])
def test_samples_bit_exact(kind, dim_form):
    pixel, sample, dims = _grid()
    for dim in ([0, 1, 5, 33] if dim_form == "int" else [dims]):
        d_ref = dim if isinstance(dim, int) else jnp.asarray(dim)
        d_port = dim if isinstance(dim, int) else torch.as_tensor(dim)
        r1 = ref_sampler.sample_1d(kind, SEED, jnp.asarray(pixel), jnp.asarray(sample), d_ref, 16)
        p1 = sampler.sample_1d(kind, SEED, _t(pixel), _t(sample), d_port, 16)
        np.testing.assert_array_equal(p1.numpy(), np.asarray(r1))
        ru, rv = ref_sampler.sample_2d(kind, SEED, jnp.asarray(pixel), jnp.asarray(sample), d_ref, 16)
        pu, pv = sampler.sample_2d(kind, SEED, _t(pixel), _t(sample), d_port, 16)
        np.testing.assert_array_equal(pu.numpy(), np.asarray(ru))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        assert pu.dtype == torch.float32 and float(pu.max()) < 1.0


# (x_samples, y_samples, jitter) declared for 8 spp, as render_compiled
# registers them in the reference and make_persistent_fn puts them in scfg
STRATA = {"undeclared": None, "4x2": (4, 2, True), "4x2-jitter-off": (4, 2, False), "3x3-fallback": (3, 3, True)}


@pytest.mark.parametrize("strata", list(STRATA))
@pytest.mark.parametrize("dim_form", ["int", "tensor"])
def test_stratified_bit_exact(strata, dim_form, monkeypatch):
    """The stratified sampler: film and other int dims in strata (the
    declared shape when x * y == spp, else floor(sqrt(spp)) x spp // that),
    tensor dims from the random stream; against the reference with its
    module global set (and restored) to the same declaration."""
    spp = 8
    decl = STRATA[strata]
    if decl is None:
        monkeypatch.setattr(ref_sampler, "_STRATIFIED_SHAPE", None)
        monkeypatch.setattr(ref_sampler, "_STRATIFIED_JITTER", True)
    else:
        monkeypatch.setattr(ref_sampler, "_STRATIFIED_SHAPE", decl[:2])
        monkeypatch.setattr(ref_sampler, "_STRATIFIED_JITTER", decl[2])
    pixel, sample, dims = _grid()
    sample = sample % spp
    for dim in ([0, 1, 2, 7] if dim_form == "int" else [dims]):
        d_ref = dim if isinstance(dim, int) else jnp.asarray(dim)
        d_port = dim if isinstance(dim, int) else torch.as_tensor(dim)
        args_r = (SEED, jnp.asarray(pixel), jnp.asarray(sample), d_ref, spp)
        args_p = (SEED, _t(pixel), _t(sample), d_port, spp)
        np.testing.assert_array_equal(sampler.sample_1d("stratified", *args_p, strata=decl).numpy(),
                                      np.asarray(ref_sampler.sample_1d("stratified", *args_r)))
        pu, pv = sampler.sample_2d("stratified", *args_p, strata=decl)
        ru, rv = ref_sampler.sample_2d("stratified", *args_r)
        np.testing.assert_array_equal(pu.numpy(), np.asarray(ru))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        if isinstance(dim, int) and decl is not None and not decl[2]:
            assert set(np.unique(pu.numpy() * decl[0] % 1.0)) == {0.5}  # stratum centres


def test_lowdiscrepancy_is_the_02_sequence():
    pixel, sample, _dims = _grid()
    args = (SEED, _t(pixel), _t(sample), 3, 16)
    assert torch.equal(sampler.sample_1d("lowdiscrepancy", *args), sampler.sample_1d("zerotwosequence", *args))
    for x, y in zip(sampler.sample_2d("lowdiscrepancy", *args), sampler.sample_2d("zerotwosequence", *args)):
        assert torch.equal(x, y)


def test_other_samplers_raise():
    with pytest.raises(NotImplementedError):
        sampler.sample_1d("halton", SEED, torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.int64), 0, 16)


class _Static:
    tex_programs = ()


@pytest.mark.parametrize("lens_radius", [0.0, 0.05])
def test_make_regen_matches(lens_radius):
    W, H = 40, 20
    ref_desc, desc = bench._mesh_scene(8), mesh_room(8)
    for dsc in (ref_desc, desc):
        dsc.film.x_resolution, dsc.film.y_resolution = W, H
        dsc.camera.lens_radius = lens_radius
        dsc.camera.focal_distance = 4.0
    ys, xs = np.mgrid[0:H, 0:W]
    px, py, pids = xs.ravel(), ys.ravel(), (ys * W + xs).ravel()
    scfg = {"kind": "zerotwosequence", "spp": 16}
    fcfg = {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")}
    s_idx = np.arange(px.size) % 16
    ref_regen = ref_render.make_regen(ref_make_camera(ref_desc.camera, ref_desc.film), _Static(), scfg, fcfg,
                                      jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)),
                                      jnp.asarray(pids.astype(np.uint32)), jnp.uint32(SEED))
    o_r, d_r, w_r, _dx, _dy = (np.asarray(x) for x in ref_regen(jnp.asarray(s_idx.astype(np.uint32))))
    regen = render.make_regen(make_camera(desc.camera, desc.film, "cpu"), scfg, fcfg,
                              _t(px), _t(py), _t(pids), SEED)
    o, d, w = (x.numpy() for x in regen(_t(s_idx)))
    np.testing.assert_allclose(o, o_r, atol=1e-6, rtol=0)
    np.testing.assert_allclose(d, d_r, atol=1e-6, rtol=0)
    np.testing.assert_allclose(w, w_r, atol=1e-6, rtol=0)
