"""The wavefront with the remaining surface materials against the
reference, on the CPU: the port's make_persistent_fn against pbrt_tpu's
persistent wavefront at 24x16, 4 spp, seed 3 (test_torch_render's helpers
and tolerances), on two small rooms of material_room(4)'s meshes (wide
scenes), one reference compile each:

- "fourier-hair": a rough-conductor fourier box and a tuft of 8 hair curves
  of 16 segments on the floor (256 triangles), the other walls as
  material_room's. Tolerance: test_torch_render's for specular lobes
  (weights allclose, path vertices within 4, per-pixel |dL| / (|L| + 1e-2)
  < 2e-2, mean |dL| < 1e-4), with one pixel allowed on the roulette
  threshold (RR_BOOST), as its glass scenes.
- "substrate-translucent-disney-mix": zoo_room(4)'s anisotropic substrate
  floor, disney wall, translucent quad and the right wall mixing plastic
  and copper at 0.35, with material_room's glass box; rendered twice by
  the same compiled routes:
  - with the mix's second sub-row pointed at its first (the tables'
    P_EXTRA, in both packages): the image no longer depends on which
    sub-row a hit takes, and the tolerance is the specular one above;
  - as built. The mix's choice hashes the hit point's float bits. The
    reference's p comes from XLA:CPU's jitted code, which contracts the
    barycentric sums into fused multiply-adds; PyTorch rounds each
    operation, so where p differs by an ulp the packages pick independent
    sub-rows and the sample's path differs from there on (make_bsdf holds
    the choice bit for bit on the same p, tests/test_torch_materials.py).
    Every path that meets the wall can diverge: 162 of the 384 pixels
    fall outside the per-pixel tolerance here (the image means differ by
    0.21%, the path vertices by 0.25%). The render is held as an estimate
    instead: the image mean within 2%, the path vertices within 1%, and at
    most 60% of the pixels outside the per-pixel tolerance.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu_torch import render

from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch.scene.builder import compile_scene
from pbrt_tpu_torch.scene.host import HostMaterial, HostPrimitive, ShapeRecord
from pbrt_tpu_torch.scenes import hair_tuft, zoo_room
from test_torch_megakernel import _to_ref
from test_torch_render import _assert_specular_tolerance, _port_wave, _reference_wave, _small
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)


def _room_a(table_dir):
    desc = zoo_room(4, table_dir=table_dir)
    desc.primitives[7].material = HostMaterial(kind="glass", params={})
    desc.primitives = desc.primitives[:-1]  # no hair
    return desc


def _room_b(table_dir):
    from pbrt_tpu_torch.scenes import material_room

    desc = material_room(4)
    box = zoo_room(4, table_dir=table_dir).primitives[7]
    desc.primitives[7].material = box.material
    desc.primitives.append(HostPrimitive(shape=ShapeRecord(mesh=hair_tuft((-1.0, 0.6), n_curves=8, n_segments=16)),
                                         material=HostMaterial(kind="hair", params={"eumelanin": ("const", 1.3)})))
    return desc


@pytest.fixture(autouse=True)
def _no_widemega(monkeypatch):
    monkeypatch.delenv("PBRT_TPU_WIDEMEGA", raising=False)


def _off(L, L_r):
    return (np.abs(L - L_r) / (np.abs(L_r) + 1e-2)).max(-1) >= 2e-2


def test_fourier_and_hair_match_reference(tmp_path):
    desc = _small(_room_b(str(tmp_path)))
    _tier_r, ref_out = _reference_wave(ref_compile_scene(_to_ref(desc)))
    tier, out = _port_wave(compile_scene(desc, "cpu"))
    assert tier == "torch-wavefront/plain-wide"
    _assert_specular_tolerance(*out, *ref_out, rr_pixels=1)


@pytest.fixture(scope="module")
def room_a(tmp_path_factory):
    """The port's and the reference's renders of room A, with the mix's
    sub-rows the same ("same-sub-rows") and as built ("as-built"), each
    package's route compiled once."""
    from pbrt_tpu import render as ref_render
    from test_torch_render import _pixels, SEED, SPP

    desc = _small(_room_a(str(tmp_path_factory.mktemp("tables"))))
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    mix = int(np.nonzero(cs.arrays.mat_kind.numpy() == 10)[0][0])
    const = cs.arrays.mat_const.clone()
    const[mix, 12, 1] = const[mix, 12, 0]
    same = dataclasses.replace(cs.arrays, mat_const=const)
    ref_same = dataclasses.replace(ref.arrays, mat_const=jnp.asarray(const.numpy()))
    px, py, pids = _pixels()
    wave_r = ref_render.make_persistent_fn(ref)
    args_r = (jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)), jnp.asarray(pids.astype(np.uint32)),
              jnp.uint32(0), SPP, jnp.uint32(SEED))
    wave = render.make_persistent_fn(cs)
    assert render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-wide"
    args = [torch.as_tensor(x.astype(np.int64)) for x in (px, py, pids)] + [0, SPP, SEED]
    out = {}
    for name, sa, sa_r in (("same-sub-rows", same, ref_same), ("as-built", cs.arrays, ref.arrays)):
        out[name] = (tuple(x.numpy() for x in wave(sa, *args)), tuple(np.asarray(x) for x in wave_r(sa_r, *args_r)))
    return out


def test_new_materials_match_reference(room_a):
    out, ref_out = room_a["same-sub-rows"]
    _assert_specular_tolerance(*out, *ref_out, rr_pixels=1)


def test_mix_renders_the_reference_estimate(room_a):
    (L, w, nv), (L_r, w_r, nv_r) = room_a["as-built"]
    np.testing.assert_allclose(w, w_r)
    assert abs(float(nv.sum()) / float(nv_r.sum()) - 1.0) < 0.01
    assert abs(float(L.mean()) / float(L_r.mean()) - 1.0) < 0.02
    off = _off(L, L_r)
    assert 0 < off.mean() <= 0.6
