"""The wide megakernel against the reference kernel itself, on the CPU: the
heavier half of tests/test_torch_megakernel_wide.py's reference-kernel
cases, and the mixed scenes (full spheres and sphere lamps beside the
triangles' wide tables) with glossy uber rows.

Each reference run is the reference kernel in Pallas interpret mode, whose
compile dominates a case; the cases here and there are split so that the
two files, one worker each, take about equal time. Covered here:

(a) wide_megakernel_plain against the reference kernel on the reference
    test's cases of REF_CASES_ELSEWHERE, with its tolerance
    (tests/test_megakernel_wide.py:190-198);
(b) the mixed rooms of the reference test (:251 two spheres, :312 a sphere
    lamp) and one with a glossy uber sphere: extract_wide_consts equals
    the reference's (the spheres, the sphere lamp's light entry, the uber
    row baked as Lambert + GGX), pack_wide_consts writes the spheres' and
    the lamp's records, and at 24x12, 2 spp, the twin, and the route under
    PBRT_TPU_WIDEMEGA=1, match the reference kernel under the same
    tolerance.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu.device import megakernel_wide as ref_mw
from pbrt_tpu_torch import render
from pbrt_tpu_torch.device import megakernel_wide as mw
from pbrt_tpu_torch.device.megakernel import LOBE_PLASTIC
from pbrt_tpu_torch.scene.arrays import LIGHT_AREA
from test_torch_megakernel_wide import (
    CASES, FCFG, REF_CASES_ELSEWHERE, SPP, _assert_wide_tolerance, _both, _case, _mixed_room, _pixels,
    _reference_image, _route_image, _small, _twin_against_reference,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

ICFG = {"kind": "path", "max_depth": 4, "rr_threshold": 1.0, "light_strategy": "power"}
SCFG = {"kind": "zerotwosequence", "spp": SPP}


@pytest.mark.parametrize("case", [c for c in CASES if c in REF_CASES_ELSEWHERE])
def test_plain_matches_reference_kernel(case):
    _twin_against_reference(*_case(case))


@pytest.mark.parametrize("kind", ["spheres", "lamp", "uber"])
def test_extract_wide_consts_of_mixed_rooms(kind):
    """The mixed rooms are in both classes, with the same baked spheres,
    lights (the sphere lamp's entry with its world center and radius) and
    material entries (a glossy uber row bakes as the Lambert + GGX class);
    the spheres select the sphere instantiations (ext 2)."""
    desc = _mixed_room(kind)
    cs, ref, cam, ref_cam = _both(desc)
    mine = mw.extract_wide_consts(cs, cam, ICFG, SCFG, FCFG, mw.DEFAULT_MAX_TRIS)
    theirs = ref_mw.extract_wide_consts(ref, ref_cam, ICFG, SCFG, FCFG)
    assert mine is not None and theirs is not None
    assert len(mine["spheres"]) == len(theirs["spheres"]) == cs.static.n_spheres
    for a, b in zip(mine["spheres"], theirs["spheres"]):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)
    assert len(mine["lights"]) == len(theirs["lights"])
    for a, b in zip(mine["lights"], theirs["lights"]):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)
    assert mine["mats"] == {m: {k: v for k, v in e.items() if v is not None} for m, e in theirs["mats"].items()}
    assert any(lt.get("sphere") for lt in mine["lights"]) == (kind != "spheres")
    if kind == "uber":
        uber_row = int(cs.arrays.prim_mat[cs.arrays.sph_prim_ids[1]])
        assert mine["mats"][uber_row]["lobe"] == LOBE_PLASTIC
    assert mw.kernel_mode(mine) == 4 * mw.N_SAMPLER_IDS + 1


def test_pack_wide_consts_writes_the_spheres():
    """The spheres' records past BLOB_FLOATS and the sphere lamp's light
    record, as csrc/megakernel_wide.cu reads them, in float32."""
    desc = _mixed_room("uber")
    cs, _ref, cam, _ref_cam = _both(desc)
    consts = mw.extract_wide_consts(cs, cam, ICFG, SCFG, FCFG, mw.DEFAULT_MAX_TRIS)
    b = mw.pack_wide_consts(consts).numpy().astype(np.float64)
    assert b.shape == (mw.SPH_BLOB_FLOATS,) and int(b[mw.SPH_BASE]) == len(consts["spheres"]) == 3

    def f32(x):
        return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)

    for j, sp in enumerate(consts["spheres"]):
        o = mw.SPH_BASE + mw.SPH_HEADER + j * mw.SPH_STRIDE
        assert (b[o + mw.S_LIGHT], b[o + mw.S_MAT], b[o + mw.S_FLAGS]) == (sp["light"], sp["mat"], sp["flags"])
        np.testing.assert_array_equal(b[o + mw.S_W2O:o + mw.S_W2O + 12], f32(sp["w2o"]).ravel())
        np.testing.assert_array_equal(b[o + mw.S_O2W:o + mw.S_O2W + 12], f32(sp["o2w"]).ravel())
        assert b[o + mw.S_R] == f32(sp["r"]) and b[o + mw.S_R2] == f32(sp["r"] * sp["r"])
    (i, lamp), = [(i, lt) for i, lt in enumerate(consts["lights"]) if lt.get("sphere")]
    o = mw.LIGHT_BASE + i * mw.LIGHT_STRIDE
    assert b[o + mw.L_KIND] == LIGHT_AREA and consts["spheres"][int(b[o + mw.L_SPH]) - 1]["light"] == i
    np.testing.assert_array_equal(b[o + mw.L_C:o + mw.L_C + 3], f32(lamp["c"]))
    assert (b[o + mw.L_RW], b[o + mw.L_RW2], b[o + mw.L_RW2X], b[o + mw.L_ROBJ]) == (
        f32(lamp["r"]), f32(lamp["r"] ** 2), f32(lamp["r"] ** 2 * 1.0001), f32(lamp["r_obj"]))


def test_mixed_room_matches_reference_kernel(monkeypatch):
    """The uber room (a sphere lamp, a glossy uber and a glass sphere beside
    the room's triangles) at 24x12, 2 spp: the twin (spheres merged against
    the walk's winner, NEE toward the lamp by its visible cone, the cone's
    density on an emission hit) and the route under PBRT_TPU_WIDEMEGA=1
    against the reference kernel, under the reference test's tolerance."""
    desc = _small(_mixed_room("uber"), 24, 12)
    desc.integrator.max_depth = ICFG["max_depth"]
    cs, ref, cam, ref_cam = _both(desc)
    ref_out = _reference_image(ref, ref_cam, ICFG, SCFG, FCFG, 24, 12)
    consts = mw.extract_wide_consts(cs, cam, ICFG, SCFG, FCFG, mw.DEFAULT_MAX_TRIS)
    px, py, pid = (torch.as_tensor(x.astype(np.int64)) for x in _pixels(24, 12))
    out = [x.numpy() for x in mw.wide_megakernel_plain(consts, cs.arrays, px, py, pid, 0, SPP, 0)]
    _assert_wide_tolerance(*out, *ref_out)
    monkeypatch.setenv("PBRT_TPU_WIDEMEGA", "1")
    route = _route_image(cs)
    assert render.LAST_PERSISTENT_TIER == "torch-megakernel/plain-wide"
    _assert_wide_tolerance(*route, *ref_out)
