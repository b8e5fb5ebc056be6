"""The port's participating media against the reference, on the CPU.

- Tables: compile_scene of the small fog room (770 room prims, the
  interface box, a homogeneous fog as the camera's medium and an 8^3 grid
  of smoke), of the small sss room (subsurface and kdsubsurface spheres),
  of the sss room under PBRT_TPU_NO_TABSSS=1 (each subsurface row's
  implicit walk medium) and of the fog and sss rooms written as .pbrt files
  (each package compiling its own parse) give the reference's tables bit
  for bit (prim_medium, med_param, med_w2m, med_grids, the sss_* rows and
  every other table) and its media statics.
- The grid's corner table (one 32-byte row per voxel, which the tracking
  kernel reads): every row holds the grid's eight taps, 0 outside,
  and the lookup through it is the twin's density bit for bit.
- Functions, on 4,096 rays in the fog room with media rows, distances and
  uint32 keys from a numpy seed, the reference called op by op (its
  tracking loops are jitted lax.while_loops): hg_p and hg_sample, the grid
  lookup, medium_sample (homogeneous and grid lanes), medium_tr and
  transmittance_shadow (8 null-crossing queries through the box). The
  delta- and ratio-tracking twins (device/medium_track.py) make the
  reference's decisions on every ray: the same collisions, the same
  steps. Distances, weights and transmittances agree within rtol 1e-5:
  the reference's compiled loop body contracts a multiply-add into an FMA
  where PyTorch rounds twice, so t and the trilinear densities differ by an
  ulp or so (a step's log is then one ulp apart, and so is the next t).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.device import media as ref_media
from pbrt_tpu.parser.api import pbrt_parse as ref_pbrt_parse
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch import scenes
from pbrt_tpu_torch.device import integrator, media, medium_track, rng
from pbrt_tpu_torch.parser.api import pbrt_parse
from pbrt_tpu_torch.scene.arrays import scene_byte_size
from pbrt_tpu_torch.scene.builder import compile_scene
from test_torch_api import _tables_equal
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

N = 4096
MEDIA_STATICS = ("n_media", "media_kinds", "camera_medium", "has_null_material", "has_sss_media", "sss_media",
                 "has_tab_sss", "mat_kinds_present")


def _statics_equal(cs, ref):
    for name in MEDIA_STATICS:
        mine, theirs = getattr(cs.static, name), getattr(ref.static, name)
        assert mine == (tuple(int(x) if not isinstance(x, str) else x for x in theirs)
                        if isinstance(theirs, tuple) else theirs), name


def _small(name):
    return scenes.fog_room(8, 8) if name == "fog" else scenes.sss_room(8, 8, 8)


@pytest.mark.parametrize("name", ["fog", "sss", "sss-walk", "fog-file", "sss-file"])
def test_media_tables_bit_identical(name, tmp_path, monkeypatch):
    """The small rooms, the sss room's walk media and both written files."""
    if name == "sss-walk":
        monkeypatch.setenv("PBRT_TPU_NO_TABSSS", "1")
    desc = _small(name.split("-")[0])
    cs = compile_scene(desc, "cpu")
    if name.endswith("file"):
        path = str(tmp_path / "room.pbrt")
        scenes.write_pbrt(desc, path, scenes.ROOM_LOOK_AT)
        parsed = compile_scene(pbrt_parse(path), "cpu")
        ref = ref_compile_scene(ref_pbrt_parse(path))
        _tables_equal(parsed, ref)
        _statics_equal(parsed, ref)
        _tables_equal(cs, ref)  # the written file compiles to the description's tables
        return
    ref = ref_compile_scene(_to_ref(desc))
    _tables_equal(cs, ref)
    _statics_equal(cs, ref)
    if name == "fog":
        assert cs.static.media_kinds == ("homogeneous", "heterogeneous") and cs.static.camera_medium == 0
        assert cs.static.has_null_material and (cs.arrays.prim_medium >= 0).sum() == 24
    elif name == "sss":
        assert cs.static.has_tab_sss and cs.arrays.sss_prof.shape[1:] == (3, 64)
    else:
        assert cs.static.has_sss_media and len(cs.static.sss_media) == 2 and cs.arrays.sss_prof is None


@pytest.fixture(scope="module")
def fog():
    """The fog room in both packages and N rays: half from points of the
    room toward the smoke box (crossing it), half at random; media rows of
    vacuum, the fog and the smoke; surface distances and keys."""
    desc = scenes.fog_room(8, 8)
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    rs = np.random.RandomState(9)
    lo, hi = (np.asarray(v) for v in scenes.FOG_BOX)
    o = rs.uniform([-3.5, -0.5, -3.5], [3.5, 3.5, 3.5], (N, 3))
    o[: N // 2] = lo + rs.random_sample((N // 2, 3)) * (hi - lo)  # inside the smoke box
    target = lo + rs.random_sample((N, 3)) * (hi - lo)
    d = np.where(np.arange(N)[:, None] < N // 4, rs.normal(size=(N, 3)), target - o + 1e-3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    med = np.where(np.arange(N) < N // 2, 1, rs.randint(-1, 2, N))
    host = {"o": o.astype(np.float32), "d": d.astype(np.float32), "med": med,
            "t": rs.uniform(0.05, 4.0, N).astype(np.float32), "key": rs.randint(0, 2 ** 32, N, dtype=np.int64),
            "g": rs.uniform(-0.9, 0.9, N).astype(np.float32), "u": rs.random_sample((2, N)).astype(np.float32)}
    return cs, ref, host


def _t(h, k, dtype=None):
    return torch.as_tensor(h[k]) if dtype is None else torch.as_tensor(h[k], dtype=dtype)


def _j(h, k, dtype=None):
    return jnp.asarray(h[k] if dtype is None else h[k].astype(dtype))


def test_phase_function_matches_reference(fog):
    _cs, _ref, h = fog
    cos = torch.as_tensor(h["u"][0] * 2 - 1)
    np.testing.assert_allclose(media.hg_p(cos, _t(h, "g")).numpy(),
                               np.asarray(ref_media.hg_p(jnp.asarray(cos.numpy()), _j(h, "g"))), rtol=1e-6)
    wi, pdf = media.hg_sample(_t(h, "d"), _t(h, "g"), _t(h, "u")[0], _t(h, "u")[1])
    wi_r, pdf_r = ref_media.hg_sample(_j(h, "d"), _j(h, "g"), jnp.asarray(h["u"][0]), jnp.asarray(h["u"][1]))
    np.testing.assert_allclose(wi.numpy(), np.asarray(wi_r), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(pdf_r), rtol=1e-5)
    # cos theta is measured from wo: for g > 0, wi continues along -wo
    fwd = (wi * _t(h, "d")).sum(-1)[torch.as_tensor(h["g"]) > 0.5]
    assert float(fwd.mean()) < -0.5


def test_grid_density_matches_reference(fog):
    cs, ref, h = fog
    pg = np.random.RandomState(2).uniform(-0.2, 1.2, (N, 3)).astype(np.float32)
    mine = medium_track.grid_density(cs.arrays.med_grids["med1"], torch.as_tensor(pg))
    theirs = ref_media._grid_density(ref.arrays.med_grids["med1"], jnp.asarray(pg))
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-7)
    assert float(mine.max()) > 0.1 and float(mine.min()) == 0.0  # zero outside the grid


def _corner_density(sa, m, pg):
    """csrc/medium_track.cu's lookup through medium m's corner rows
    (scene.arrays.grid_corners): the voxel's 32-byte row, zeros for a voxel
    outside the padded grid, then the same trilinear blend as the twin's."""
    off, nx, ny, nz = (int(v) for v in sa.med_grid_dims[m])
    rows = sa.med_grid_corners[off:off + (nx + 1) * (ny + 1) * (nz + 1)]
    g = [pg[:, a] * n - 0.5 for a, n in enumerate((nx, ny, nz))]
    i0 = [torch.floor(x).to(torch.int32) for x in g]
    f = [x - i for x, i in zip(g, i0)]
    x0, y0, z0 = i0
    inside = (x0 >= -1) & (x0 < nx) & (y0 >= -1) & (y0 < ny) & (z0 >= -1) & (z0 < nz)
    idx = (((z0 + 1) * (ny + 1) + (y0 + 1)) * (nx + 1) + (x0 + 1)).long().clamp(0, rows.shape[0] - 1)
    c = torch.where(inside[:, None], rows[idx], 0.0)
    fx, fy, fz = f
    d00 = c[:, 0] * (1 - fx) + c[:, 1] * fx
    d10 = c[:, 2] * (1 - fx) + c[:, 3] * fx
    d01 = c[:, 4] * (1 - fx) + c[:, 5] * fx
    d11 = c[:, 6] * (1 - fx) + c[:, 7] * fx
    return (d00 * (1 - fy) + d10 * fy) * (1 - fz) + (d01 * (1 - fy) + d11 * fy) * fz


def test_grid_corner_rows_hold_the_grid(fog):
    """The grid's corner table (scene.arrays.grid_corners, read by the
    tracking kernel): every voxel row of the grid padded by one voxel
    below holds the grid's eight taps, 0 outside the grid, and the lookup
    through it gives the twin's density bit for bit at points in and
    around the grid."""
    cs, _ref, _h = fog
    sa = cs.arrays
    m = cs.static.media_kinds.index("heterogeneous")
    grid = sa.med_grids[f"med{m}"].numpy()
    nz, ny, nx = grid.shape
    off, *dims = sa.med_grid_dims[m].tolist()
    assert dims == [nx, ny, nz] and sa.med_grid_dims[1 - m, 1] == 0  # the fog has no grid
    rows = sa.med_grid_corners.numpy()[off:off + (nx + 1) * (ny + 1) * (nz + 1)].reshape(nz + 1, ny + 1, nx + 1, 8)
    z0, y0, x0 = np.meshgrid(np.arange(-1, nz), np.arange(-1, ny), np.arange(-1, nx), indexing="ij")
    for c, (i, j, k) in enumerate((i, j, k) for k in (0, 1) for j in (0, 1) for i in (0, 1)):
        x, y, z = x0 + i, y0 + j, z0 + k
        inside = (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0) & (z < nz)
        want = np.where(inside, grid[np.clip(z, 0, nz - 1), np.clip(y, 0, ny - 1), np.clip(x, 0, nx - 1)], 0.0)
        np.testing.assert_array_equal(rows[..., c], want.astype(np.float32))
    pg = torch.as_tensor(np.random.RandomState(3).uniform(-0.3, 1.3, (N, 3)).astype(np.float32))
    flat = medium_track.grid_density(sa.med_grids[f"med{m}"], pg)
    assert torch.equal(_corner_density(sa, m, pg).view(torch.int32), flat.view(torch.int32))
    assert float(flat.max()) > 0.1 and float(flat.min()) == 0.0
    # the table costs 32 (nx + 1) (ny + 1) (nz + 1) bytes, counted in the scene's byte size
    assert sa.med_grid_corners.numel() * 4 == 32 * (nx + 1) * (ny + 1) * (nz + 1)
    assert scene_byte_size(sa) >= sa.med_grid_corners.numel() * 4 + grid.nbytes


def test_medium_sample_matches_reference(fog):
    cs, ref, h = fog
    args = (_t(h, "med"), _t(h, "o"), _t(h, "d"), _t(h, "t"), _t(h, "key"))
    args_r = (_j(h, "med", np.int32), _j(h, "o"), _j(h, "d"), _j(h, "t"), _j(h, "key", np.uint32))
    ms = media.medium_sample(cs.arrays, cs.static, *args)
    ms_r = ref_media.medium_sample(ref.arrays, ref.static, *args_r)
    np.testing.assert_array_equal(ms["hit_medium"].numpy(), np.asarray(ms_r["hit_medium"]))
    np.testing.assert_allclose(ms["t"].numpy(), np.asarray(ms_r["t"]), rtol=1e-5)
    np.testing.assert_allclose(ms["weight"].numpy(), np.asarray(ms_r["weight"]), rtol=1e-5)
    grid = torch.as_tensor(h["med"] == 1)
    hits = ms["hit_medium"]
    assert 0 < int(hits[grid].sum()) < int(grid.sum()) and 0 < int(hits[~grid].sum())


def test_tracking_twins_make_the_reference_decisions(fog):
    """The twins' per-ray collisions and steps: a delta-tracking ray that
    collides stops there, and so does a ratio-tracking ray at t_end or once
    its transmittance falls under 1e-4; the kernel's steps are the twins'."""
    cs, ref, h = fog
    grid = h["med"] == 1
    args = (_t(h, "med"), _t(h, "o"), _t(h, "d"), _t(h, "t"), _t(h, "key"))
    # medium_sample's lane key after the homogeneous branch's two draws
    key = rng.pcg_hash(rng.pcg_hash(rng.pcg_hash(args[-1])))
    t, found, steps = medium_track.delta_track_plain(cs.arrays, cs.static.media_kinds, *args[:-1], key)
    ms_r = ref_media.medium_sample(ref.arrays, ref.static, *(
        _j(h, "med", np.int32), _j(h, "o"), _j(h, "d"), _j(h, "t"), _j(h, "key", np.uint32)))
    assert np.array_equal(found.numpy()[grid], np.asarray(ms_r["hit_medium"])[grid])
    assert (steps.numpy()[~grid] == 0).all() and (steps.numpy()[grid] >= 1).all()
    assert int(steps.max()) <= medium_track.MAX_TRACKING_STEPS
    tr, r_steps = medium_track.ratio_track_plain(cs.arrays, cs.static.media_kinds, *args)
    assert (tr.numpy()[~grid] == 1.0).all() and float(tr[torch.as_tensor(grid)].min()) < 0.5


def test_medium_tr_matches_reference(fog):
    cs, ref, h = fog
    tr = media.medium_tr(cs.arrays, cs.static, _t(h, "med"), _t(h, "o"), _t(h, "d"), _t(h, "t"), _t(h, "key"))
    tr_r = ref_media.medium_tr(ref.arrays, ref.static, _j(h, "med", np.int32), _j(h, "o"), _j(h, "d"), _j(h, "t"),
                               _j(h, "key", np.uint32))
    np.testing.assert_allclose(tr.numpy(), np.asarray(tr_r), rtol=1e-5, atol=1e-7)


def test_transmittance_shadow_matches_reference(fog):
    """Shadow rays from the room toward the box and beyond (t_max up to 4):
    through the interface box's faces (8 queries), the fog's Beer-Lambert
    and the smoke's ratio tracking, in the room cut to its panel and the box
    (14 prims: the brute-force queries, whose reference runs quickly op by
    op); every fourth ray of the set."""
    _cs, _ref, h = fog
    desc = scenes.fog_room(8, 8)
    desc.primitives = desc.primitives[-2:]
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    assert cs.static.use_brute_force
    h = {k: v[..., ::4] if k == "u" else v[::4] for k, v in h.items()}
    med = np.where(h["med"] == 1, 1, cs.static.camera_medium)
    tr = media.transmittance_shadow(cs.arrays, cs.static, _t(h, "o"), _t(h, "d"), _t(h, "t") * 2,
                                    torch.as_tensor(med), _t(h, "key"), integrator._offset_ray, integrator.RAY_EPS)
    # jitted: op by op, each of its eight ratio-tracking loops would compile
    tr_r = jax.jit(lambda *a: ref_media.transmittance_shadow(ref.arrays, ref.static, *a))(
        _j(h, "o"), _j(h, "d"), _j(h, "t") * 2, jnp.asarray(med.astype(np.int32)), _j(h, "key", np.uint32))
    np.testing.assert_allclose(tr.numpy(), np.asarray(tr_r), rtol=1e-5, atol=1e-6)
    assert float(tr.min()) == 0.0 and 0.0 < float(tr.mean()) < 1.0
