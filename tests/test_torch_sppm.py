"""Stochastic progressive photon mapping in the port, against the reference.

On tests/test_sppm.py's open box (a matte floor and back wall, a point
light; 16 x 12, depth 3) with KMAX = 8 in both packages, as that test sets
it (a run's cap is then 8 x 16 = 128 entries):

- _cell_key on random voxel coordinates (negative ones too) and the sorted
  grid of one iteration's visible points: equal bit for bit (keys and
  the visible point of every entry);
- one iteration's camera pass: the visible points' validity and lobe kinds
  equal, their position, throughput, direction and frame within 2e-5
  (absolute), the direct light within 2e-5 (the reference's jitted program
  contracts multiply-adds);
- one iteration's photon pass (4,096 photons) on the reference's visible
  points and grid, at the test's radius 0.25 (every run under the cap) and
  at 1.5 with KMAX = 2 (cells of 3 units, runs past the cap of 32
  entries): the cap-dropped count
  equal, every visible point's photon count equal, phi within 1e-5 of its
  largest value (the port adds float64 pairs, the reference float32
  segment sums);
- the image of 4 iterations against the reference's render_sppm within
  1e-4 of its largest value, and render_compiled's route and work counts;
- the front end: python -m pbrt_tpu_torch renders a written sppm file,
  and its progressive writes land at the film's filename.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.device import camera as ref_camera
from pbrt_tpu.device import lights as ref_lights
from pbrt_tpu.device import sppm as ref_sppm
from pbrt_tpu.device.materials import make_bsdf as ref_make_bsdf
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch import main as cli
from pbrt_tpu_torch import render, scenes
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.device import bdpt, camera, lights, sppm
from pbrt_tpu_torch.scene.builder import compile_scene
from pbrt_tpu_torch.scene.host import (
    CameraConfig, FilmConfig, HostLight, HostMaterial, HostPrimitive, IntegratorConfig, SamplerConfig,
    SceneDescription, ShapeRecord, Sphere, TriangleMesh,
)
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

SEED = 2
N_PHOTONS = 4096


def _quad(p0, p1, p2, p3, kd):
    mesh = TriangleMesh(p=np.array([p0, p1, p2, p3], np.float64), indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    return HostPrimitive(shape=ShapeRecord(mesh=mesh),
                         material=HostMaterial(kind="matte", params={"Kd": ("const", np.array([kd] * 3))}))


def _box(integrator):
    """tests/test_sppm.py _box_scene in the port's records."""
    prims = [_quad([-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2], 0.7),
             _quad([-2, 0, -2], [-2, 3, -2], [2, 3, -2], [2, 0, -2], 0.6)]
    return SceneDescription(
        primitives=prims,
        lights=[HostLight(kind="point", from_point=np.array([0.0, 2.0, 1.0]), to_point=np.zeros(3),
                          intensity=np.array([4.0, 4.0, 4.0]), light_to_world=Transform.translate([0.0, 2.0, 1.0]))],
        camera=CameraConfig(kind="perspective", camera_to_world=Transform.look_at([0, 1.5, 5], [0, 1.0, 0], [0, 1, 0]),
                            fov=45.0),
        film=FilmConfig(x_resolution=16, y_resolution=12), sampler=SamplerConfig(kind="zerotwosequence",
                                                                                  pixel_samples=64),
        integrator=integrator)


def _floor_lamp(integrator):
    """tests/test_bdpt.py _scene (a matte floor under a sphere area light,
    12 x 9) in the port's records."""
    floor = _quad([-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3], 0.5)
    floor.material = HostMaterial(kind="matte", params={"Kd": ("const", np.array([0.65, 0.5, 0.4]))})
    lamp = HostPrimitive(
        shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([0.8, 1.5, 0.0]), radius=0.2)),
        material=HostMaterial(kind="matte", params={"Kd": ("const", np.zeros(3))}),
        area_light=HostLight(kind="area", intensity=np.array([8.0, 8.0, 8.0]), two_sided=False))
    return SceneDescription(
        primitives=[floor, lamp], lights=[],
        camera=CameraConfig(kind="perspective", camera_to_world=Transform.look_at([0, 2, 4], [0, 0.5, 0], [0, 1, 0]),
                            fov=45.0),
        film=FilmConfig(x_resolution=12, y_resolution=9), sampler=SamplerConfig(kind="zerotwosequence",
                                                                                 pixel_samples=16),
        integrator=integrator)


def _sppm_config(radius=0.25, iterations=4):
    return IntegratorConfig(kind="sppm", max_depth=3, num_iterations=iterations, photons_per_iteration=N_PHOTONS,
                            initial_radius=radius)


@pytest.fixture(autouse=True)
def kmax_8(monkeypatch):
    monkeypatch.setattr(sppm, "KMAX", 8)
    monkeypatch.setattr(ref_sppm, "KMAX", 8)


def test_cell_key_matches_reference():
    rs = np.random.RandomState(3)
    ix, iy, iz = rs.randint(-3000, 3000, (3, 4096))
    mine = sppm._cell_key(*(torch.as_tensor(x) for x in (ix, iy, iz))).numpy()
    theirs = np.asarray(ref_sppm._cell_key(*(jnp.asarray(x.astype(np.int32)) for x in (ix, iy, iz))))
    np.testing.assert_array_equal(mine, theirs.astype(np.int64))
    assert mine.max() < sppm.KEY_SENTINEL == int(ref_sppm.KEY_SENTINEL)


@pytest.fixture(scope="module")
def camera_pass():
    """One iteration's camera pass of the box (iteration 1 of 4) in both
    packages, and what the photon passes share."""
    desc = _box(_sppm_config())
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    W, H = desc.film.x_resolution, desc.film.y_resolution
    R = W * H
    ys, xs = np.mgrid[0:H, 0:W]
    px, py, pid = xs.ravel(), ys.ravel(), (ys * W + xs).ravel()
    ctx = bdpt._Ctx(cs.arrays, cs.static)
    cam = camera.make_camera(desc.camera, desc.film, "cpu")
    ld, vp = sppm._camera_pass(cs.arrays, cs.static, ctx, cam, 3, SEED, *(torch.as_tensor(x) for x in (px, py, pid)),
                               1, 4)
    cam_r = ref_camera.make_camera(ref.description.camera, ref.description.film)
    ld_r, vp_r = jax.jit(lambda it, s: ref_sppm._camera_pass(
        ref.arrays, ref.static, {"max_depth": 3}, {"kind": "zerotwosequence", "spp": 4}, cam_r, s,
        jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)), jnp.asarray(pid.astype(np.uint32)),
        it))(jnp.uint32(1), jnp.uint32(SEED))
    return dict(cs=cs, ref=ref, ctx=ctx, R=R, mine=(ld, vp), theirs=(ld_r, {k: np.asarray(v) for k, v in vp_r.items()}))


def test_camera_pass_matches_reference(camera_pass):
    ld, vp = camera_pass["mine"]
    ld_r, vp_r = camera_pass["theirs"]
    slots = camera_pass["ctx"].table["slots"]
    np.testing.assert_array_equal(vp["valid"].numpy(), vp_r["valid"])
    assert 0.3 < vp_r["valid"].mean() < 1.0
    np.testing.assert_array_equal(vp["kind"].numpy(), vp_r["kind"][:, slots])
    for key in ("p", "beta", "wo", "ns", "ss", "ts", "ng"):
        np.testing.assert_allclose(vp[key].numpy(), vp_r[key], rtol=0, atol=2e-5, err_msg=key)
    np.testing.assert_allclose(vp["data"].numpy(), vp_r["data"][:, slots], rtol=0, atol=2e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_r), rtol=0, atol=2e-5)
    assert np.asarray(ld_r).mean() > 0.01


def _vp_port(camera_pass):
    """The reference's visible points as the port's tensors (its lobe slots)."""
    slots = camera_pass["ctx"].table["slots"]
    out = {k: torch.as_tensor(np.array(v)) for k, v in camera_pass["theirs"][1].items()}
    out["kind"] = out["kind"][:, slots].to(torch.int64)
    out["data"] = out["data"][:, slots]
    return out


def _grids(camera_pass, radius):
    cs, ref = camera_pass["cs"], camera_pass["ref"]
    vp_r = camera_pass["theirs"][1]
    R = camera_pass["R"]
    r = np.full(R, radius, np.float32)
    max_r = float(np.max(np.where(vp_r["valid"], r, 0.0)))
    wr = float(ref.arrays.world_radius)
    inv_cell = float(np.float32(1.0 / max(2.0 * max_r, 2.0 * wr / 1022.0, 1e-6)))
    grid_min = cs.arrays.world_center - cs.arrays.world_radius
    mine = sppm._build_grid(_vp_port(camera_pass), torch.as_tensor(r), grid_min, inv_cell)
    grid_min_r = jnp.asarray(np.asarray(ref.arrays.world_center) - wr, jnp.float32)
    theirs = jax.jit(lambda vp, rad, ic: ref_sppm._build_grid(vp, rad, grid_min_r, ic, 1 << 10))(
        {k: jnp.asarray(v) for k, v in vp_r.items()}, jnp.asarray(r), jnp.float32(inv_cell))
    return r, grid_min, grid_min_r, inv_cell, mine, theirs


@pytest.mark.parametrize("radius", [0.25, 1.5])
def test_grid_matches_reference(camera_pass, radius):
    _r, _g, _gr, _ic, (cells, vps), (cells_r, vps_r) = _grids(camera_pass, radius)
    np.testing.assert_array_equal(cells.numpy(), np.asarray(cells_r).astype(np.int64))
    np.testing.assert_array_equal(vps.numpy(), np.asarray(vps_r))
    assert (cells.numpy() < sppm.KEY_SENTINEL).sum() > camera_pass["theirs"][1]["valid"].sum()


@pytest.mark.parametrize("radius,kmax", [(0.25, 8), (1.5, 2)])
def test_photon_pass_matches_reference(camera_pass, radius, kmax, monkeypatch):
    monkeypatch.setattr(sppm, "KMAX", kmax)
    monkeypatch.setattr(ref_sppm, "KMAX", kmax)
    cs, ref, R = camera_pass["cs"], camera_pass["ref"], camera_pass["R"]
    r, grid_min, grid_min_r, inv_cell, (cells, vps), (cells_r, vps_r) = _grids(camera_pass, radius)
    seed_it = SEED + 1 * 9781
    phi = torch.zeros((R + 1, 3), dtype=torch.float64)
    m_cnt = torch.zeros(R + 1, dtype=torch.float64)
    stats = {k: torch.zeros((), dtype=torch.int64) for k in ("dropped", "max_run")}
    stats["pairs"] = 0
    cdf = torch.cumsum(lights.compute_power(cs.arrays, cs.static), 0)
    cdf = cdf / cdf[-1]
    sppm._photon_pass(cs.arrays, cs.static, camera_pass["ctx"], 3, seed_it, 1, 0, N_PHOTONS, cdf,
                      _vp_port(camera_pass), torch.as_tensor(r), cells, vps, grid_min, inv_cell, phi, m_cnt, stats,
                      sppm._Split(torch.device("cpu")))
    cdf_r = jnp.cumsum(ref_lights.compute_power(ref.arrays, ref.static))
    cdf_r = cdf_r / cdf_r[-1]
    possible = ref_make_bsdf(ref.arrays, ref.static, jnp.zeros(1, jnp.int32), jnp.zeros((1, 2), jnp.float32),
                             jnp.zeros((1, 3), jnp.float32))["possible"]
    phi_r, m_r, over_r = jax.jit(lambda vp, rad, sc, sv, ic: ref_sppm._photon_pass(
        ref.arrays, ref.static, {"max_depth": 3}, jnp.uint32(seed_it), jnp.uint32(1), N_PHOTONS, cdf_r, vp, rad, sc,
        sv, grid_min_r, ic, 1 << 10, possible, pid0=0))(
        {k: jnp.asarray(v) for k, v in camera_pass["theirs"][1].items()}, jnp.asarray(r), cells_r, vps_r,
        jnp.float32(inv_cell))
    dropped = int(stats["dropped"])
    assert dropped == int(over_r)
    if radius > 1.0:
        assert dropped > 0 and int(stats["max_run"]) > sppm.KMAX * sppm.N_CHUNKS
    else:
        assert dropped == 0
    np.testing.assert_array_equal(m_cnt[:R].numpy(), np.asarray(m_r, np.float64))
    phi_r = np.asarray(phi_r, np.float64)
    assert phi_r.max() > 0 and stats["pairs"] > 100
    np.testing.assert_allclose(phi[:R].numpy(), phi_r, rtol=0, atol=1e-5 * phi_r.max())


def test_render_sppm_matches_reference():
    desc = _box(_sppm_config())
    cs = compile_scene(desc, "cpu")
    img = render.render_compiled(cs, seed=SEED)
    tm = render.render_compiled.last_timing
    img_r = ref_sppm.render_sppm(ref_compile_scene(_to_ref(desc)), seed=SEED)
    assert tm["tier"] == "torch-sppm/brute"
    assert tm["photons"] == 4 * N_PHOTONS and tm["iterations"] == 4
    assert 0 < tm["visible_points"] <= 4 * 16 * 12 and tm["dropped"] == 0
    assert set(tm["split"]) >= {"camera", "grid", "photon_trace", "deposit"}
    assert np.isfinite(img).all() and img.mean() > 0.01
    np.testing.assert_allclose(img, img_r, rtol=0, atol=1e-4 * img_r.max())


def test_cli_renders_sppm(tmp_path):
    """python -m pbrt_tpu_torch on a written sppm file; with
    imagewritefrequency 1 the progressive image goes to the film's
    filename after the first of two iterations."""
    desc = _box(IntegratorConfig(kind="sppm", max_depth=2, num_iterations=2, photons_per_iteration=1024,
                                 initial_radius=0.25))
    path = str(tmp_path / "sppm.pbrt")
    scenes.write_pbrt(desc, path, ([0, 1.5, 5], [0, 1.0, 0], [0, 1, 0]))
    assert cli.main([path, "--device", "cpu", "--quiet", "-o", str(tmp_path / "s.pfm")]) == 0
    assert cli.main.last_run["timing"]["tier"] == "torch-sppm/brute"
    desc.integrator.write_frequency = 1
    desc.film.filename = str(tmp_path / "progress.pfm")
    render.render_compiled(compile_scene(desc, "cpu"), seed=SEED)
    assert (tmp_path / "progress.pfm").exists()


def render_small(desc, kind):
    """desc rendered by the port under integrator `kind` (mlt or sppm) at a
    small size (a 6 x 4 film, depth 1, little work): (the image, its
    route)."""
    desc.integrator = dataclasses.replace(desc.integrator, kind=kind, max_depth=1, n_bootstrap=512, n_chains=8,
                                          mutations_per_pixel=2, num_iterations=1, photons_per_iteration=256)
    desc.film = dataclasses.replace(desc.film, x_resolution=6, y_resolution=4, crop_window=(0.0, 1.0, 0.0, 1.0))
    img = render.render_compiled(compile_scene(desc, "cpu"), seed=SEED)
    return img, render.render_compiled.last_timing["tier"]
