"""The whole ported slice against the reference: the persistent wavefront
at 24x16, 4 spp, seed 3, on the 770-prim mesh room, on area_box and the
spheres gallery (brute force), on material_room(8) under path and
directlighting ("all" and "one"), on the mesh room under the 'spatial'
light distribution, on area_box with a declared 2x2 stratified sampler
without jitter, on scenes.sky_meshes under its constant sky and under an
image-mapped one (escaped rays pick up the environment with the deferred
MIS weight; NEE samples the sphere or the map's distribution), on a mixed
scene (84 triangles beside four full spheres, a sphere lamp and a glossy
uber sphere among them) under 'power' and 'spatial' selection, and on a
brute scene of sphere lamps, full and partial (the brute wavefront).

The reference runs its own make_persistent_fn on the CPU (its default CPU
route for wide scenes is the XLA packet traversal, which
tests/test_widebvh.py holds equal to the Pallas kernel; for brute scenes
the XLA brute wavefront, with PBRT_TPU_NO_MEGAKERNEL=1 where its brute
megakernel would take the scene); the port runs its plain-PyTorch route.
The sample streams are identical, so for matte scenes accL/accW agree
within tests/test_persistent.py's tier tolerance (rtol 2e-4, atol 2e-4) and
the path-vertex counts within 1e-3; where specular or glass lobes are
present, within the reference megakernel test's (tests/test_megakernel.py):
weights allclose, path vertices within 4, per-pixel |dL| / (|L| + 1e-2) <
2e-2 and mean |dL| < 1e-4.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pbrt_tpu import render as ref_render
from pbrt_tpu.device import sampler as ref_sampler
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch import render
from pbrt_tpu_torch.scene.builder import CompiledScene, compile_scene
from pbrt_tpu_torch.core.imageio import read_image, write_image
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.scenes import area_box, material_room, mesh_room, sky_meshes, spheres_gallery
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

W, H, SPP, SEED = 24, 16, 4, 3


def _small(desc):
    desc.film.x_resolution, desc.film.y_resolution = W, H
    desc.sampler.pixel_samples = SPP
    return desc


@pytest.fixture(scope="module")
def port_scene():
    return compile_scene(_small(mesh_room(8)), "cpu")


def _pixels():
    ys, xs = np.mgrid[0:H, 0:W]
    return xs.ravel(), ys.ravel(), (ys * W + xs).ravel()


def _reference_wave(ref):
    px, py, pids = _pixels()
    wave_r = ref_render.make_persistent_fn(ref)
    assert ref_render.LAST_PERSISTENT_TIER.startswith("xla-wavefront")
    return ref_render.LAST_PERSISTENT_TIER, tuple(np.asarray(x) for x in wave_r(
        ref.arrays, jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)),
        jnp.asarray(pids.astype(np.uint32)), jnp.uint32(0), SPP, jnp.uint32(SEED)))


def _port_wave(cs):
    wave = render.make_persistent_fn(cs)
    t = [torch.as_tensor(x.astype(np.int64)) for x in _pixels()]
    return render.LAST_PERSISTENT_TIER, tuple(x.numpy() for x in wave(cs.arrays, *t, 0, SPP, SEED))


def _assert_tier_tolerance(L, w, nv, L_r, w_r, nv_r):
    """tests/test_persistent.py's tier tolerance (matte scenes)."""
    assert L_r.mean() > 0.1
    np.testing.assert_allclose(w, w_r, atol=1e-5)
    assert abs(float(nv.sum()) - float(nv_r.sum())) < 1e-3
    np.testing.assert_allclose(L, L_r, rtol=2e-4, atol=2e-4)


# Russian roulette's survivor boost at its smallest kill probability, 0.05
RR_BOOST = 1.0 / (1.0 - 0.05)


def _assert_specular_tolerance(L, w, nv, L_r, w_r, nv_r, rr_pixels=0):
    """tests/test_megakernel.py's tolerance (specular and glass lobes).

    rr_pixels: pixels allowed outside it, each by at most one sample's
    Russian-roulette boost. A path through the glass sphere carries a
    throughput x eta scale of 1 in exact arithmetic (kt = 1), which lands an
    ulp either side of the roulette threshold (1) in the two packages (XLA
    contracts the products into FMAs, PyTorch rounds each): one plays
    roulette where the other does not, and that sample's radiance differs
    by the factor RR_BOOST. Radiance is non-negative, so the pixel's
    difference is then at most (RR_BOOST - 1) of its sum; the mean is taken
    over the other pixels."""
    assert L_r.mean() > 1e-3
    assert np.allclose(w, w_r)
    assert abs(float(nv.sum()) - float(nv_r.sum())) <= 4
    diff = np.abs(L - L_r)
    out = (diff / (np.abs(L_r) + 1e-2)).max(-1) >= 2e-2
    assert out.sum() <= rr_pixels, float(diff.max())
    assert (diff[out] <= (RR_BOOST - 1.0) * np.maximum(L, L_r)[out] * (1 + 1e-6)).all()
    assert float(diff[~out].mean()) < 1e-4


def test_persistent_matches_reference(port_scene):
    _tier_r, ref_out = _reference_wave(ref_compile_scene(_small(bench._mesh_scene(8))))
    tier, out = _port_wave(port_scene)
    assert tier == "torch-wavefront/plain-wide"
    _assert_tier_tolerance(*out, *ref_out)


def _spatial_room():
    desc = mesh_room(8)
    desc.integrator.light_strategy = "spatial"
    return desc


def _directlighting(strategy):
    def make():
        desc = material_room(8)
        desc.integrator.kind = "directlighting"
        desc.integrator.strategy = strategy
        return desc
    return make


def _stratified_box():
    desc = area_box()
    desc.sampler = dataclasses.replace(desc.sampler, kind="stratified", x_samples=2, y_samples=2, jitter=False)
    return desc


def _textured(_tmp_path):
    """textured_room cut to 8 x 8 floor cells and small images, depth 3: the
    floor's EWA and the back wall's trilinear imagemap under ray
    differentials, the checkerboard, a mix and a scale, the left wall's
    bump map. Its noise textures (fbm, marble) are replaced by a constant
    mix amount and a uv texture: the reference's XLA compile of them costs
    about a minute on a CPU; tests/test_torch_texture.py holds them."""
    from pbrt_tpu_torch.scenes import _const, _texture, textured_room

    desc = textured_room(8, 48, 24, 32)
    desc.integrator.max_depth = 3
    left, right = desc.primitives[3], desc.primitives[4]
    left.material.params["Kd"][1].amount = ("const", 0.3)
    right.material.params["Kd"][1].tex1 = ("texture", _texture("uv", uscale=3.0, vscale=2.0))
    return desc


def _sky(tmp_path, image=False):
    """sky_meshes cut to 600 triangles (halton, the gaussian filter, smooth
    UV-mapped spheres, a constant infinite light and a distant sun); with
    image, its sky an 8x16 latitude-longitude map written under tmp_path
    and read back, rotated by its light-to-world."""
    desc = sky_meshes(10, 6, 10)
    if image:
        rs = np.random.RandomState(12)
        path = str(tmp_path / "sky.pfm")
        write_image(path, rs.uniform(0.0, 2.0, (8, 16, 3)).astype(np.float32))
        desc.lights[0] = dataclasses.replace(desc.lights[0], image=read_image(path), map_name=path,
                                             light_to_world=Transform.rotate(-30.0, [0.2, 1.0, 0.1]))
    return desc


# name: (port scene of tmp_path, reference scene or None for _to_ref of it,
# the port's route, matte-only; the sky scenes' glass sphere may put one
# pixel on the roulette threshold, _assert_specular_tolerance)
SLICE = {
    "area_box": (lambda _t: area_box(), None, "brute", False),
    "gallery-no-megakernel": (lambda _t: spheres_gallery(), None, "brute", False),
    "material_room": (lambda _t: material_room(8), None, "wide", False),
    "mesh_room-spatial": (lambda _t: _spatial_room(), lambda: _spatial_room_ref(), "wide", True),
    "directlighting-all": (lambda _t: _directlighting("all")(), None, "wide", False),
    "directlighting-one": (lambda _t: _directlighting("one")(), None, "wide", False),
    "area_box-stratified-2x2-no-jitter": (lambda _t: _stratified_box(), None, "brute", False),
    "sky_meshes": (_sky, None, "wide", False),
    "sky_meshes-image-map": (lambda t: _sky(t, image=True), None, "wide", False),
    "textured_room": (_textured, None, "wide", False),
    "mixed-power": (lambda _t: _mixed_small("power"), None, "wide-mixed", False),
    "mixed-spatial": (lambda _t: _mixed_small("spatial"), None, "wide-mixed", False),
    "brute-sphere-lamps": (lambda _t: _brute_lamps(), None, "brute", False),
}


def _brute_lamps():
    """A brute scene of matte spheres under sphere lamps: a floor and a back
    wall (4 triangles), two matte spheres, a full lamp (sampled by its
    visible cone) and a partial one (zmax clipped: sampled over its area,
    as the reference samples a partial sphere) beside a point light, under
    'spatial' selection."""
    from pbrt_tpu_torch.scene.host import HostLight, HostMaterial, HostPrimitive, ShapeRecord, Sphere
    from pbrt_tpu_torch.scenes import _const, _quad

    matte = HostMaterial(kind="matte", params={"Kd": _const([0.6, 0.55, 0.5])})
    black = HostMaterial(kind="matte", params={"Kd": _const([0.0, 0.0, 0.0])})

    def sphere(center, radius, material, emit=None, z_max=None):
        light = None if emit is None else HostLight(kind="area", intensity=np.asarray(emit, np.float64))
        return HostPrimitive(shape=ShapeRecord(sphere=Sphere(
            object_to_world=Transform.translate(center), radius=radius, z_min=-radius,
            z_max=radius if z_max is None else z_max)), material=material, area_light=light)

    desc = area_box()
    desc.primitives = [
        _quad([-3.0, 0.0, 2.0], [3.0, 0.0, 2.0], [3.0, 0.0, -3.0], [-3.0, 0.0, -3.0], matte),
        _quad([-3.0, 0.0, -3.0], [3.0, 0.0, -3.0], [3.0, 3.0, -3.0], [-3.0, 3.0, -3.0], matte),
        sphere([-1.2, 0.7, -1.2], 0.7, matte), sphere([1.2, 0.6, -0.8], 0.6, matte),
        sphere([0.0, 2.2, -1.0], 0.35, black, emit=[9.0, 8.0, 7.0]),
        sphere([1.8, 1.8, -2.0], 0.3, black, emit=[4.0, 5.0, 6.0], z_max=0.1),
    ]
    return desc


def _mixed_small(strategy):
    """A mixed scene from just over 64 triangles (a 6 x 6 terrain, five
    two-triangle walls, the two-triangle panel light: 84) beside four full
    spheres (two matte, a glossy uber one, and a sphere lamp) and a point
    light, under `strategy` (each lobe kind more costs the reference's XLA
    compile seconds; the wide megakernel's tests hold glass spheres); the reference walks it through its packet
    loop over the binary BVH, the port the triangle subset's wide tables
    beside the spheres' tests."""
    from pbrt_tpu_torch.scene.host import HostLight, HostMaterial, HostPrimitive, ShapeRecord, Sphere
    from pbrt_tpu_torch.scenes import ROOM_LOOK_AT, _const, _grid_mesh, _prim

    desc = mesh_room(1)
    terrain = _prim(*_grid_mesh(lambda x, z: (x, 0.6 * np.sin(1.7 * x) * np.cos(1.3 * z), z), -4, 4, -4, 4, 6),
                    [0.55, 0.45, 0.35])
    y0, y1 = -1.3, 4.0
    walls = [_prim(*_grid_mesh(f, -4, 4, lo, hi, 1), kd) for f, lo, hi, kd in (
        (lambda u, v: (u, v, np.full_like(u, -4.0)), y0, y1, [0.6, 0.6, 0.6]),
        (lambda u, v: (u, v, np.full_like(u, 4.0)), y0, y1, [0.6, 0.6, 0.6]),
        (lambda u, v: (np.full_like(u, -4.0), v, u), y0, y1, [0.55, 0.3, 0.3]),
        (lambda u, v: (np.full_like(u, 4.0), v, u), y0, y1, [0.3, 0.55, 0.3]),
        (lambda u, v: (u, np.full_like(u, y1), v), -4, 4, [0.7, 0.7, 0.7]))]

    def sphere(center, radius, material, light=None):
        return HostPrimitive(shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate(center), radius=radius,
                                                             z_min=-radius, z_max=radius)),
                             material=material, area_light=light)

    spheres = [
        sphere([-1.5, 1.2, -1.0], 0.7, HostMaterial(kind="matte", params={"Kd": _const([0.6, 0.6, 0.5])})),
        sphere([1.3, 1.0, -0.5], 0.6, HostMaterial(kind="uber", params={
            "Kd": _const([0.5, 0.3, 0.2]), "Ks": _const([0.3, 0.3, 0.3]), "roughness": ("const", 0.15)})),
        sphere([0.0, 2.0, -2.0], 0.5, HostMaterial(kind="matte", params={"Kd": _const([0.4, 0.5, 0.6])})),
        sphere([0.6, 2.8, 0.6], 0.3, HostMaterial(kind="matte", params={"Kd": _const([0.0, 0.0, 0.0])}),
               HostLight(kind="area", intensity=np.array([12.0, 10.0, 8.0]))),
    ]
    desc.primitives = [terrain] + walls + desc.primitives[-1:] + spheres
    desc.lights = [HostLight(kind="point", from_point=np.array([-2.0, 2.5, 1.0]), intensity=np.array([5.0, 5.0, 5.0]))]
    desc.camera.camera_to_world = Transform.look_at(*ROOM_LOOK_AT)
    desc.integrator.light_strategy = strategy
    return desc


def _spatial_room_ref():
    desc = bench._mesh_scene(8)
    desc.integrator.light_strategy = "spatial"
    return desc


@pytest.mark.parametrize("case", list(SLICE))
def test_wavefront_matches_reference(case, monkeypatch, tmp_path):
    """make_persistent_fn of the port against the reference's persistent
    tier on every class the slices add to the wavefront."""
    make, make_ref, shape, matte = SLICE[case]
    monkeypatch.delenv("PBRT_TPU_WIDEMEGA", raising=False)
    if shape == "brute":  # both packages skip their brute megakernels
        monkeypatch.setenv("PBRT_TPU_NO_MEGAKERNEL", "1")
    desc = _small(make(tmp_path))
    ref_desc = _small(make_ref()) if make_ref is not None else _to_ref(desc)
    if desc.sampler.kind == "stratified":  # render_compiled's registration in the reference
        monkeypatch.setattr(ref_sampler, "_STRATIFIED_SHAPE", (desc.sampler.x_samples, desc.sampler.y_samples))
        monkeypatch.setattr(ref_sampler, "_STRATIFIED_JITTER", desc.sampler.jitter)
    tier_r, ref_out = _reference_wave(ref_compile_scene(ref_desc))
    assert tier_r.endswith("brute") == (shape == "brute")
    if shape == "wide-mixed":  # more than 64 triangles beside the spheres
        assert 64 < compile_scene(desc, "cpu").static.n_tris < 100
    tier, out = _port_wave(compile_scene(desc, "cpu"))
    assert tier == f"torch-wavefront/plain-{shape}"
    if matte:
        _assert_tier_tolerance(*out, *ref_out)
    else:
        _assert_specular_tolerance(*out, *ref_out, rr_pixels=int(case.startswith("sky")))


def test_render_compiled_crop_and_scale(port_scene):
    """A pixelbounds crop renders exactly the full render's pixels there, and
    film scale multiplies the image."""
    full = render.render_compiled(port_scene, seed=SEED)
    assert full.shape == (H, W, 3) and np.isfinite(full).all() and full.mean() > 0
    timing = render.render_compiled.last_timing
    assert timing["tier"] == "torch-wavefront/plain-wide" and timing["n_vertices"] > W * H * SPP

    desc = port_scene.description
    crop = dataclasses.replace(desc, integrator=dataclasses.replace(desc.integrator, pixel_bounds=(5, 17, 3, 11)),
                               film=dataclasses.replace(desc.film, scale=2.0))
    img = render.render_compiled(CompiledScene(port_scene.arrays, port_scene.static, crop), seed=SEED)
    np.testing.assert_allclose(img[3:11, 5:17], 2.0 * full[3:11, 5:17], rtol=1e-6, atol=1e-7)
    assert not img[:3].any() and not img[:, 17:].any()


def test_integrator_helpers_match_reference():
    """Ray-origin offsetting (one-ulp bump past the error bound) and the MIS
    power heuristic, on numpy inputs from a seed."""
    from pbrt_tpu.device import integrator as ref_integrator
    from pbrt_tpu_torch.device import integrator

    rs = np.random.RandomState(2)
    n = 512
    p = (rs.normal(size=(n, 3)) * 3).astype(np.float32)
    p[:16] = 0.0  # zero components step to the smallest normal
    ng = rs.normal(size=(n, 3)).astype(np.float32)
    ng /= np.linalg.norm(ng, axis=1, keepdims=True)
    w = rs.normal(size=(n, 3)).astype(np.float32)
    p_err = (np.abs(rs.normal(size=(n, 3))) * 1e-6).astype(np.float32)
    got = integrator._offset_ray(*(torch.as_tensor(x) for x in (p, ng, w, p_err))).numpy()
    ref = np.asarray(ref_integrator._offset_ray(*(jnp.asarray(x) for x in (p, ng, w, p_err))))
    np.testing.assert_array_max_ulp(got, ref, maxulp=2)
    assert (got != p).all()

    a = rs.uniform(0, 5, n).astype(np.float32)
    b = rs.uniform(0, 5, n).astype(np.float32)
    a[:8] = 0.0
    np.testing.assert_allclose(
        integrator.power_heuristic(1.0, torch.as_tensor(a), 1.0, torch.as_tensor(b)).numpy(),
        np.asarray(ref_integrator.power_heuristic(1.0, jnp.asarray(a), 1.0, jnp.asarray(b))),
        rtol=1e-6, atol=0)


@pytest.mark.parametrize("widemega", [None, "1"])
def test_spatial_light_strategy_refused_when_the_route_is_built(monkeypatch, widemega):
    """pbrt's default light strategy, 'spatial', over the room's two panel
    lights: the route builds the spatial distribution and the wavefront
    renders it; under PBRT_TPU_WIDEMEGA=1 the wide megakernel refuses
    'spatial' and the wavefront takes the scene all the same. With one light
    the strategy is the uniform selector, and the wavefront (or the wide
    megakernel) renders it."""
    if widemega is None:
        monkeypatch.delenv("PBRT_TPU_WIDEMEGA", raising=False)
    else:
        monkeypatch.setenv("PBRT_TPU_WIDEMEGA", widemega)
    desc = _small(mesh_room(8))
    desc.integrator.light_strategy = "spatial"
    cs = compile_scene(desc, "cpu")
    assert cs.static.n_lights == 2 and not desc.lights  # both lights ride the panel's triangles
    px, py, pids = (torch.as_tensor(x[:8].astype(np.int64)) for x in _pixels())
    wave = render.make_persistent_fn(cs)
    assert render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-wide"
    L, w, _nv = wave(cs.arrays, px, py, pids, 0, 1, SEED)
    assert torch.isfinite(L).all() and torch.equal(w, torch.ones(8)) and float(L.sum()) > 0

    panel = desc.primitives[-1].shape.mesh
    panel.indices = panel.indices[:1]  # one emitting triangle: one light
    one = compile_scene(desc, "cpu")
    assert one.static.n_lights == 1
    wave = render.make_persistent_fn(one)
    assert render.LAST_PERSISTENT_TIER == ("torch-megakernel/plain-wide" if widemega else "torch-wavefront/plain-wide")
    L, w, _nv = wave(one.arrays, px, py, pids, 0, 1, SEED)
    assert torch.isfinite(L).all() and torch.equal(w, torch.ones(8))
