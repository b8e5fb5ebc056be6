"""Bidirectional path tracing, the importance transport mode and the
camera and light endpoints in the port, against the reference.

- importance mode: bsdf_f, bsdf_pdf and bsdf_sample with mode
  "importance" against the reference's on every material row of the
  gallery of lobe variants (rough, transmit-only and specular glass,
  Beckmann plastic and metal, anisotropic rough glass), of the uber
  gallery and of area_box, 8,192 lanes over the rows, at test_torch_bsdf.py's
  tolerances (bsdf_f's absolute one scaled by eta^2 = 2.25, the factor
  importance transport leaves on a transmission; the sampled directions
  held as the samples' f and pdf); the Fourier lobe's fourier_f and
  fourier_sample in both modes at test_torch_materials.py's; radiance mode stays the default and
  bit-identical to the calls without a mode, and importance mode differs
  on the transmissions only; correct_shading_normal within 1e-6;
- the endpoints: camera_we, camera_pdf_we and camera_sample_wi of the mesh
  room's camera against the reference's on 2,048 points and directions
  (within 1e-5 relative; the raster positions within 2e-4 pixels);
  sample_le over every light kind the port takes (point, spot and distant:
  the gallery; two-sided triangle area lights, quadric area lights,
  goniometric and projection lights: the quadric room; an image-mapped
  infinite light: the sky) within 2e-5 relative, 1e-5 absolute (the
  reference's compiled program contracts multiply-adds); area_light_pdf_dir within 1e-6;
- BDPT on a scene with a sphere area light, a point light, a glass sphere
  and a matte floor, 8 x 6, depth 3: bdpt_wave's contribution and MIS
  weight of every (s, t) strategy per lane, and every t = 1 splat's pixel
  and value, against the reference's (collect_debug) within 2e-5
  absolute; then render_bdpt at 2 spp against the reference's host loop
  over the same two waves (L at its pixel, the splats wherever they land):
  within 1e-5. The reference's bdpt_wave runs op by op here: compiling
  every strategy of it at once costs a minute of this CPU;
- render_compiled sends a bdpt scene to render_bdpt (tier "torch-bdpt/"
  + the query's route), and the CLI renders it;
- the reference's debug-film fault, reproduced: visualizestrategies
  writes its films into the working directory (ROADMAP C).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.device import bdpt as ref_bdpt
from pbrt_tpu.device import bsdf as ref_bsdf
from pbrt_tpu.device import camera as ref_camera
from pbrt_tpu.device import fourier as ref_fourier
from pbrt_tpu.device import lights as ref_lights
from pbrt_tpu.device.materials import make_bsdf as ref_make_bsdf
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch import main as cli
from pbrt_tpu_torch import render, scenes
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.device import bdpt, bsdf, camera, fourier, lights
from pbrt_tpu_torch.device.materials import lobe_table, make_bsdf
from pbrt_tpu_torch.scene.builder import compile_scene
from pbrt_tpu_torch.scene.host import (
    CameraConfig, FilmConfig, HostLight, HostMaterial, HostPrimitive, IntegratorConfig, SamplerConfig,
    SceneDescription, ShapeRecord, Sphere, TriangleMesh,
)
from test_torch_bsdf import _close, _close_but_few, _ubers, _variants
from test_torch_lights import _sky
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

N = 2048

# ---------------------------------------------------------------------------
# the importance transport mode
# ---------------------------------------------------------------------------

LOBE_SCENES = {"variants": _variants, "uber": _ubers, "area_box": scenes.area_box}


@pytest.mark.parametrize("scene", list(LOBE_SCENES))
def test_importance_mode_matches_reference(scene):
    desc = LOBE_SCENES[scene]()
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    rs = np.random.RandomState(17)
    n = 4 * N  # every scene the same lane count: the reference's compiled ops serve all three
    mat = np.sort(rs.randint(0, cs.static.n_materials, n))
    assert len(np.unique(mat)) == cs.static.n_materials

    def unit():
        v = rs.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    wo, wi = unit(), unit()
    refl = rs.uniform(size=n) < 0.5
    u = rs.uniform(0, 1, (3, n)).astype(np.float32)
    mine = make_bsdf(cs.arrays, cs.static, torch.as_tensor(mat), lobe_table(cs.arrays, cs.static))
    theirs = ref_make_bsdf(ref.arrays, ref.static, jnp.asarray(mat.astype(np.int32)), jnp.zeros((n, 2)),
                           jnp.zeros((n, 3)))
    t = [torch.as_tensor(x) for x in (wo, wi)]
    j = [jnp.asarray(x) for x in (wo, wi)]
    f = bsdf.bsdf_f(mine, *t, torch.as_tensor(refl), "importance")
    # a transmission without the 1 / eta^2 compression is up to eta^2 =
    # 2.25 times its radiance value, and its ulps with it: atol 2.5e-6
    np.testing.assert_allclose(f.numpy(), np.asarray(ref_bsdf.bsdf_f(theirs, *j, jnp.asarray(refl), "importance")),
                               rtol=1e-5, atol=2.5e-6)
    _close(bsdf.bsdf_pdf(mine, *t).numpy(), ref_bsdf.bsdf_pdf(theirs, *j), "pdf")
    f_rad = bsdf.bsdf_f(mine, *t, torch.as_tensor(refl))
    assert torch.equal(f_rad, bsdf.bsdf_f(mine, *t, torch.as_tensor(refl), "radiance"))
    differs = (f != f_rad).any(1).numpy()
    if scene == "variants":  # the microfacet transmission's eta^2
        assert differs.any() and not refl[differs].any()
    bs = bsdf.bsdf_sample(mine, t[0], *(torch.as_tensor(x) for x in u), "importance")
    bs_r = ref_bsdf.bsdf_sample(theirs, j[0], *(jnp.asarray(x) for x in u), "importance")
    for key in ("specular", "valid"):
        np.testing.assert_array_equal(bs[key].numpy(), np.asarray(bs_r[key]), err_msg=key)
    valid = np.asarray(bs_r["valid"])
    graze = np.abs(np.asarray(bs_r["wi"])[:, 2]) < 0.05
    # the sampled directions as the sample's f and pdf: a refraction near
    # total internal reflection amplifies an ulp (1 lane of the variants')
    _close_but_few(bs["wi"].numpy()[~graze], np.asarray(bs_r["wi"])[~graze], "wi")
    for key in ("f", "pdf"):
        _close_but_few(bs[key].numpy(), bs_r[key], key)
    rad = bsdf.bsdf_sample(mine, t[0], *(torch.as_tensor(x) for x in u))
    assert all(torch.equal(rad[k], v) for k, v in bsdf.bsdf_sample(mine, t[0], *(torch.as_tensor(x) for x in u),
                                                                    "radiance").items())
    spec_t = valid & np.asarray(bs_r["specular"]) & (np.asarray(bs_r["wi"])[:, 2] * wo[:, 2] < 0)
    if spec_t.any():  # the specular transmission drops (eta_i / eta_t)^2
        assert (rad["f"].numpy()[spec_t] != bs["f"].numpy()[spec_t]).any()


def test_fourier_importance_mode_matches_reference(tmp_path):
    from pbrt_tpu_torch.core.fourierbsdf import write_rough_conductor_table
    from test_torch_materials import zoo_gallery

    path = str(tmp_path / "rc.bsdf")
    write_rough_conductor_table(path, alpha=0.3, nmu=10)
    cs, ref = (compile_scene(zoo_gallery(path), "cpu"), ref_compile_scene(_to_ref(zoo_gallery(path))))
    rs = np.random.RandomState(19)
    n = 1024
    wo = rs.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wi = rs.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    u1, u2 = rs.uniform(0, 1, (2, n)).astype(np.float32)
    tid = np.zeros(n, np.int64)
    ft, ft_r = cs.arrays.fourier, ref.arrays.fourier
    for mode in ("radiance", "importance"):
        f = fourier.fourier_f(ft, torch.as_tensor(tid), torch.as_tensor(wo), torch.as_tensor(wi), mode).numpy()
        f_r = np.asarray(ref_fourier.fourier_f(ft_r, jnp.asarray(tid.astype(np.int32)), jnp.asarray(wo),
                                               jnp.asarray(wi), mode))
        np.testing.assert_allclose(f, f_r, rtol=0, atol=1e-5 * np.abs(f_r).max(), err_msg=mode)
        s = fourier.fourier_sample(ft, torch.as_tensor(tid), torch.as_tensor(wo), torch.as_tensor(u1),
                                   torch.as_tensor(u2), mode)
        s_r = ref_fourier.fourier_sample(ft_r, jnp.asarray(tid.astype(np.int32)), jnp.asarray(wo), jnp.asarray(u1),
                                         jnp.asarray(u2), mode)
        y = np.asarray(s_r["f"])
        np.testing.assert_allclose(s["f"].numpy(), y, rtol=5e-3, atol=1e-5 * np.abs(y).max(), err_msg=mode)


def test_correct_shading_normal_matches_reference():
    rs = np.random.RandomState(21)
    vs = [rs.normal(size=(N, 3)).astype(np.float32) for _ in range(4)]
    vs = [v / np.linalg.norm(v, axis=1, keepdims=True) for v in vs]
    a = bsdf.correct_shading_normal(*(torch.as_tensor(v) for v in vs)).numpy()
    b = np.asarray(ref_bsdf.correct_shading_normal(*(jnp.asarray(v) for v in vs)))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the endpoints
# ---------------------------------------------------------------------------


def test_camera_endpoints_match_reference():
    desc = scenes.mesh_room(4)
    cam = camera.make_camera(desc.camera, desc.film, "cpu")
    cam_r = ref_camera.make_camera(_to_ref(desc.camera), _to_ref(desc.film))
    rs = np.random.RandomState(23)
    p = rs.uniform([-3.5, -0.5, -3.5], [3.5, 3.5, 2.0], (N, 3)).astype(np.float32)
    w = rs.normal(size=(N, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    we, px, py, ok = camera.camera_we(cam, None, torch.as_tensor(w))
    we_r, px_r, py_r, ok_r = ref_camera.camera_we(cam_r, None, jnp.asarray(w))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    np.testing.assert_allclose(we.numpy(), np.asarray(we_r), rtol=1e-5)
    np.testing.assert_allclose(px.numpy()[ok.numpy()], np.asarray(px_r)[ok.numpy()], atol=2e-4)
    pp, pd = camera.camera_pdf_we(cam, torch.as_tensor(w))
    np.testing.assert_allclose(pd.numpy(), np.asarray(ref_camera.camera_pdf_we(cam_r, jnp.asarray(w))[1]), rtol=1e-5)
    s = camera.camera_sample_wi(cam, torch.as_tensor(p))
    s_r = ref_camera.camera_sample_wi(cam_r, jnp.asarray(p))
    np.testing.assert_array_equal(s["valid"].numpy(), np.asarray(s_r["valid"]))
    assert s["valid"].numpy().mean() > 0.2
    for key in ("wi", "dist", "we", "pdf"):
        np.testing.assert_allclose(s[key].numpy(), np.asarray(s_r[key]), rtol=1e-5, atol=1e-7, err_msg=key)


def _sky_gallery():
    """The gallery under test_torch_lights.py's image-mapped sky alone."""
    desc = scenes.spheres_gallery()
    desc.lights = [_sky(True)[0].lights[0]]
    return desc


LIGHT_SCENES = {
    "gallery": scenes.spheres_gallery,  # point, spot, distant
    # two-sided triangle and quadric area lights, goniometric, projection
    "quadric_room": lambda: scenes.quadric_room(4, instances=False, prop_res=6),
    "sky_map": lambda: _sky_gallery(),  # an image-mapped infinite light
}


@pytest.mark.parametrize("scene", list(LIGHT_SCENES))
def test_sample_le_matches_reference(scene):
    desc = LIGHT_SCENES[scene]()
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    rs = np.random.RandomState(29)
    lid = rs.randint(0, cs.static.n_lights, N)
    u = rs.uniform(0, 1, (4, N)).astype(np.float32)
    mine = lights.sample_le(cs.arrays, cs.static, torch.as_tensor(lid), *(torch.as_tensor(x) for x in u))
    theirs = jax.jit(lambda lid, *u: ref_lights.sample_le(ref.arrays, ref.static, lid, *u))(
        jnp.asarray(lid.astype(np.int32)), *(jnp.asarray(x) for x in u))
    for key in ("o", "d", "le_over_pdf", "n"):
        np.testing.assert_allclose(mine[key].numpy(), np.asarray(theirs[key]), rtol=2e-5, atol=1e-5, err_msg=key)
    assert (mine["le_over_pdf"].numpy() > 0).any(1).mean() > 0.3
    n = mine["n"]
    pdf = lights.area_light_pdf_dir(cs.arrays, torch.as_tensor(lid), n, mine["d"])
    pdf_r = ref_lights.area_light_pdf_dir(ref.arrays, jnp.asarray(lid.astype(np.int32)), jnp.asarray(n.numpy()),
                                          jnp.asarray(mine["d"].numpy()))
    np.testing.assert_allclose(pdf.numpy(), np.asarray(pdf_r), rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# BDPT
# ---------------------------------------------------------------------------

W, H, SEED, DEPTH = 8, 6, 3, 3


def bdpt_scene(spp=2):
    """A matte floor, a sphere area light, a point light and a glass sphere
    (brute class), under BDPT."""
    floor = HostPrimitive(
        shape=ShapeRecord(mesh=TriangleMesh(p=np.array([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float64),
                                            indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32))),
        material=HostMaterial(kind="matte", params={"Kd": ("const", np.array([0.65, 0.5, 0.4]))}))
    lamp = HostPrimitive(
        shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([0.8, 1.5, 0.0]), radius=0.2)),
        material=HostMaterial(kind="matte", params={"Kd": ("const", np.zeros(3))}),
        area_light=HostLight(kind="area", intensity=np.array([8.0, 8.0, 8.0]), two_sided=False))
    glass = HostPrimitive(
        shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([-0.5, 0.5, 0.3]), radius=0.5)),
        material=HostMaterial(kind="glass", params={}))
    point = HostLight(kind="point", intensity=np.array([3.0, 3.0, 3.0]), from_point=np.array([-1.0, 2.5, 1.0]),
                      light_to_world=Transform.translate([-1.0, 2.5, 1.0]))
    return SceneDescription(
        primitives=[floor, lamp, glass], lights=[point],
        camera=CameraConfig(kind="perspective", camera_to_world=Transform.look_at([0, 2, 4], [0, 0.5, 0], [0, 1, 0]),
                            fov=45.0),
        film=FilmConfig(x_resolution=W, y_resolution=H), sampler=SamplerConfig(kind="zerotwosequence",
                                                                                pixel_samples=spp),
        integrator=IntegratorConfig(kind="bdpt", max_depth=DEPTH))


@pytest.fixture(scope="module")
def waves():
    """The port's and the reference's waves (samples 0 and 1) with every
    strategy's record."""
    desc = bdpt_scene()
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    ys, xs = np.mgrid[0:H, 0:W]
    px, py, pid = xs.ravel(), ys.ravel(), (ys * W + xs).ravel()
    cam_r = ref_camera.make_camera(ref.description.camera, ref.description.film)
    power = ref_lights.compute_power(ref.arrays, ref.static)
    cdf_r = jnp.cumsum(power)
    cdf_r = cdf_r / jnp.maximum(cdf_r[-1], 1e-12)
    possible = ref_make_bsdf(ref.arrays, ref.static, jnp.zeros(1, jnp.int32), jnp.zeros((1, 2), jnp.float32),
                             jnp.zeros((1, 3), jnp.float32))["possible"]
    cam = camera.make_camera(desc.camera, desc.film, "cpu")
    p = lights.compute_power(cs.arrays, cs.static)
    cdf = torch.cumsum(p, 0)
    cdf = cdf / torch.clamp(cdf[-1], min=1e-12)
    ctx = bdpt._Ctx(cs.arrays, cs.static)
    out = []
    for s in (0, 1):
        theirs = ref_bdpt.bdpt_wave(ref.arrays, ref.static, possible, cam_r, cdf_r, jnp.uint32(SEED),
                                    jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)),
                                    jnp.asarray(pid.astype(np.uint32)), jnp.uint32(s), DEPTH, W, H,
                                    collect_debug=True)
        mine = bdpt.bdpt_wave(cs.arrays, cs.static, ctx, cam, cdf, SEED, *(torch.as_tensor(x) for x in (px, py, pid)),
                              s, DEPTH, W, H, collect_debug=True)
        out.append((mine, theirs))
    return cs, pid, out


def test_bdpt_wave_matches_reference_per_strategy(waves):
    _cs, _pid, out = waves
    mine, theirs = out[1]
    assert set(mine[3]) == set(theirs[3]) == set(bdpt.strategies(DEPTH))
    contributing = 0
    for key, rec_r in theirs[3].items():
        rec = mine[3][key]
        assert rec[0] == rec_r[0], key
        if rec[0] == "film":
            c, c_r = rec[1].numpy(), np.asarray(rec_r[1])
            np.testing.assert_allclose(c, c_r, rtol=0, atol=2e-5, err_msg=str(key))
            if rec_r[2] is not None:
                np.testing.assert_allclose(rec[2].numpy(), np.asarray(rec_r[2]), rtol=0, atol=2e-5, err_msg=str(key))
            contributing += bool((c_r > 0).any())
        else:
            np.testing.assert_array_equal(rec[1].numpy(), np.asarray(rec_r[1]), err_msg=str(key))
            np.testing.assert_allclose(rec[2].numpy(), np.asarray(rec_r[2]), rtol=0, atol=2e-5, err_msg=str(key))
            contributing += bool((np.asarray(rec_r[2]) > 0).any())
    assert contributing >= 4
    np.testing.assert_allclose(mine[0].numpy(), np.asarray(theirs[0]), rtol=0, atol=2e-5)


def test_render_bdpt_matches_reference(waves):
    """render_bdpt at 2 spp against the reference's host loop (render_bdpt
    :808-836) over the same waves."""
    cs, pid, out = waves
    acc = np.zeros((W * H, 3), np.float64)
    for _mine, (L, spx, sval, _dbg) in out:
        film = np.zeros((W * H + 1, 3), np.float32)
        np.add.at(film, np.asarray(spx), np.asarray(sval))
        acc += film[:W * H]
        acc[pid] += np.asarray(L, np.float64)
    ref_img = (acc / 2).reshape(H, W, 3).astype(np.float32)
    img = render.render_compiled(cs, seed=SEED)
    assert render.render_compiled.last_timing["tier"] == "torch-bdpt/brute"
    np.testing.assert_allclose(img, ref_img, rtol=0, atol=1e-5)
    assert img.mean() > 0.01


def test_cli_renders_bdpt(tmp_path):
    """python -m pbrt_tpu_torch on a written BDPT file."""
    desc = bdpt_scene(1)
    path = str(tmp_path / "bdpt.pbrt")
    scenes.write_pbrt(desc, path, ([0, 2, 4], [0, 0.5, 0], [0, 1, 0]))
    assert cli.main([path, "--device", "cpu", "--quiet", "-o", str(tmp_path / "b.pfm")]) == 0
    assert cli.main.last_run["timing"]["tier"] == "torch-bdpt/brute"


def test_reference_debug_films_go_to_the_working_directory(tmp_path, monkeypatch):
    """ROADMAP C, reproduced: Integrator "bdpt" "bool visualizestrategies"
    writes bdpt_dNN_sNN_tNN.exr films into the working directory, as the
    reference does, not beside the output."""
    monkeypatch.chdir(tmp_path)
    desc = bdpt_scene(1)
    desc.integrator.max_depth = 1
    desc.integrator.visualize_strategies = True
    render.render_compiled(compile_scene(desc, "cpu"), seed=SEED)
    names = sorted(f for f in os.listdir(tmp_path) if f.endswith(".exr"))
    assert names == sorted(f"bdpt_d{s + t - 2:02d}_s{s:02d}_t{t:02d}.exr" for s, t in bdpt.strategies(1))
