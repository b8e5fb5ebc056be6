"""The port's per-sample wave against the reference's, on the CPU.

render.make_wave_fn's wave (integrator.trace_wave, _trace_ao) against the
reference's jitted make_wave_fn on the same tables, pixels and (pixel,
sample, dimension) streams: sample 1 (seed 3) of every pixel of a 16x12
film at depth 3 for volpath on the small fog room (a homogeneous
fog as the camera's medium, an interface box holding an 8^3 grid of smoke:
distance sampling, the phase function, null crossings, shadow rays'
transmittance), path on the small sss room with the tabulated BSSRDF (its
exit event forced, below, on the 113 pixels of a 64x48 film that see
the spheres) and with the random walk (PBRT_TPU_NO_TABSSS=1: the interiors
as media, 24 extra bounces), whitted on the mesh room, ao on an open
scene (sky_meshes) and directlighting ("all" and "one") on the mesh room
(two area-light triangles). The radiance agrees within rtol
1e-4 (atol 1e-5), the filter weights and the path-vertex counts exactly:
the differences are ulps of sqrt, exp and log between the packages (the
reference's compiled wave contracts multiply-adds as well), which no
sampling decision of these films amplifies.

The reference's tabulated BSSRDF fires only after a specular transmission
into a subsurface material, and its subsurface lobes hold none (a specular
reflection and a diffuse transmission): its exit event never runs (ROADMAP
C, test_reference_tabulated_bssrdf_never_fires). The port keeps it so. To
hold the event itself op by op, one case makes every sampled transmission
count as specular in both packages (bsdf_sample patched alike), so that
the probe chain, the sel_idx-th record, Sp / pdf_sp and the adapter lobe's
NEE run on the lanes that enter the spheres.

Also: the port's wave against its own persistent wavefront on the mesh
room under PBRT_TPU_FORCE_WAVE (tests/test_persistent.py's tolerance, rtol
2e-4); checkpoint and resume (a render stopped after two of four samples
and resumed equals the uninterrupted one bit for bit; a checkpoint of
another seed or spp is ignored; the reference's .npz keys and dtypes); the
front end's --checkpoint; and the reference's faults this slice met.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import render as ref_render
from pbrt_tpu.device import bsdf as ref_bsdf
from pbrt_tpu.device import integrator as ref_integrator
from pbrt_tpu.device.materials import make_bsdf as ref_make_bsdf
from pbrt_tpu.parser.api import pbrt_parse as ref_pbrt_parse
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch import main as cli
from pbrt_tpu_torch import render, scenes
from pbrt_tpu_torch.core.imageio import read_image
from pbrt_tpu_torch.device import integrator
from pbrt_tpu_torch.parser.api import pbrt_parse
from pbrt_tpu_torch.scene.builder import compile_scene
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

W, H, SEED = 16, 12, 3


def _small(desc, depth=3, spp=2):
    desc.film.x_resolution, desc.film.y_resolution = W, H
    desc.sampler.pixel_samples = spp
    desc.integrator.max_depth = depth
    return desc


def _directlighting(strategy):
    desc = scenes.mesh_room(8)
    desc.integrator.kind, desc.integrator.strategy = "directlighting", strategy
    return desc


def _kind(make, kind):
    desc = make()
    desc.integrator.kind = kind
    return desc


CASES = {
    "volpath-fog": lambda: scenes.fog_room(8, 8),
    "path-sss-walk": lambda: scenes.sss_room(8, 8, 8),
    "path-sss-event": lambda: scenes.sss_room(8, 8, 8),
    "whitted": lambda: _kind(lambda: scenes.mesh_room(8), "whitted"),
    "ao": lambda: _kind(lambda: scenes.sky_meshes(6, 6, 8), "ao"),
    "directlighting-all": lambda: _directlighting("all"),
    "directlighting-one": lambda: _directlighting("one"),
}


def _forced(orig):
    """bsdf_sample with every sampled transmission marked specular (both
    packages' dicts and arrays)."""
    def sample(lobes, wo, u_lobe, u1, u2):
        bs = dict(orig(lobes, wo, u_lobe, u1, u2))
        bs["specular"] = bs["specular"] | (bs["valid"] & (bs["wi"][:, 2] * wo[:, 2] < 0))
        return bs
    return sample


def _pixels():
    ys, xs = np.mgrid[0:H, 0:W]
    return xs.ravel(), ys.ravel(), (ys * W + xs).ravel()


def _sss_pixels(cs):
    """The pixels of a 64x48 film whose centre ray first hits a subsurface
    sphere (a few hundred): the lanes on which the forced event runs."""
    from pbrt_tpu_torch.device.camera import generate_rays, make_camera
    from pbrt_tpu_torch.device.intersect import intersect

    desc = cs.description
    ys, xs = np.mgrid[0:48, 0:64]
    xs, ys = xs.ravel(), ys.ravel()
    cam = make_camera(desc.camera, desc.film, "cpu")
    zero = torch.zeros(xs.size)
    o, d = generate_rays(cam, torch.as_tensor(xs + 0.5, dtype=torch.float32),
                         torch.as_tensor(ys + 0.5, dtype=torch.float32), zero, zero)
    prim = intersect(cs.arrays, cs.static, o, d, torch.full((xs.size,), torch.inf))["prim"]
    kind = cs.arrays.mat_kind[cs.arrays.prim_mat[prim.clamp(min=0)]].numpy()
    on = (prim.numpy() >= 0) & np.isin(kind, (11, 12))
    return xs[on], ys[on], (ys * 64 + xs)[on]


@pytest.mark.parametrize("case", list(CASES))
def test_wave_matches_reference(case, monkeypatch):
    if case.endswith("walk"):
        monkeypatch.setenv("PBRT_TPU_NO_TABSSS", "1")
    if case.endswith("event"):
        monkeypatch.setattr(ref_integrator, "bsdf_sample", _forced(ref_integrator.bsdf_sample))
        monkeypatch.setattr(integrator, "bsdf_sample", _forced(integrator.bsdf_sample))
    desc = _small(CASES[case]())
    if case == "ao":
        desc.integrator.n_samples = 8
    if case.endswith("event"):
        desc.film = dataclasses.replace(desc.film, x_resolution=64, y_resolution=48)
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    px, py, pid = _sss_pixels(cs) if case.endswith("event") else _pixels()
    wave_r = ref_render.make_wave_fn(ref)
    wave = render.make_wave_fn(cs)
    assert render.LAST_WAVE_TIER == "torch-wave/" + ("brute" if cs.static.use_brute_force else "wide")
    lanes = [torch.as_tensor(x.astype(np.int64)) for x in (px, py, pid)]
    lanes_r = (jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)), jnp.asarray(pid.astype(np.uint32)))
    L, w, nv = (x.numpy() for x in wave(cs.arrays, *lanes, 1, SEED))
    L_r, w_r, nv_r = (np.asarray(x) for x in wave_r(ref.arrays, *lanes_r, jnp.uint32(1), jnp.uint32(SEED)))
    np.testing.assert_array_equal(w, w_r)
    np.testing.assert_array_equal(nv, nv_r)
    np.testing.assert_allclose(L, L_r, rtol=1e-4, atol=1e-5)
    assert L.mean() > 0.005


def test_sss_event_fires_when_forced(monkeypatch):
    """The forced case above does run the exit event: with bsdf_sample
    patched, lanes on the small sss room's spheres enter them and some find
    an exit (their probe chains hit the same material)."""
    seen = []
    chain = integrator.probe_chain

    def spy(*a, **k):
        recs = chain(*a, **k)
        seen.append(int(sum(m.to(torch.int64) for m, _h, _b in recs).gt(0).sum()))
        return recs

    monkeypatch.setattr(integrator, "bsdf_sample", _forced(integrator.bsdf_sample))
    monkeypatch.setattr(integrator, "probe_chain", spy)
    desc = _small(scenes.sss_room(8, 8, 8))
    desc.film = dataclasses.replace(desc.film, x_resolution=64, y_resolution=48)
    cs = compile_scene(desc, "cpu")
    px, py, pid = (torch.as_tensor(x.astype(np.int64)) for x in _sss_pixels(cs))
    assert px.numel() > 100
    render.make_wave_fn(cs)(cs.arrays, px, py, pid, 0, SEED)
    assert len(seen) == integrator.wave_iterations(cs.static, "path", 3) and sum(seen) > 20


def test_reference_tabulated_bssrdf_never_fires():
    """ROADMAP C: the reference's exit event needs a specular transmission
    (integrator.py :603), and its subsurface rows' lobes (materials.py
    :313-330) are a specular reflection and a diffuse transmission: no lobe
    of theirs samples a specular transmission (LOBE_SPEC_T or
    LOBE_FRESNEL_SPEC), so the event never runs."""
    ref = ref_compile_scene(_to_ref(scenes.sss_room(8, 8, 8)))
    rows = np.nonzero(np.asarray(ref.arrays.sss_sigma_t).sum(1) > 0)[0]
    assert len(rows) == 2
    lobes = ref_make_bsdf(ref.arrays, ref.static, jnp.asarray(rows), jnp.zeros((2, 2)), jnp.zeros((2, 3)))
    kinds = set(np.unique(np.asarray(lobes["kind"])).tolist())
    assert kinds == {ref_bsdf.LOBE_NONE, ref_bsdf.LOBE_LAMBERT_T, ref_bsdf.LOBE_SPEC_R}
    assert not np.asarray(ref_bsdf._is_specular(jnp.asarray(ref_bsdf.LOBE_LAMBERT_T)))


@pytest.mark.parametrize("text, kind", [('Material "interface"', "matte"),
                                        ('Material "subsurface" "string name" "Skin1"', "subsurface")])
def test_reference_parse_faults_are_kept(tmp_path, text, kind):
    """ROADMAP C: both parsers (the port's is the reference's copy) make
    Material "interface" matte (only "" and "none" give the null
    material), and keep a subsurface material's measured-medium "name"
    without reading it: its sigma_a stays the default."""
    path = tmp_path / "m.pbrt"
    path.write_text(f'Camera "perspective"\nWorldBegin\n{text}\nShape "sphere"\nWorldEnd\n')
    for parse in (pbrt_parse, ref_pbrt_parse):
        mat = parse(str(path)).primitives[0].material
        assert mat.kind == kind
        if kind == "subsurface":
            assert mat.params["preset"][1] == "Skin1"
            np.testing.assert_array_equal(np.ravel(mat.params["sigma_a"][1]), [0.0011, 0.0024, 0.014])


def _room(spp=4, kind="path"):
    desc = scenes.mesh_room(8)
    desc.film.x_resolution, desc.film.y_resolution = 24, 16
    desc.sampler.pixel_samples = spp
    desc.integrator.kind = kind
    return compile_scene(desc, "cpu")


def test_wave_matches_persistent_wavefront(monkeypatch):
    """The mesh room through the wave (PBRT_TPU_FORCE_WAVE) and through the
    persistent wavefront: the same sample streams, so the images within
    tests/test_persistent.py's tier tolerance and the same path vertices."""
    cs = _room()
    monkeypatch.delenv("PBRT_TPU_FORCE_WAVE", raising=False)
    img_p = render.render_compiled(cs, seed=SEED)
    t_p = render.render_compiled.last_timing
    monkeypatch.setenv("PBRT_TPU_FORCE_WAVE", "1")
    img_w = render.render_compiled(cs, seed=SEED)
    t_w = render.render_compiled.last_timing
    assert t_p["tier"] == "torch-wavefront/plain-wide" and t_w["tier"] == "torch-wave/wide"
    assert img_p.mean() > 0.1 and t_w["n_vertices"] == t_p["n_vertices"]
    np.testing.assert_allclose(img_w, img_p, rtol=2e-4, atol=2e-4)


class _Stop(Exception):
    pass


def test_checkpoint_resumes_to_the_uninterrupted_render(tmp_path):
    cs = _room()
    whole = render.render_compiled(cs, seed=SEED, checkpoint_path=str(tmp_path / "a.npz"), checkpoint_every=1)
    ck = np.load(tmp_path / "a.npz")
    assert ck["acc"].dtype == np.float64 and ck["acc"].shape == (24 * 16, 3) and ck["wacc"].shape == (24 * 16,)
    assert (int(ck["next_sample"]), int(ck["spp_total"]), int(ck["seed"])) == (4, 4, SEED)

    def stop_after_two(done, total):
        if done == 2:
            raise _Stop

    path = str(tmp_path / "b.npz")
    with pytest.raises(_Stop):
        render.render_compiled(cs, seed=SEED, progress=stop_after_two, checkpoint_path=path, checkpoint_every=1)
    assert int(np.load(path)["next_sample"]) == 2
    done = []
    resumed = render.render_compiled(cs, seed=SEED, checkpoint_path=path, checkpoint_every=1,
                                     progress=lambda d, t: done.append(d))
    assert done == [3, 4] and np.array_equal(resumed, whole)
    # a checkpoint of another seed, or of another spp, is ignored
    for seed, spp in ((SEED + 1, 4), (SEED, 8)):
        np.savez(tmp_path / "c.npz", acc=np.ones((24 * 16, 3)), wacc=np.ones(24 * 16), next_sample=2,
                 spp_total=spp, seed=seed)
        again = render.render_compiled(cs, seed=SEED, checkpoint_path=str(tmp_path / "c.npz"), checkpoint_every=4)
        assert np.array_equal(again, whole) and int(np.load(tmp_path / "c.npz")["seed"]) == SEED


def test_cli_checkpoint_resumes(tmp_path):
    """python -m pbrt_tpu_torch --checkpoint: a run that finds its finished
    checkpoint renders no sample and writes the same film."""
    desc = scenes.mesh_room(8)
    desc.film = dataclasses.replace(desc.film, x_resolution=16, y_resolution=8)
    path = str(tmp_path / "room.pbrt")
    scenes.write_pbrt(desc, path, scenes.ROOM_LOOK_AT)
    args = [path, "--device", "cpu", "--quiet", "--spp", "2", "--checkpoint", str(tmp_path / "k.npz")]
    assert cli.main(args + ["-o", str(tmp_path / "a.pfm"), "--checkpoint-every", "1"]) == 0
    assert cli.main.last_run["timing"]["tier"] == "torch-wave/wide"
    assert cli.main(args + ["-o", str(tmp_path / "b.pfm")]) == 0
    assert cli.main.last_run["timing"]["n_vertices"] == 0
    np.testing.assert_array_equal(read_image(str(tmp_path / "a.pfm")), read_image(str(tmp_path / "b.pfm")))


ROUTES = {"brute": scenes.area_box, "wide": lambda: scenes.mesh_room(8), "wide-mixed": lambda: scenes.sphere_room(8),
          "bvh": lambda: scenes.quadric_room(8, instances=4, prop_res=8),
          "kdtree": lambda: scenes.quadric_room(8, instances=False, accelerator="kdtree", prop_res=8)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_intersect_takes_dead_lanes_on_every_route(route):
    """The wave sends its dead lanes to every query with t_max < 0 (as the
    reference's does, integrator.py :241): on every route a lane with
    t_max = -1 hits nothing, closest or any hit, and the other lanes get
    what a query without the dead lanes gives them."""
    from pbrt_tpu_torch.device.intersect import intersect, intersect_p, route_name

    cs = compile_scene(ROUTES[route](), "cpu")
    assert route_name(cs.static) == route
    rs = np.random.RandomState(6)
    n = 512
    o = torch.as_tensor(rs.uniform([-3.0, 0.5, -3.0], [3.0, 3.0, 3.0], (n, 3)).astype(np.float32))
    d = torch.as_tensor(rs.normal(size=(n, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    dead = torch.arange(n) % 3 == 0
    t_max = torch.where(dead, -1.0, torch.inf)
    hit = intersect(cs.arrays, cs.static, o, d, t_max, sort_rays=True)
    live = intersect(cs.arrays, cs.static, o[~dead], d[~dead], torch.full((int((~dead).sum()),), torch.inf))
    assert (hit["prim"][dead] < 0).all() and (hit["prim"][~dead] >= 0).float().mean() > 0.5
    assert torch.equal(hit["prim"][~dead].long(), live["prim"].long()) and torch.equal(hit["t"][~dead], live["t"])
    occ = intersect_p(cs.arrays, cs.static, o, d, t_max, sort_rays=True)
    assert not occ[dead].any() and torch.equal(occ[~dead], intersect_p(cs.arrays, cs.static, o[~dead], d[~dead],
                                                                       torch.full((int((~dead).sum()),), torch.inf)))
