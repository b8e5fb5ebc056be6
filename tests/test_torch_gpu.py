"""pbrt_tpu_torch's CUDA kernels against their plain PyTorch twins, on a card.

Marked `gpu`: a fixture decides whether there is a CUDA device and skips
the tests where there is none. The file imports no JAX, because the card's
machine has none; run it there from the repository root with

    python -m pytest --noconftest tests/test_torch_gpu.py -q

The traversal kernels and their plain version do the same per-ray traversal
on the same Hopper records in IEEE float32 without fused multiply-adds, so
their outputs must be identical: B1 against the plain traversal, and the
cooperative kernel (B2) against B1 and the plain traversal, pops included.
The megakernels' sin/cos/log may differ from torch's by ulps,
so the brute megakernel (B3) and the wide megakernel (B4) are held to their
twins with the reference megakernels' image tolerances
(tests/test_megakernel.py, tests/test_megakernel_wide.py), B3 in all six
of its modes. B3's and B4's persistent grids are also run on fewer lanes
than they have path slots, to show that their pixel counters serve every
lane exactly once, and B3's instrumented instantiation is held to the
kernel bit for bit. B4 runs under every sampler of its class, the
extended instantiations (filters, attribute rows, constant sky) on
sky_meshes. B3's textured instantiation (the Kd atlas) runs on
textured_gallery, B4's checkerboard Kd on material_room(checker=True),
B4's sphere instantiation (full spheres and a sphere lamp) on sphere_room
and B3 on a gallery with a glossy uber sphere; the wavefront's mixed query
(B1 over a mixed scene's triangle subset, its spheres tested beside it) is
held to its twin bit for bit, and so are the BVH and kd walks of
csrc/bvh_walk.cu (quadric_room and its kd variant), whose renders are held
on the card against the CPU. The grid media's tracking kernel
(csrc/medium_track.cu) makes its twin's decisions on every ray, and the
per-sample wave's renders (volpath, the BSSRDF, whitted) are held on the
card against the CPU. The walks' motion instantiations match their twins
bit for bit at random shutter times, and the motion room, the realistic
camera and BDPT render on the card as on the CPU. The sharded path
(parallel/shard.py) on two shards of the card matches one shard.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch import render
from pbrt_tpu_torch.device import megakernel, megakernel_wide, wide_bvh
from pbrt_tpu_torch.device.camera import make_camera
from pbrt_tpu_torch.device.sampler import halton_tables, sobol_tables
from pbrt_tpu_torch.scene.builder import compile_scene
from pbrt_tpu_torch.scenes import GAUSSIAN_DEFAULTS, area_box, material_room, mesh_room, sky_meshes, spheres_gallery
from torch_test_scenes import deep_kd_room, small_quadric_room, track_rays


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _small_room():
    desc = mesh_room(8)
    desc.film.x_resolution, desc.film.y_resolution = 24, 16
    desc.sampler.pixel_samples = 2
    return compile_scene(desc, "cpu")


def _random_rays(device, R=4096):
    rs = np.random.RandomState(5)
    o = np.stack([rs.uniform(-3, 3, R), rs.uniform(0.5, 3.0, R), rs.uniform(-3, 3, R)], -1)
    d = rs.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.uniform(size=R) < 0.5, np.inf, rs.uniform(-1.0, 4.0, R))
    return [torch.as_tensor(x, dtype=torch.float32, device=device) for x in (o, d, t_max)]


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("sort", [False, True])
def test_kernel_matches_plain(cuda_device, any_hit, sort):
    sa = _small_room().arrays.to(cuda_device)
    R = 4096
    args = _random_rays(cuda_device, R)
    before = wide_bvh.traverse_cuda.launches
    k = wide_bvh.wide_intersect(sa, *args, any_hit=any_hit, sort=sort)
    p = wide_bvh.wide_intersect_plain(sa, *args, any_hit=any_hit, sort=sort)
    torch.cuda.synchronize()
    assert wide_bvh.traverse_cuda.launches == before + 1
    assert 0 < int(k[2].sum()) < R
    for x, y in zip(k, p):
        assert torch.equal(x.cpu(), y.cpu())
    assert wide_bvh.traverse_cuda.counters[cuda_device].tolist() == [0, 0]


@pytest.mark.gpu
def test_sharded_path_matches_one_shard(cuda_device):
    """Two shards on one card (each its own thread and stream) against one
    shard, at the reference's mesh-invariance tolerance
    (tests/test_shard_parity.py); both go through B1."""
    from pbrt_tpu_torch.parallel import shard

    cs = _small_room()
    img1 = shard.render_sharded_step(cs, cs.description, [cuda_device], spp=2)
    wide_bvh.traverse_cuda.launches = 0
    img2 = shard.render_sharded_step(cs, cs.description, [cuda_device, cuda_device], spp=2)
    assert wide_bvh.traverse_cuda.launches > 0
    assert np.isfinite(img2).all() and img1.mean() > 0
    np.testing.assert_allclose(img2, img1, rtol=2e-4, atol=2e-5)


@pytest.mark.gpu
def test_render_cuda_matches_cpu(cuda_device):
    cs = _small_room()
    img_c = render.render_compiled(cs, seed=1)
    img_g = render.render_compiled(cs.to(cuda_device), seed=1)
    assert render.render_compiled.last_timing["tier"] == "torch-wavefront/cuda-wide"
    # chip_smoke.py's rule: identical sample streams, so the images agree up
    # to float32 differences between the CPU's and the card's sin/cos/sqrt
    assert np.abs(img_g - img_c).sum() / np.abs(img_c).sum() < 1e-3
    assert np.isclose(img_g, img_c, rtol=1e-2, atol=1e-4).all(axis=-1).mean() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["area_box", "material_room"])
def test_wavefront_cuda_matches_cpu(cuda_device, scene):
    """The wavefront's array code on the card against the CPU: area_box
    through the brute wavefront (spheres, area and point lights, 'spatial'
    selection built on each device), material_room through the wide one
    (every lobe kind, delta and area lights), with chip_smoke.py's rule."""
    desc = area_box() if scene == "area_box" else material_room(8)
    desc.film.x_resolution, desc.film.y_resolution = 32, 16
    desc.sampler.pixel_samples = 2
    cs = compile_scene(desc, "cpu")
    img_c = render.render_compiled(cs, seed=1)
    img_g = render.render_compiled(cs.to(cuda_device), seed=1)
    shape = "brute" if scene == "area_box" else "wide"
    assert render.render_compiled.last_timing["tier"] == f"torch-wavefront/cuda-{shape}"
    assert np.abs(img_g - img_c).sum() / np.abs(img_c).sum() < 1e-3
    assert np.isclose(img_g, img_c, rtol=1e-2, atol=1e-4).all(axis=-1).mean() >= 0.99


def _gallery_consts(W, H, sampler="zerotwosequence", ikind="path", spp=2):
    """The spheres gallery at W x H on the host, with its B3 constants."""
    desc = spheres_gallery()
    desc.film.x_resolution, desc.film.y_resolution = W, H
    desc.integrator.kind = ikind
    desc.integrator.strategy = "one"
    desc.sampler.kind = sampler
    cs = compile_scene(desc, "cpu")
    icfg = {"kind": ikind, "max_depth": 5, "rr_threshold": 1.0, "strategy": "one", "light_strategy": "power"}
    return megakernel.extract_consts(cs, make_camera(desc.camera, desc.film, "cpu"), icfg,
                                     {"kind": sampler, "spp": spp},
                                     {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")})


def _brute_against_plain(cuda_device, consts, lanes, spp, seed):
    """B3 on the card and its twin on the host for the same lanes: the
    reference megakernel's tolerance (tests/test_megakernel.py), and no
    pixel cut by the iteration cap."""
    counters = megakernel.megakernel_cuda.counters.get(cuda_device)
    if counters is not None:
        counters.zero_()
    before = megakernel.megakernel_cuda.launches
    blob = megakernel.pack_consts(consts).to(cuda_device)
    atlas, tex = (None if x is None else x.to(cuda_device) for x in megakernel.pack_textures(consts))
    L, w, nv = (x.cpu() for x in megakernel.megakernel_cuda(
        blob, megakernel.kernel_mode(consts), *(x.to(cuda_device) for x in lanes), 0, spp, seed, atlas, tex))
    torch.cuda.synchronize()
    assert megakernel.megakernel_cuda.launches == before + 1
    assert megakernel.megakernel_cuda.counters[cuda_device].tolist() == [0]
    assert torch.equal(w, torch.full((lanes[0].shape[0],), float(spp)))
    L_p, w_p, nv_p = megakernel.megakernel_plain(consts, *lanes, 0, spp, seed)
    assert L_p.mean().item() > 1e-3
    assert torch.allclose(w, w_p)
    assert abs(float(nv.double().sum()) - float(nv_p.double().sum())) <= 4
    diff = (L - L_p).abs()
    assert (diff / (L_p.abs() + 1e-2)).max().item() < 2e-2
    assert diff.mean().item() < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["zerotwosequence", "random", "stratified"])
@pytest.mark.parametrize("ikind", ["path", "directlighting"])
def test_megakernel_matches_plain(cuda_device, ikind, sampler):
    """All six modes of B3 (3 samplers x path/directlighting) at 64x32, 2 spp."""
    W, H, spp = 64, 32, 2
    consts = _gallery_consts(W, H, sampler, ikind, spp)
    idx = torch.arange(W * H)
    _brute_against_plain(cuda_device, consts, (idx % W, idx // W, idx), spp, 7)


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["zerotwosequence", "random"])
def test_textured_megakernel_matches_plain(cuda_device, sampler):
    """B3's textured instantiation (the mip atlas in device memory, the ray
    cone's distance per slot) on textured_gallery at 64x32, 2 spp, against
    its twin."""
    from pbrt_tpu_torch.scenes import textured_gallery

    W, H, spp = 64, 32, 2
    desc = textured_gallery()
    desc.film.x_resolution, desc.film.y_resolution = W, H
    desc.sampler.kind = sampler
    cs = compile_scene(desc, "cpu")
    icfg = {"kind": "path", "max_depth": 5, "rr_threshold": 1.0, "strategy": "one", "light_strategy": "power"}
    consts = megakernel.extract_consts(cs, make_camera(desc.camera, desc.film, "cpu"), icfg,
                                       {"kind": sampler, "spp": spp},
                                       {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")})
    assert consts is not None and megakernel.kernel_mode(consts) >= megakernel.N_PLAIN_MODES
    idx = torch.arange(W * H)
    _brute_against_plain(cuda_device, consts, (idx % W, idx // W, idx), spp, 7)


@pytest.mark.gpu
def test_wide_megakernel_checker_matches_plain(cuda_device):
    """B4's extended instantiation with the checkerboard Kd:
    material_room(8, checker=True) at 64x32, 2 spp, against its twin at
    chip_smoke phase 11's tolerance."""
    W, H, spp = 64, 32, 2
    desc = material_room(8, checker=True)
    cs = compile_scene(desc, "cpu")
    consts = megakernel_wide.extract_wide_consts(
        cs, make_camera(desc.camera, desc.film, "cpu"),
        {"kind": "path", "max_depth": 5, "rr_threshold": 1.0, "light_strategy": "power"},
        {"kind": "zerotwosequence", "spp": spp},
        {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")}, megakernel_wide.DEFAULT_MAX_TRIS)
    assert consts is not None and any(e.get("kd_tex") for e in consts["mats"].values())
    idx = torch.arange(W * H)
    lanes = (idx % W, idx // W, idx)
    blob = megakernel_wide.pack_wide_consts(consts).to(cuda_device)
    L, w, nv = (x.cpu() for x in megakernel_wide.wide_megakernel_cuda(
        blob, megakernel_wide.kernel_mode(consts), cs.arrays.to(cuda_device), *(x.to(cuda_device) for x in lanes),
        0, spp, 3))
    L_p, w_p, nv_p = megakernel_wide.wide_megakernel_plain(consts, cs.arrays, *lanes, 0, spp, 3)
    assert torch.equal(w, w_p) and L_p.mean().item() > 0
    assert abs(float(nv.double().sum()) - float(nv_p.double().sum())) <= 6
    diff = (L - L_p).abs()
    assert (diff / (L_p.abs() + 1e-2)).max().item() < 2e-2
    assert diff.mean().item() < 1e-4


@pytest.mark.gpu
def test_megakernel_split_matches_the_kernel(cuda_device):
    """B3's instrumented instantiation traces the kernel's paths bit for bit,
    and its test counts are the ones those paths need: one camera ray per
    sample plus at most one continuation per path vertex, at most one shadow
    ray per vertex, and a shadow ray tests between one prim and all of them."""
    W, H, spp = 64, 32, 3
    consts = _gallery_consts(W, H, spp=spp)
    blob = megakernel.pack_consts(consts).to(cuda_device)
    mode = megakernel.kernel_mode(consts)
    idx = torch.arange(W * H, device=cuda_device)
    lanes = (idx % W, idx // W, idx)
    out = megakernel.megakernel_cuda(blob, mode, *lanes, 0, spp, 5)
    *out_s, split = megakernel.megakernel_split(blob, mode, *lanes, 0, spp, 5)
    for x, y in zip(out, out_s):
        assert torch.equal(x, y)
    n_samples, n_v, n_prims = W * H * spp, int(out[2].double().sum().item()), len(consts["prims"])
    assert n_samples <= split["closest"] <= n_samples + n_v
    assert 0 < split["shadow"] <= n_v
    assert split["shadow"] <= split["shadow_tri"] + split["shadow_sph"] <= split["shadow"] * n_prims
    assert split["total"] > 0 and split["iterations"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("spp", [1, 3])
@pytest.mark.parametrize("n_lanes", [37, 1000])
def test_megakernel_pixel_queue(cuda_device, n_lanes, spp):
    """B3's persistent grid on lane counts that are not a multiple of its
    block and smaller than its slots: every lane is served exactly once
    (weight == n_samples), no pixel is cut by the iteration cap, and the
    image is the twin's within phase 6's tolerance."""
    W, H = 64, 32
    consts = _gallery_consts(W, H, spp=spp)
    pids = torch.as_tensor(np.random.RandomState(n_lanes + spp).choice(W * H, n_lanes, replace=False))
    _brute_against_plain(cuda_device, consts, (pids % W, pids // W, pids), spp, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays", [4093, 3])
@pytest.mark.parametrize("any_hit", [False, True])
def test_joint_kernel_matches_b1(cuda_device, any_hit, n_rays):
    """B2 runs each ray through B1's pop sequence, so every output is B1's,
    and both are the plain walk's, pops included: on a ragged last warp
    (4093 rays) and on fewer rays than one warp's 8 lane groups (3)."""
    sa = _small_room().arrays.to(cuda_device)
    o, d, t_max = (x[:n_rays].contiguous() for x in _random_rays(cuda_device, 4093))
    before = wide_bvh.traverse_joint_cuda.launches
    joint = wide_bvh.traverse_joint_cuda(sa, o, d, t_max, any_hit)
    b1 = wide_bvh.traverse_cuda(sa, o, d, t_max, any_hit)
    plain = wide_bvh.traverse_plain(sa, o, d, t_max, any_hit)
    torch.cuda.synchronize()
    assert wide_bvh.traverse_joint_cuda.launches == before + 1
    if n_rays > 3:
        assert 0 < int((b1[1] >= 0).sum()) < o.shape[0]
    for x, y, z in zip(joint, b1, plain[:5]):
        assert torch.equal(x, y)
        assert torch.equal(y, z.to(y.dtype))
    assert plain[5] == (0, 0)
    assert wide_bvh.traverse_joint_cuda.counters[cuda_device].tolist() == [0, 0]


@pytest.mark.gpu
def test_wide_megakernel_matches_plain(cuda_device):
    desc = material_room(8)
    W, H, spp = 64, 32, 2
    cs = compile_scene(desc, "cpu")
    icfg = {"kind": "path", "max_depth": 5, "rr_threshold": 1.0, "light_strategy": "power"}
    consts = megakernel_wide.extract_wide_consts(
        cs, make_camera(desc.camera, desc.film, "cpu"), icfg, {"kind": "zerotwosequence", "spp": spp},
        {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")},
        megakernel_wide.DEFAULT_MAX_TRIS)
    idx = torch.arange(W * H, device=cuda_device)
    lanes = (idx % W, idx // W, idx)
    before = megakernel_wide.wide_megakernel_cuda.launches
    blob = megakernel_wide.pack_wide_consts(consts).to(cuda_device)
    L, w, nv = (x.cpu().numpy() for x in megakernel_wide.wide_megakernel_cuda(
        blob, megakernel_wide.kernel_mode(consts), cs.arrays.to(cuda_device), *lanes, 0, spp, 7))
    torch.cuda.synchronize()
    assert megakernel_wide.wide_megakernel_cuda.launches == before + 1
    assert megakernel_wide.wide_megakernel_cuda.counters[cuda_device].tolist() == [0, 0]
    assert all(p > 0 for p in megakernel_wide.wide_megakernel_cuda.pops[cuda_device].tolist())
    L_p, w_p, nv_p = (x.numpy() for x in megakernel_wide.wide_megakernel_plain(
        consts, cs.arrays, *(x.cpu() for x in lanes), 0, spp, 7))
    assert L_p.mean() > 1e-3
    assert np.allclose(w, w_p)
    assert abs(float(nv.sum()) - float(nv_p.sum())) <= 6
    diff = np.abs(L - L_p)
    assert float((diff / (np.abs(L_p) + 1e-2)).max()) < 2e-2
    assert float(diff.mean()) < 1e-4


_MATERIAL_ROOM = {}


def _material_room_consts():
    """material_room compiled on the host once, with its B4 constants."""
    if not _MATERIAL_ROOM:
        desc = material_room()
        cs = compile_scene(desc, "cpu")
        icfg = {"kind": "path", "max_depth": desc.integrator.max_depth,
                "rr_threshold": desc.integrator.rr_threshold, "light_strategy": desc.integrator.light_strategy}
        consts = megakernel_wide.extract_wide_consts(
            cs, make_camera(desc.camera, desc.film, "cpu"), icfg,
            {"kind": desc.sampler.kind, "spp": desc.sampler.pixel_samples},
            {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")},
            megakernel_wide.DEFAULT_MAX_TRIS)
        _MATERIAL_ROOM.update(cs=cs, consts=consts, W=desc.film.x_resolution, H=desc.film.y_resolution)
    return _MATERIAL_ROOM


@pytest.mark.gpu
@pytest.mark.parametrize("spp", [1, 3])
@pytest.mark.parametrize("n_lanes", [37, 1000])
def test_wide_megakernel_pixel_queue(cuda_device, n_lanes, spp):
    """B4's persistent grid on lane counts that are not a multiple of its
    block and smaller than its slots: every lane is served exactly once
    (weight == n_samples), no stack overflow or iteration cap, and the
    image is the twin's within chip_smoke phase 11's tolerance."""
    room = _material_room_consts()
    cs, consts, W, H = room["cs"], room["consts"], room["W"], room["H"]
    pids = torch.as_tensor(np.random.RandomState(n_lanes + spp).choice(W * H, n_lanes, replace=False))
    lanes = (pids % W, pids // W, pids)
    counters = megakernel_wide.wide_megakernel_cuda.counters.get(cuda_device)
    if counters is not None:
        counters.zero_()
    blob = megakernel_wide.pack_wide_consts(consts).to(cuda_device)
    L, w, nv = (x.cpu() for x in megakernel_wide.wide_megakernel_cuda(
        blob, megakernel_wide.kernel_mode(consts), cs.arrays.to(cuda_device), *(x.to(cuda_device) for x in lanes),
        0, spp, 3))
    torch.cuda.synchronize()
    assert torch.equal(w, torch.full((n_lanes,), float(spp)))
    assert megakernel_wide.wide_megakernel_cuda.counters[cuda_device].tolist() == [0, 0]
    L_p, w_p, nv_p = megakernel_wide.wide_megakernel_plain(consts, cs.arrays, *lanes, 0, spp, 3)
    assert torch.equal(w, w_p)
    assert L_p.mean().item() > 0
    assert abs(float(nv.double().sum()) - float(nv_p.double().sum())) <= 6
    diff = (L - L_p).abs()
    assert (diff / (L_p.abs() + 1e-2)).max().item() < 2e-2
    assert diff.mean().item() < 1e-4


_WIDE_CASES = {}


def _wide_case(scene, sampler, filt):
    """sky_meshes (the attribute table and a constant sky: the extended
    instantiations) or material_room (flat, no sky) under a sampler and
    filter, compiled on the host once, with its B4 constants; the halton
    and sobol film tables are the full film's."""
    key = (scene, sampler, filt)
    if key not in _WIDE_CASES:
        desc = sky_meshes() if scene == "sky" else material_room()
        W, H, spp = desc.film.x_resolution, desc.film.y_resolution, 3
        cs = compile_scene(desc, "cpu")
        scfg = {"kind": sampler, "spp": spp}
        if sampler == "halton":
            scfg["halton"] = halton_tables(W, H, "cpu")
        if sampler == "sobol":
            scfg["sobol"] = sobol_tables(W, H, spp)
        params = dict(GAUSSIAN_DEFAULTS) if filt == "gaussian" else {"xwidth": 1.5} if filt == "triangle" else {}
        icfg = {"kind": "path", "max_depth": 5, "rr_threshold": 1.0, "light_strategy": "power"}
        consts = megakernel_wide.extract_wide_consts(
            cs, make_camera(desc.camera, desc.film, "cpu"), icfg, scfg,
            {"filter": filt, "filter_params": params, "max_sample_luminance": float("inf")},
            megakernel_wide.DEFAULT_MAX_TRIS)
        assert consts is not None
        _WIDE_CASES[key] = (cs, consts, W, H, spp)
    return _WIDE_CASES[key]


@pytest.mark.gpu
@pytest.mark.parametrize("n_lanes", [37, 1000])
@pytest.mark.parametrize("scene,sampler,filt", [
    ("sky", "halton", "gaussian"), ("sky", "sobol", "triangle"), ("sky", "maxmindist", "box"),
    ("room", "halton", "box"), ("room", "sobol", "box"), ("room", "maxmindist", "box")])
def test_wide_megakernel_samplers_match_plain(cuda_device, scene, sampler, filt, n_lanes):
    """B4 under the halton, sobol and maxmindist samplers, on sky_meshes
    (the extended instantiations: gaussian or triangle filter, attribute
    rows, constant sky) and on material_room (flat, no sky): every lane is
    served once, no stack overflow or iteration cap, and the image is the
    twin's within chip_smoke phase 11's tolerance."""
    cs, consts, W, H, spp = _wide_case(scene, sampler, filt)
    assert (megakernel_wide.kernel_mode(consts) >= 2 * megakernel_wide.N_SAMPLER_IDS) == (scene == "sky")
    pids = torch.as_tensor(np.random.RandomState(n_lanes).choice(W * H, n_lanes, replace=False))
    lanes = (pids % W, pids // W, pids)
    counters = megakernel_wide.wide_megakernel_cuda.counters.get(cuda_device)
    if counters is not None:
        counters.zero_()
    before = megakernel_wide.wide_megakernel_cuda.launches
    blob = megakernel_wide.pack_wide_consts(consts).to(cuda_device)
    L, w, nv = (x.cpu() for x in megakernel_wide.wide_megakernel_cuda(
        blob, megakernel_wide.kernel_mode(consts), cs.arrays.to(cuda_device), *(x.to(cuda_device) for x in lanes),
        0, spp, 5, megakernel_wide.sampler_table(consts, cuda_device)))
    torch.cuda.synchronize()
    assert megakernel_wide.wide_megakernel_cuda.launches == before + 1
    assert torch.equal(w, torch.full((n_lanes,), float(spp)))
    assert megakernel_wide.wide_megakernel_cuda.counters[cuda_device].tolist() == [0, 0]
    L_p, w_p, nv_p = megakernel_wide.wide_megakernel_plain(consts, cs.arrays, *lanes, 0, spp, 5)
    assert torch.equal(w, w_p)
    assert L_p.mean().item() > 0
    assert abs(float(nv.double().sum()) - float(nv_p.double().sum())) <= 6
    diff = (L - L_p).abs()
    assert (diff / (L_p.abs() + 1e-2)).max().item() < 2e-2
    assert diff.mean().item() < 1e-4


@pytest.mark.gpu
def test_cli_renders_on_the_card(cuda_device, tmp_path):
    """python -m pbrt_tpu_torch's main on the card: material_room(8) written
    as a .pbrt file with no Sampler directive (halton) and the gaussian
    filter, at 32x16, 2 spp, rendered with the default device through B1,
    against --device cpu with chip_smoke.py's rule."""
    from pbrt_tpu_torch import main as cli
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.core.imageio import read_image

    desc = material_room(8)
    desc.film.x_resolution, desc.film.y_resolution = 32, 16
    desc.film.filter_name = "gaussian"
    path = str(tmp_path / "room.pbrt")
    scenes.write_pbrt(desc, path, scenes.ROOM_LOOK_AT, sampler=False)
    before = wide_bvh.traverse_cuda.launches
    assert cli.main([path, "-o", str(tmp_path / "g.pfm"), "--spp", "2", "--quiet"]) == 0
    assert render.render_compiled.last_timing["tier"] == "torch-wavefront/cuda-wide"
    assert wide_bvh.traverse_cuda.launches > before
    assert cli.main([path, "-o", str(tmp_path / "c.pfm"), "--spp", "2", "--quiet", "--device", "cpu"]) == 0
    img_g, img_c = read_image(str(tmp_path / "g.pfm")), read_image(str(tmp_path / "c.pfm"))
    assert np.abs(img_g - img_c).sum() / np.abs(img_c).sum() < 1e-3
    assert np.isclose(img_g, img_c, rtol=1e-2, atol=1e-4).all(axis=-1).mean() >= 0.99


def _sphere_room_consts(W, H, spp):
    """scenes.sphere_room(8) at W x H on the host (seven full spheres, a
    sphere lamp among them, beside the triangles) with its B4 constants."""
    from pbrt_tpu_torch.scenes import sphere_room

    desc = sphere_room(8)
    desc.film.x_resolution, desc.film.y_resolution = W, H
    cs = compile_scene(desc, "cpu")
    consts = megakernel_wide.extract_wide_consts(
        cs, make_camera(desc.camera, desc.film, "cpu"),
        {"kind": "path", "max_depth": 5, "rr_threshold": 1.0, "light_strategy": "power"},
        {"kind": "zerotwosequence", "spp": spp},
        {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")}, megakernel_wide.DEFAULT_MAX_TRIS)
    return cs, consts


@pytest.mark.gpu
def test_wide_megakernel_spheres_match_plain(cuda_device):
    """B4's sphere instantiation (ext 2) on sphere_room(8) at 64x32, 2 spp:
    the spheres merged against the walk's winner, NEE toward the sphere lamp
    by its cone, against its twin at chip_smoke phase 11's tolerance."""
    W, H, spp = 64, 32, 2
    cs, consts = _sphere_room_consts(W, H, spp)
    mode = megakernel_wide.kernel_mode(consts)
    assert len(consts["spheres"]) == 7 and mode >= 4 * megakernel_wide.N_SAMPLER_IDS
    idx = torch.arange(W * H)
    lanes = (idx % W, idx // W, idx)
    blob = megakernel_wide.pack_wide_consts(consts).to(cuda_device)
    L, w, nv = (x.cpu() for x in megakernel_wide.wide_megakernel_cuda(
        blob, mode, cs.arrays.to(cuda_device), *(x.to(cuda_device) for x in lanes), 0, spp, 5))
    assert megakernel_wide.wide_megakernel_cuda.counters[cuda_device].tolist() == [0, 0]
    L_p, w_p, nv_p = megakernel_wide.wide_megakernel_plain(consts, cs.arrays, *lanes, 0, spp, 5)
    assert torch.equal(w, w_p) and L_p.mean().item() > 0
    assert abs(float(nv.double().sum()) - float(nv_p.double().sum())) <= 6
    diff = (L - L_p).abs()
    assert (diff / (L_p.abs() + 1e-2)).max().item() < 2e-2
    assert diff.mean().item() < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_mixed_query_matches_plain(cuda_device, any_hit):
    """The mixed query (B1 over the triangle subset's tables, the spheres
    tested beside it) against its twin (the plain walk and the same sphere
    merge) on sphere_room(8): bit for bit."""
    from pbrt_tpu_torch.device import intersect

    cs, _consts = _sphere_room_consts(32, 16, 1)
    sa = cs.arrays.to(cuda_device)
    o, d, t_max = _random_rays(cuda_device)
    query = intersect.intersect_p if any_hit else intersect.intersect
    before = wide_bvh.traverse_cuda.launches
    k = query(sa, cs.static, o, d, t_max, sort_rays=True)
    p = query(sa, cs.static, o, d, t_max, sort_rays=True, plain=True)
    assert wide_bvh.traverse_cuda.launches == before + 1
    if any_hit:
        assert torch.equal(k, p) and 0 < int(k.sum()) < o.shape[0]
    else:
        assert all(torch.equal(k[key], p[key]) for key in ("t", "prim", "b1", "b2"))
        assert (cs.static.n_spheres and (cs.arrays.prim_kind.to(cuda_device)[k["prim"].clamp(min=0)] == 1).any())


@pytest.mark.gpu
def test_megakernel_glossy_uber_matches_plain(cuda_device):
    """B3 on the spheres gallery with its plastic sphere a glossy uber one
    (Kd and Ks: baked as the Lambert + GGX class) at 64x32, 2 spp."""
    from pbrt_tpu_torch.scene.host import HostMaterial

    W, H, spp = 64, 32, 2
    desc = spheres_gallery()
    desc.film.x_resolution, desc.film.y_resolution = W, H
    for prim in desc.primitives:
        if prim.material.kind == "plastic":
            prim.material = HostMaterial(kind="uber", params=dict(prim.material.params))
    cs = compile_scene(desc, "cpu")
    assert 6 in cs.static.mat_kinds_present  # MAT_UBER
    icfg = {"kind": "path", "max_depth": 5, "rr_threshold": 1.0, "strategy": "one", "light_strategy": "power"}
    consts = megakernel.extract_consts(cs, make_camera(desc.camera, desc.film, "cpu"), icfg,
                                       {"kind": "zerotwosequence", "spp": spp},
                                       {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")})
    assert consts is not None
    idx = torch.arange(W * H)
    _brute_against_plain(cuda_device, consts, (idx % W, idx // W, idx), spp, 7)


@pytest.mark.gpu
@pytest.mark.parametrize("textured", [False, True])
def test_zoo_room_wavefront_cuda_matches_cpu(cuda_device, textured, tmp_path):
    """zoo_room(4) (substrate, disney, a mix, a fourier box, translucent,
    hair; with textured=True the mix amount and the substrate's Kd
    textured) through the wavefront on the card against the CPU. The mix's
    per-hit choice hashes the hit point's float bits, which differ by ulps
    between the devices, so paths that meet the mix may part: with the
    mix's two sub-rows made one (chip_smoke._same_sub_rows) the images meet
    chip_smoke.py's rule; as built, their means agree within 1%."""
    import chip_smoke
    from pbrt_tpu_torch.scenes import zoo_room

    desc = zoo_room(4, textured=textured, table_dir=str(tmp_path))
    desc.film.x_resolution, desc.film.y_resolution = 32, 16
    desc.sampler.pixel_samples = 2
    cs = compile_scene(desc, "cpu")
    one = chip_smoke._same_sub_rows(cs)
    img_c = render.render_compiled(one, seed=1)
    img_g = render.render_compiled(one.to(cuda_device), seed=1)
    assert render.render_compiled.last_timing["tier"] == "torch-wavefront/cuda-wide"
    assert np.abs(img_g - img_c).sum() / np.abs(img_c).sum() < 1e-3
    assert np.isclose(img_g, img_c, rtol=1e-2, atol=1e-4).all(axis=-1).mean() >= 0.99
    built_c = render.render_compiled(cs, seed=1)
    built_g = render.render_compiled(cs.to(cuda_device), seed=1)
    assert abs(built_g.mean() / built_c.mean() - 1.0) < 0.01


@pytest.mark.gpu
def test_fourier_and_hair_lobes_cuda_match_cpu(cuda_device, tmp_path):
    """device/fourier.py and device/hair.py on the card against the CPU on
    the same 4,096 lanes: the card's sin, cos, exp and log differ from the
    CPU's by ulps, so f and pdf agree within 1e-4 of their peak (the
    Fourier series cancels away from its peak, tests/test_torch_fourier.py)
    and sampled directions within 1e-3."""
    from pbrt_tpu_torch.core.fourierbsdf import read_fourier_table, write_rough_conductor_table
    from pbrt_tpu_torch.device import fourier, hair
    from pbrt_tpu_torch.scene.builder import _stack_fourier_tables

    path = str(tmp_path / "rc.bsdf")
    write_rough_conductor_table(path, alpha=0.3, nmu=12)
    ft = {k: torch.as_tensor(v) for k, v in _stack_fourier_tables([read_fourier_table(path)]).items()}
    rs = np.random.RandomState(8)
    n = 4096
    wo, wi = (torch.as_tensor(v / np.linalg.norm(v, axis=1, keepdims=True), dtype=torch.float32)
              for v in (rs.normal(size=(n, 3)), rs.normal(size=(n, 3))))
    u = [torch.as_tensor(rs.uniform(size=n), dtype=torch.float32) for _ in range(2)]
    data = torch.zeros((n, 14))
    data[:, 0:3] = torch.as_tensor(rs.uniform(0.1, 2.0, (n, 3)))
    data[:, 3] = 1.55
    data[:, 9] = torch.as_tensor(rs.uniform(0.1, 0.6, n))
    data[:, 10] = torch.as_tensor(rs.uniform(0.1, 0.6, n))
    data[:, 12] = 2.0
    data[:, 13] = torch.as_tensor(rs.uniform(-1, 1, n))
    tid = torch.zeros(n, dtype=torch.int64)

    def on(dev, fn, *args):
        return fn(*(a.to(dev) if torch.is_tensor(a) else {k: v.to(dev) for k, v in a.items()} for a in args))

    def peak_close(a, b):
        a, b = a.cpu().numpy(), b.numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())

    for fn, args in ((fourier.fourier_f, (ft, tid, wo, wi)), (fourier.fourier_pdf, (ft, tid, wo, wi)),
                     (hair.hair_f, (data, wo, wi)), (hair.hair_pdf, (data, wo, wi))):
        peak_close(on(cuda_device, fn, *args), on("cpu", fn, *args))
    s_g = on(cuda_device, fourier.fourier_sample, ft, tid, wo, *u)
    s_c = on("cpu", fourier.fourier_sample, ft, tid, wo, *u)
    valid = s_c["valid"] & s_g["valid"].cpu()
    assert valid.float().mean() > 0.4 and (s_g["valid"].cpu() != s_c["valid"]).float().mean() < 1e-3
    np.testing.assert_allclose(s_g["wi"].cpu()[valid].numpy(), s_c["wi"][valid].numpy(), atol=1e-3)
    h_g = on(cuda_device, hair.hair_sample, data, wo, *u)["wi"].cpu().numpy()
    np.testing.assert_allclose(h_g, on("cpu", hair.hair_sample, data, wo, *u)["wi"].numpy(), atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("kd", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_walk_matches_plain(cuda_device, kd, any_hit):
    """The BVH walk (quadric_room with instances) and the kd walk (its kd
    variant) against their plain twins on the card on random rays: the
    same (t, prim, b1, b2, pops) bit for bit (the same arithmetic without
    fused multiply-adds on both sides, the same walk order)."""
    from pbrt_tpu_torch.device import bvh_walk

    cs = small_quadric_room(kd).to(cuda_device)
    o, d, t_max = (torch.as_tensor(x, dtype=torch.float32, device=cuda_device).contiguous()
                   for x in _random_rays(cuda_device))
    kernel = bvh_walk.kd_walk_cuda if kd else bvh_walk.bvh_walk_cuda
    plain = bvh_walk.kd_walk_plain if kd else bvh_walk.walk_plain
    res_k = kernel(cs.arrays, cs.static, o, d, t_max, any_hit)
    res_p = plain(cs.arrays, cs.static, o, d, t_max, any_hit)
    torch.cuda.synchronize()
    for a, b in zip(res_k, res_p[:5]):
        assert torch.equal(a, b.to(a.dtype))
    assert (res_k[1] >= 0).any() and kernel.counters[cuda_device].tolist() == [0, 0] and res_p[5] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_kd_walk_fills_its_stack(cuda_device, any_hit):
    """The kd walk on a tree 4 levels short of its stack (deep_kd_room):
    the same (t, prim, b1, b2, pops) as its twin bit for bit, no push
    dropped, and the rays that cross every split visit at least as many
    nodes as the tree is deep."""
    from pbrt_tpu_torch.device import bvh_walk

    depth = bvh_walk.KD_STACK - 4
    cs, o, d, t_max = deep_kd_room(depth)
    cs = cs.to(cuda_device)
    o, d, t_max = (torch.as_tensor(x, device=cuda_device) for x in (o, d, t_max))
    res_k = bvh_walk.kd_walk_cuda(cs.arrays, cs.static, o, d, t_max, any_hit)
    res_p = bvh_walk.kd_walk_plain(cs.arrays, cs.static, o, d, t_max, any_hit)
    torch.cuda.synchronize()
    for a, b in zip(res_k, res_p[:5]):
        assert torch.equal(a, b.to(a.dtype))
    assert bvh_walk.kd_walk_cuda.counters[cuda_device].tolist() == [0, 0] and res_p[5] == 0
    assert int(res_k[4][:384].min()) >= depth and (res_k[1] >= 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("kd", [False, True])
def test_quadric_room_wavefront_cuda_matches_cpu(cuda_device, kd):
    """quadric_room (instances, every quadric kind, the alpha panel,
    goniometric and projection lights) through the walk on the card against
    the CPU, and its kd variant under the orthographic camera: the route
    labels; without the hits of cones, paraboloids and hyperboloids
    (chip_smoke._without_raw_quadrics: the quadrics whose hit points are
    not re-projected, where the devices' ulps can part a path) images
    within chip_smoke.py's crop rule, and as built 99% of the pixels within
    rtol 1e-2 (chip_smoke.py phase 35)."""
    import chip_smoke

    cs = small_quadric_room(kd)
    one = chip_smoke._without_raw_quadrics(cs)
    img_c = render.render_compiled(one, seed=1)
    img_g = render.render_compiled(chip_smoke._without_raw_quadrics(cs.to(cuda_device)), seed=1)
    assert render.render_compiled.last_timing["tier"] == f"torch-wavefront/cuda-{'kdtree' if kd else 'bvh'}"
    assert np.abs(img_g - img_c).sum() / np.abs(img_c).sum() < 1e-3
    assert np.isclose(img_g, img_c, rtol=1e-2, atol=1e-4).all(axis=-1).mean() >= 0.99
    built_c = render.render_compiled(cs, seed=1)
    built_g = render.render_compiled(cs.to(cuda_device), seed=1)
    assert np.isclose(built_g, built_c, rtol=1e-2, atol=1e-4).all(axis=-1).mean() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["delta_track", "ratio_track"])
def test_medium_track_matches_plain(cuda_device, entry):
    """csrc/medium_track.cu against its twin on rays through the fog room's
    smoke box (torch_test_scenes.track_rays, a 16^3 grid): the same collisions
    and steps on every ray, and t (delta) or the transmittance (ratio)
    within rtol 1e-5 (the twin's log on the card is the kernel's logf)."""
    from pbrt_tpu_torch.device import medium_track
    from pbrt_tpu_torch.scenes import fog_room

    cs = compile_scene(fog_room(8, 16), "cpu").to(cuda_device)
    rays = track_rays(cs, 20_000)
    kernel, plain = getattr(medium_track, entry + "_cuda"), getattr(medium_track, entry + "_plain")
    res_k = kernel(cs.arrays, *rays)
    res_p = plain(cs.arrays, cs.static.media_kinds, *rays)
    assert torch.equal(res_k[-1], res_p[-1]) and int(res_k[-1].max()) > 1
    if entry == "delta_track":
        assert torch.equal(res_k[1], res_p[1]) and 0 < int(res_k[1].sum()) < 20_000
    torch.testing.assert_close(res_k[0], res_p[0], rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["delta_track", "ratio_track"])
def test_medium_track_mixed_launch_matches_plain(cuda_device, entry):
    """csrc/medium_track.cu on one launch whose rays lie, in a shuffled
    order, in the grid medium (through the smoke box), in the homogeneous
    fog and in no medium, as the wave's launches do: every output equal to
    its twin's bit for bit, the rays outside the grid medium written
    without a step (the persistent loop's skip path)."""
    from pbrt_tpu_torch.device import medium_track
    from pbrt_tpu_torch.scenes import fog_room

    cs = compile_scene(fog_room(8, 16), "cpu").to(cuda_device)
    med, o, d, t_end, key = track_rays(cs, 30_000)
    kinds = cs.static.media_kinds
    med = med.clone()
    med[10_000:20_000] = kinds.index("homogeneous")
    med[20_000:] = -1
    perm = torch.as_tensor(np.random.RandomState(5).permutation(30_000), device=cuda_device)
    rays = [x[perm].contiguous() for x in (med, o, d, t_end, key)]
    kernel, plain = getattr(medium_track, entry + "_cuda"), getattr(medium_track, entry + "_plain")
    res_k = kernel(cs.arrays, *rays)
    res_p = plain(cs.arrays, kinds, *rays)
    torch.cuda.synchronize()
    assert torch.equal(res_k[0].view(torch.int32), res_p[0].view(torch.int32))
    for a, b in zip(res_k[1:], res_p[1:]):
        assert torch.equal(a, b)
    grid = rays[0] == kinds.index("heterogeneous")
    assert int(res_k[-1][~grid].abs().sum()) == 0 and int(res_k[-1][grid].min()) >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["fog", "sss", "whitted"])
def test_wave_cuda_matches_cpu(cuda_device, scene):
    """The per-sample wave on the card against the CPU: the small fog room
    (volpath, the medium_track kernel), the small sss room (the tabulated
    BSSRDF) and the mesh room under whitted, 24x16 at 2 spp, within
    chip_smoke.py's crop rule; route torch-wave/wide."""
    from pbrt_tpu_torch.scenes import fog_room, sss_room

    desc = {"fog": lambda: fog_room(8, 16), "sss": lambda: sss_room(8, 16, 8), "whitted": lambda: mesh_room(8)}[scene]()
    desc.film.x_resolution, desc.film.y_resolution = 24, 16
    desc.sampler.pixel_samples = 2
    if scene == "whitted":
        desc.integrator.kind = "whitted"
    cs = compile_scene(desc, "cpu")
    img_c = render.render_compiled(cs, seed=1)
    img_g = render.render_compiled(cs.to(cuda_device), seed=1)
    assert render.render_compiled.last_timing["tier"] == "torch-wave/wide"
    assert img_c.mean() > 0 and np.abs(img_g - img_c).sum() / np.abs(img_c).sum() < 1e-3
    assert np.isclose(img_g, img_c, rtol=1e-2, atol=1e-4).all(axis=-1).mean() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("rotate", [True, False])
@pytest.mark.parametrize("kd", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_motion_walk_matches_plain(cuda_device, rotate, kd, any_hit):
    """The walks' motion instantiations (csrc/bvh_walk.cu MOTION 2: the exact
    animated transform, rotate; MOTION 1: the keyframe rows) against their
    twins on the small motion room (and its kd variant) on random rays at
    random shutter fractions: t, prim, b1, b2 and pops bit for bit, on a
    hit of the moving sphere too, where b1, b2 are its object-space x, y
    (csrc/quadric.cuh; the twin sums |p|^2 in the kernel's order), and so
    the static walk on the same rays (chip_smoke.py phase 43)."""
    from pbrt_tpu_torch.device import bvh_walk
    from pbrt_tpu_torch.scenes import motion_room

    desc = motion_room(6, rotate=rotate, sphere_res=6)
    desc.accelerator = "kdtree" if kd else "bvh"
    cs = compile_scene(desc, "cpu").to(cuda_device)
    o, d, t_max = (x.contiguous() for x in _random_rays(cuda_device))
    tm = torch.as_tensor(np.random.RandomState(8).uniform(0, 1, o.shape[0]), dtype=torch.float32,
                         device=cuda_device)
    kernel = bvh_walk.kd_walk_motion_cuda if kd else bvh_walk.bvh_walk_motion_cuda
    plain = bvh_walk.kd_walk_plain if kd else bvh_walk.walk_plain
    res_k = kernel(cs.arrays, cs.static, o, d, t_max, any_hit, time=tm)
    res_p = plain(cs.arrays, cs.static, o, d, t_max, any_hit, time=tm)
    torch.cuda.synchronize()
    quad = (res_k[1] >= 0) & (cs.arrays.prim_kind[res_k[1].long().clamp(min=0)] != 0)
    for a, b in zip(res_k, res_p[:5]):
        assert torch.equal(a, b.to(a.dtype))
    assert (res_k[1] >= 0).any() and kernel.counters[cuda_device].tolist() == [0, 0] and res_p[5] == 0
    assert any_hit or quad.any()
    static = (bvh_walk.kd_walk_cuda if kd else bvh_walk.bvh_walk_cuda)(cs.arrays, cs.static, o, d, t_max, any_hit)
    static_p = (bvh_walk.kd_walk_plain if kd else bvh_walk.walk_plain)(cs.arrays, cs.static, o, d, t_max, any_hit)
    assert all(torch.equal(a, b.to(a.dtype)) for a, b in zip(static, static_p[:5]))
    assert not torch.equal(static[0], res_k[0])  # the time moves the hits


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["motion", "motion_keyframes", "realistic", "bdpt"])
def test_motion_realistic_bdpt_cuda_matches_cpu(cuda_device, scene, tmp_path):
    """The small motion room (the time-aware walk; rotate=False: the
    keyframe tables), the mesh room under the realistic camera and under
    BDPT, 24x16 at 2 spp, on the card against the CPU within chip_smoke.py's
    crop rule; the route labels."""
    from pbrt_tpu_torch.scenes import motion_room, realistic_mesh_room

    make = {"motion": lambda: motion_room(8, sphere_res=8), "motion_keyframes": lambda: motion_room(8, rotate=False),
            "realistic": lambda: realistic_mesh_room(8, lens_dir=str(tmp_path)), "bdpt": lambda: mesh_room(8)}
    desc = make[scene]()
    desc.film.x_resolution, desc.film.y_resolution = 24, 16
    desc.sampler.pixel_samples = 2
    if scene == "bdpt":
        desc.integrator.kind, desc.integrator.max_depth = "bdpt", 3
    cs = compile_scene(desc, "cpu")
    img_c = render.render_compiled(cs, seed=1)
    img_g = render.render_compiled(cs.to(cuda_device), seed=1)
    tier = {"motion": "torch-wave/bvh", "motion_keyframes": "torch-wave/bvh", "realistic": "torch-wave/wide",
            "bdpt": "torch-bdpt/wide"}[scene]
    assert render.render_compiled.last_timing["tier"] == tier
    assert img_c.mean() > 0 and np.abs(img_g - img_c).sum() / np.abs(img_c).sum() < 1e-3
    assert np.isclose(img_g, img_c, rtol=1e-2, atol=1e-4).all(axis=-1).mean() >= 0.99


def _small_host_loop(kind, device, **ic):
    """mesh_room(8) at 24x16 under mlt or sppm (compiled on the CPU, moved
    to `device`)."""
    import dataclasses

    desc = mesh_room(8)
    desc.film.x_resolution, desc.film.y_resolution = 24, 16
    desc.integrator = dataclasses.replace(desc.integrator, kind=kind, **ic)
    return compile_scene(desc, "cpu").to(device)


@pytest.mark.gpu
def test_mlt_block_cuda_matches_cpu(cuda_device):
    """One block of K = 8 MLT mutations of 256 chains (depth 2) on the card,
    run under torch.cuda.set_sync_debug_mode("error") (no host read between
    mutations), against the same block on the CPU: every accept decision
    equal, the rows within 1e-5 (the small step's log and cos differ by
    ulps between the devices), the block's film within chip_smoke.py's
    crop rule."""
    from pbrt_tpu_torch.device import bdpt, lights, mlt

    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        cs = _small_host_loop("mlt", dev, max_depth=2)
        sa, st = cs.arrays, cs.static
        ctx = bdpt._Ctx(sa, st)
        cam = make_camera(cs.description.camera, cs.description.film, dev)
        cdf = torch.cumsum(lights.compute_power(sa, st), 0)
        cdf = cdf / cdf[-1]
        u = torch.as_tensor(np.random.RandomState(4).rand(256, mlt.DIMS).astype(np.float32), device=dev)
        ids = torch.arange(256, device=dev)
        W, H = 24, 16
        cur = mlt._l_fn(sa, st, ctx, cam, cdf, u, 2, W, H)
        film = torch.zeros((W * H + 1, 3), dtype=torch.float64, device=dev)
        accepted = torch.zeros((), dtype=torch.int64, device=dev)
        trace = []
        mlt.mlt_block(sa, st, ctx, cam, cdf, 2, W, H, mlt.SIGMA, mlt.P_LARGE, ids, u, cur, 77, 0, 1, film,
                      accepted)  # a warm-up step: the kernel's build and first launch
        film.zero_()
        accepted.zero_()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            u_n, _cur = mlt.mlt_block(sa, st, ctx, cam, cdf, 2, W, H, mlt.SIGMA, mlt.P_LARGE, ids, u, cur, 77, 1, 8,
                                      film, accepted, trace)
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        out[dev.type] = (u_n.cpu(), torch.stack(trace).cpu(), film[:W * H].cpu().numpy(), int(accepted))
    (u_c, acc_c, f_c, n_c), (u_g, acc_g, f_g, n_g) = out["cpu"], out["cuda"]
    assert torch.equal(acc_g, acc_c) and n_g == n_c and 0 < n_c < 8 * 256
    torch.testing.assert_close(u_g, u_c, rtol=0, atol=1e-5)
    assert f_c.sum() > 0 and np.abs(f_g - f_c).sum() / np.abs(f_c).sum() < 1e-3
    assert np.isclose(f_g, f_c, rtol=1e-2, atol=1e-4).all(axis=-1).mean() >= 0.99


@pytest.mark.gpu
def test_sppm_deposit_cuda_matches_plain(cuda_device):
    """SPPM's deposit on the card against the same deposit on the CPU, on a
    fixed grid (one camera pass of the small room, radius 0.2) and fixed
    photon hits (the visible points moved by up to 0.1, with random
    directions and throughputs): the counts equal, phi within 1e-5 of its
    largest value (float64 adds in another order), the dropped count and
    the longest run equal."""
    from pbrt_tpu_torch.device import bdpt, sppm

    cs = _small_host_loop("sppm", "cpu", max_depth=3)
    sa, st = cs.arrays, cs.static
    ctx = bdpt._Ctx(sa, st)
    W, H = 24, 16
    ys, xs = np.mgrid[0:H, 0:W]
    px, py, pid = (torch.as_tensor(x.ravel().astype(np.int64)) for x in (xs, ys, ys * W + xs))
    cam = make_camera(cs.description.camera, cs.description.film, "cpu")
    _ld, vp = sppm._camera_pass(sa, st, ctx, cam, 3, 1, px, py, pid, 0, 1)
    radius = torch.full((W * H,), 0.2)
    grid_min = sa.world_center - sa.world_radius
    inv_cell = 1.0 / 0.4
    cells, vps = sppm._build_grid(vp, radius, grid_min, inv_cell)
    rs = np.random.RandomState(6)
    P = 4 * W * H
    src = rs.randint(0, W * H, P)
    p = vp["p"][src] + torch.as_tensor(rs.uniform(-0.1, 0.1, (P, 3)).astype(np.float32))
    wi = torch.as_tensor(rs.normal(size=(P, 3)).astype(np.float32))
    wi = wi / wi.norm(dim=1, keepdim=True)
    beta = torch.as_tensor(rs.uniform(0.1, 2.0, (P, 3)).astype(np.float32))
    alive = torch.as_tensor(rs.uniform(size=P) < 0.9) & vp["valid"][src]
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        phi = torch.zeros((W * H + 1, 3), dtype=torch.float64, device=dev)
        m = torch.zeros(W * H + 1, dtype=torch.float64, device=dev)
        stats = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in ("dropped", "max_run")}
        stats["pairs"] = 0
        to = {k: v.to(dev) for k, v in vp.items()}
        sppm._deposit(ctx if dev.type == "cpu" else bdpt._Ctx(sa.to(dev), st), to, (radius * radius).to(dev),
                      cells.to(dev), vps.to(dev), grid_min.to(dev), inv_cell, alive.to(dev), p.to(dev), wi.to(dev),
                      beta.to(dev), phi, m, stats)
        out[dev.type] = (phi.cpu().numpy(), m.cpu().numpy(), int(stats["dropped"]), int(stats["max_run"]),
                         stats["pairs"])
    (phi_c, m_c, dr_c, mr_c, n_c), (phi_g, m_g, dr_g, mr_g, n_g) = out["cpu"], out["cuda"]
    assert (dr_g, mr_g, n_g) == (dr_c, mr_c, n_c) and n_c > 1000
    np.testing.assert_array_equal(m_g, m_c)
    assert phi_c.max() > 0
    np.testing.assert_allclose(phi_g, phi_c, rtol=0, atol=1e-5 * phi_c.max())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mlt", "sppm"])
def test_mlt_sppm_cuda_matches_cpu(cuda_device, kind):
    """MLT and SPPM renders of the small room on the card against the CPU
    within chip_smoke.py's crop rule; the route labels."""
    ic = (dict(max_depth=2, n_chains=64, mutations_per_pixel=4, n_bootstrap=2048) if kind == "mlt"
          else dict(max_depth=3, num_iterations=2, photons_per_iteration=4096, initial_radius=0.3))
    cs = _small_host_loop(kind, "cpu", **ic)
    img_c = render.render_compiled(cs, seed=1)
    img_g = render.render_compiled(cs.to(cuda_device), seed=1)
    assert render.render_compiled.last_timing["tier"] == f"torch-{kind}/wide"
    assert img_c.mean() > 0 and np.abs(img_g - img_c).sum() / np.abs(img_c).sum() < 1e-3
    assert np.isclose(img_g, img_c, rtol=1e-2, atol=1e-4).all(axis=-1).mean() >= 0.99
