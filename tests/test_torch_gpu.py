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
(tests/test_megakernel.py, tests/test_megakernel_wide.py). B4's persistent
grid is also run on fewer lanes than it has path slots, to show that its
pixel counter serves every lane exactly once.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch import render
from pbrt_tpu_torch.device import megakernel, megakernel_wide, wide_bvh
from pbrt_tpu_torch.device.camera import make_camera
from pbrt_tpu_torch.scene.builder import compile_scene
from pbrt_tpu_torch.scenes import material_room, mesh_room, spheres_gallery


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
@pytest.mark.parametrize("ikind", ["path", "directlighting"])
def test_megakernel_matches_plain(cuda_device, ikind):
    desc = spheres_gallery()
    W, H, spp = 64, 32, 2
    desc.film.x_resolution, desc.film.y_resolution = W, H
    desc.integrator.kind = ikind
    desc.integrator.strategy = "one"
    cs = compile_scene(desc, "cpu")
    icfg = {"kind": ikind, "max_depth": 5, "rr_threshold": 1.0, "strategy": "one", "light_strategy": "power"}
    consts = megakernel.extract_consts(cs, make_camera(desc.camera, desc.film, "cpu"), icfg,
                                       {"kind": "zerotwosequence", "spp": spp},
                                       {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")})
    idx = torch.arange(W * H, device=cuda_device)
    lanes = (idx % W, idx // W, idx)
    before = megakernel.megakernel_cuda.launches
    blob = megakernel.pack_consts(consts).to(cuda_device)
    L, w, nv = (x.cpu().numpy() for x in megakernel.megakernel_cuda(
        blob, megakernel.kernel_mode(consts), *lanes, 0, spp, 7))
    torch.cuda.synchronize()
    assert megakernel.megakernel_cuda.launches == before + 1
    L_p, w_p, nv_p = (x.cpu().numpy() for x in megakernel.megakernel_plain(consts, *(x.cpu() for x in lanes), 0, spp, 7))
    assert L_p.mean() > 1e-3
    assert np.allclose(w, w_p)
    assert abs(float(nv.sum()) - float(nv_p.sum())) <= 4
    diff = np.abs(L - L_p)
    assert float((diff / (np.abs(L_p) + 1e-2)).max()) < 2e-2
    assert float(diff.mean()) < 1e-4


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
