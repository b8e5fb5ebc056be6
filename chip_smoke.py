#!/usr/bin/env python3
"""Smoke test of pbrt_tpu_torch on one CUDA GPU: the quickest proof that the
port builds and runs its main path on the card.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases (one line each; any failure raises and the exit code is non-zero):
 1. device: requires CUDA (no CPU fallback), prints the card's name and
    power limit;
 2. build: nvcc-compiles every kernel source (csrc/wide_traverse.cu,
    wide_traverse_joint.cu, megakernel.cu, megakernel_wide.cu), one nvcc
    each, all started together; prints build seconds, the ptxas
    register/spill/shared-memory report of each and every variant's
    resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
 3. B1 kernel vs plain: compiles the 123,650-triangle mesh room on the host,
    then traces 500,000 camera rays, one cosine bounce from their hits and
    shadow rays to the panel light through the CUDA kernel and through its
    plain PyTorch twin, closest and any hit, on the same Hopper records.
    Requires t, prim/slot, b1, b2 and pops equal on every ray (FMA-free IEEE
    arithmetic and the same pop order on both sides) and the stack-overflow
    and iteration-cap counters 0. Prints per ray set the kernel's time
    (CUDA events), ns per pop, the share of its lanes holding a ray (pops /
    32 x its warps' loop iterations) and, from the same pops, the share one
    lane per ray in a fixed grid would have (the earlier B1's); times the
    plain twin on camera rays;
 4. mesh main path: render_compiled of the room at 1000x500, 16 spp, depth 5
    on cuda after a warm-up pass; checks the route label, traversal-kernel
    launches > 0 in that run, and a finite, non-black image; prints
    path_vertex_samples_per_sec (sum of path vertices / render wall time);
 5. same mesh image on both devices: a 64x32 crop at 4 spp on cuda (kernel)
    and on cpu (plain versions) with one seed must agree: sum|a-b| / sum|b|
    < 1e-3 and >= 99% of pixels within rtol 1e-2 (atol 1e-4);
 6. B3 kernel vs plain: the brute megakernel and its plain twin on the
    spheres gallery (8 prims, 3 delta lights) at 1000x500, 2 spp, with the
    reference megakernel's image tolerance (tests/test_megakernel.py):
    weights allclose, total path vertices within 4, per-pixel
    |dL| / (|L| + 1e-2) < 2e-2 and mean |dL| < 1e-4 (sin/cos/log and
    operation order may move a rare path by ulps); times both at the main
    path's 16 spp, the kernel with CUDA events, the plain twin by the host
    clock around one call ending in a synchronize; computes the kernel's
    float32 bound;
 7. gallery main path: render_compiled of the spheres gallery at 1000x500,
    16 spp, depth 5 on cuda after a warm-up pass; checks the route label
    torch-megakernel/cuda-brute, megakernel launches > 0 in that run, and a
    finite, non-black image; prints path_vertex_samples_per_sec;
 8. same gallery image on both devices: a 64x32 crop at 4 spp, held as in
    phase 5;
 9. B2 against B1: the six ray sets of phase 3 through the cooperative
    traversal kernel (4 lanes per ray); t, prim/slot, b1, b2 and pops must
    equal B1's, and so phase 3's plain results, on every ray (the largest
    |dt|, |db| against plain is B2's max_abs_err). Times B1 and B2 with CUDA
    events and prints the share of B2's lane groups holding a ray;
10. mesh main path with PBRT_TPU_JOINT=1: route torch-wavefront/cuda-wide-
    joint, joint launches > 0 and B1 launches 0 in that run, and the image
    of phase 4 (sum|a-b| / sum|b| < 1e-6; prints whether it is bit-equal);
11. B4 kernel vs plain: the wide megakernel and its plain twin on
    material_room (3,854 triangles) at 1000x500, 2 spp, with the reference
    wide megakernel's tolerance (tests/test_megakernel_wide.py): weights
    allclose, total path vertices within 6, per-pixel |dL| / (|L| + 1e-2) <
    2e-2 and mean |dL| < 1e-4; times the kernel at 16 spp with CUDA events
    and the twin by the host clock; computes the bound from the run's pops
    and path vertices; the stack-overflow and iteration-cap counters must
    stay 0, and the 16 spp render must trace the per-lane kernel's 29,659,505 path
    vertices;
12. material_room main path with PBRT_TPU_WIDEMEGA=1 at 1000x500, 16 spp,
    depth 5: route torch-megakernel/cuda-wide, one B4 launch, a finite,
    non-black image; prints path_vertex_samples_per_sec and the kernel's
    share of the render wall;
13. same material_room crop on both devices, held as in phase 5;
14. the mesh room through B4 (PBRT_TPU_WIDEMEGA=1,
    PBRT_TPU_WIDEMEGA_MAX_TRIS=200000) at 1000x500, 16 spp, beside phase 4's
    wavefront; the B4 kernel on the route's blob timed with CUDA events as
    in phase 11, beside the render wall, and the per-lane kernel's 31,724,525 path
    vertices required; then the 64x32,
    4 spp crop through B4 and through the wavefront, both on the card,
    held to the wide tolerance of phase 11.
Each main path runs with every launch count set to 0 just before it and
read just after; every switch a phase sets is restored after it. The second-to-last lines are the kernel report as JSON
and the card's nvidia-smi name and power limit; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

SEED = 0
CROP_BOUNDS = (468, 532, 234, 266)  # 64 x 32 pixels around the film centre
CROP_SPP = 4
COMPARE_SPP = 2  # B3 kernel vs plain
# path vertices of the 16 spp renders with SEED, as the earlier per-lane B4
# (one thread per pixel) traced them; the persistent B4 must trace the same paths
MATERIAL_ROOM_VERTICES = 29_659_505
MESH_ROOM_VERTICES = 31_724_525

# H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per unit of work, counted from the kernels' sources as
# a lower bound (one IEEE divide or square root counted as one operation):
B1_OPS_PER_POP = 8 * 20  # a pop tests at least 8 child boxes (~20 ops each)
B3_OPS_TRI, B3_OPS_SPH = 45, 65  # one watertight triangle / full-sphere test
B3_OPS_SHADE = 300  # BSDF sample + evaluation + NEE terms per path vertex


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps, by CUDA events after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 operations over the peak float32 rate."""
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _check_crop(label, cs_gpu, cs_cpu, desc):
    """Phases 5 and 8: the same crop rendered on cuda and on cpu."""
    import numpy as np

    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.scene.builder import CompiledScene

    desc_c = dataclasses.replace(
        desc, integrator=dataclasses.replace(desc.integrator, pixel_bounds=CROP_BOUNDS),
        sampler=dataclasses.replace(desc.sampler, pixel_samples=CROP_SPP))
    x0, x1, y0, y1 = CROP_BOUNDS
    img_g = R_.render_compiled(CompiledScene(cs_gpu.arrays, cs_gpu.static, desc_c), seed=SEED)[y0:y1, x0:x1]
    tier_g = R_.render_compiled.last_timing["tier"]
    img_c = R_.render_compiled(CompiledScene(cs_cpu.arrays, cs_cpu.static, desc_c), seed=SEED)[y0:y1, x0:x1]
    tier_c = R_.render_compiled.last_timing["tier"]
    rel = np.abs(img_g - img_c).sum() / max(np.abs(img_c).sum(), 1e-30)
    px_ok = np.isclose(img_g, img_c, rtol=1e-2, atol=1e-4).all(axis=-1).mean()
    print(f"[{label}] {x1 - x0}x{y1 - y0} {CROP_SPP}spp ({tier_g} vs {tier_c}): "
          f"sum|a-b|/sum|b| {rel:.3e}, pixels within rtol 1e-2 {px_ok:.4f}, means {img_g.mean():.5f} "
          f"{img_c.mean():.5f}", flush=True)
    if not (np.isfinite(img_g).all() and img_c.mean() > 0 and rel < 1e-3 and px_ok >= 0.99):
        raise AssertionError(f"cuda and cpu renders of the crop disagree ({label})")


def _reset_launches():
    from pbrt_tpu_torch.device import megakernel, megakernel_wide, wide_bvh

    for fn in (wide_bvh.traverse_cuda, wide_bvh.traverse_joint_cuda, megakernel.megakernel_cuda,
               megakernel_wide.wide_megakernel_cuda):
        fn.launches = 0


def _wide_tolerance(L, w, nv, L_r, w_r, nv_r):
    """The reference wide megakernel's tolerance (tests/test_megakernel_wide.py
    :190-198); returns (ok, a description of the comparison)."""
    import torch

    diff = (L - L_r).abs()
    rel = (diff / (L_r.abs() + 1e-2)).max().item()
    dnv = abs(nv.double().sum().item() - nv_r.double().sum().item())
    ok = torch.allclose(w, w_r) and dnv <= 6 and rel < 2e-2 and diff.mean().item() < 1e-4 and L_r.mean().item() > 0
    return ok, (f"weights equal {torch.equal(w, w_r)}, vertices {nv.double().sum().item():.0f} vs "
                f"{nv_r.double().sum().item():.0f}, max |dL|/(|L|+1e-2) {rel:.3e}, mean |dL| {diff.mean().item():.3e}, "
                f"max |dL| {diff.max().item():.3e}")


def _main_path(label, cs, expect_tier, kernel_fn):
    """Phases 4, 7, 10, 12 and 14: a warm-up pass, then one full render with
    every launch count set to 0 just before it; returns (timing, launches,
    image)."""
    import numpy as np

    from pbrt_tpu_torch import render as R_

    R_.render_compiled(cs, seed=SEED, spp=2)  # warm-up pass
    _reset_launches()
    img = R_.render_compiled(cs, seed=SEED)
    launches = kernel_fn.launches
    timing = R_.render_compiled.last_timing
    desc = cs.description
    if timing["tier"] != expect_tier:
        raise AssertionError(f"{label} took route {timing['tier']}")
    if launches <= 0:
        raise AssertionError(f"{label} made no launch of its kernel")
    if not (np.isfinite(img).all() and img.mean() > 0):
        raise AssertionError(f"{label} image is not finite and non-black")
    vps = timing["n_vertices"] / timing["wall_s"]
    print(f"[{label}] {desc.film.x_resolution}x{desc.film.y_resolution} {desc.sampler.pixel_samples}spp "
          f"depth {desc.integrator.max_depth} route {timing['tier']}: wall {timing['wall_s']:.4f}s, "
          f"{timing['n_vertices']:.0f} path vertices, path_vertex_samples_per_sec {vps:.1f}, "
          f"kernel launches {launches}, image mean {img.mean():.5f}", flush=True)
    return timing, launches, img


def _rays(cs):
    """(name, o, d, t_max) ray sets of the main path's shapes: camera rays,
    one cosine-hemisphere bounce from their hits, shadow rays to the panel."""
    import torch

    from pbrt_tpu_torch.device import rng
    from pbrt_tpu_torch.device.bsdf import LOBE_LAMBERT_R, bsdf_sample
    from pbrt_tpu_torch.device.camera import make_camera
    from pbrt_tpu_torch.device.integrator import RAY_EPS, _offset_ray, _to_local, _to_world
    from pbrt_tpu_torch.device.intersect import intersect
    from pbrt_tpu_torch.device.lights import sample_li
    from pbrt_tpu_torch.device.shading import surface_interaction
    from pbrt_tpu_torch.render import make_regen

    desc = cs.description
    dev = cs.arrays.device
    W, H = desc.film.x_resolution, desc.film.y_resolution
    idx = torch.arange(W * H, device=dev)
    cam = make_camera(desc.camera, desc.film, dev)
    regen = make_regen(cam, {"kind": desc.sampler.kind, "spp": desc.sampler.pixel_samples},
                       {"filter": "box", "filter_params": {}}, idx % W, idx // W, idx, SEED)
    o, d, _w = regen(torch.zeros_like(idx))
    inf = torch.full((W * H,), float("inf"), device=dev)
    hit = intersect(cs.arrays, cs.static, o, d, inf)
    si = surface_interaction(cs.arrays, hit, o, d)
    u = [rng.u32_to_float(rng.hash_combine(7, idx, k)) for k in range(3)]
    lobes = {"kind": torch.full_like(idx, LOBE_LAMBERT_R), "color": torch.ones_like(o)}
    bs = bsdf_sample(lobes, _to_local(si, si["wo"]), u[0], u[1], u[2])
    wi = _to_world(si, bs["wi"])
    o_b = _offset_ray(si["p"], si["ng"], wi, si["p_err"])
    ls = sample_li(cs.arrays, cs.static, idx % cs.static.n_lights, si["p"], u[1], u[2])
    o_s = _offset_ray(si["p"], si["ng"], ls["wi"], si["p_err"])
    t_s = ls["dist"] * (1.0 - 2.0 * RAY_EPS)
    return [("camera", o, d, inf), ("bounce", o_b.contiguous(), wi.contiguous(), inf),
            ("shadow", o_s.contiguous(), ls["wi"].contiguous(), t_s.contiguous())]


def _lane_share(kernel, workers, sa, o, d, t_max, any_hit):
    """One launch of a traversal wrapper; returns (the share of its warps'
    workers (lanes, or lane groups) holding a ray over its loop iterations,
    the launch's results)."""
    import torch

    iters = kernel.iterations.get(torch.device("cuda", 0))
    if iters is not None:
        iters.zero_()
    res = kernel(sa, o, d, t_max, any_hit)
    n_iter = kernel.iterations[torch.device("cuda", 0)].item()
    return res[4].double().sum().item() / max(workers * n_iter, 1), res


def _compare(name, any_hit, res_k, res_p):
    """Kernel vs plain outputs of one ray set; returns max |dt| on agreeing hits."""
    import torch

    t_k, i_k, b1_k, b2_k = res_k[:4]
    t_p, i_p, b1_p, b2_p = res_p[:4]
    i_p = i_p.to(i_k.dtype)
    hk, hp = i_k >= 0, i_p >= 0
    n = hk.numel()
    hit_agree = (hk == hp).float().mean().item()
    both = hk & hp
    nb = max(int(both.sum()), 1)
    idx_agree = ((i_k == i_p) & both).sum().item() / nb
    same = both & (i_k == i_p)
    rel = ((t_k - t_p).abs() / t_p.abs().clamp(min=1e-30))[same]
    t_ok = (rel <= 1e-5).float().mean().item() if rel.numel() else 1.0
    dt = (t_k - t_p).abs()[both].max().item() if both.any() else 0.0
    db = max((b1_k - b1_p).abs()[same].max().item(), (b2_k - b2_p).abs()[same].max().item()) if same.any() else 0.0
    label = f"{name}/{'any' if any_hit else 'closest'}"
    print(f"  {label}: rays {n} hit {hk.float().mean().item():.4f} hit-agree {hit_agree:.6f} "
          f"{'slot' if any_hit else 'prim'}-agree {idx_agree:.6f} t-rtol1e-5 {t_ok:.6f} "
          f"max|dt| {dt:.3e} max|db| {db:.3e}")
    if hit_agree < 0.9999 or (not any_hit and (idx_agree < 0.9999 or t_ok < 0.9999)):
        raise AssertionError(f"kernel and plain traversal disagree on {label}")
    return max(dt, db)


def main() -> int:
    import numpy as np
    import torch

    # --- 1. device ---
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a GPU", file=sys.stderr)
        return 1
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {kind} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import megakernel, megakernel_wide, nvcc, wide_bvh
    from pbrt_tpu_torch.device.camera import make_camera
    from pbrt_tpu_torch.scene.builder import compile_scene
    from pbrt_tpu_torch.scenes import material_room, mesh_room, spheres_gallery

    # --- 2. build: every kernel, one nvcc each, all started together ---
    nvcc.build_all([wide_bvh.KERNEL_SOURCE, wide_bvh.JOINT_SOURCE, megakernel.KERNEL_SOURCE,
                    megakernel_wide.KERNEL_SOURCE])
    # resident blocks per SM of each kernel (cudaOccupancyMaxActiveBlocksPerMultiprocessor), per variant
    occupancy = (("wide_traverse_occupancy", [()]), ("wide_traverse_joint_occupancy", [()]),
                 ("brute_megakernel_occupancy", [(m,) for m in range(6)]),
                 ("wide_megakernel_occupancy", [(m,) for m in range(6)]))
    for build, (entry, variants) in zip((wide_bvh.build_kernel, wide_bvh.build_joint_kernel, megakernel.build_kernel,
                                         megakernel_wide.build_kernel), occupancy):
        info = build()
        regs = "; ".join(sorted(set(re.findall(r"Used \d+ registers[^\n]*", info["log"])))) or "n/a"
        spills = "; ".join(sorted(set(re.findall(r"\d+ bytes spill stores, \d+ bytes spill loads",
                                                 info["log"])))) or "n/a"
        occ = [nvcc.occupancy(getattr(info["lib"], entry), *v) for v in variants]
        print(f"[2 build] {Path(info['path']).name} in {info['seconds']:.1f}s; ptxas: {regs}; {spills}; "
              f"blocks per SM by variant {occ}", flush=True)
    group = wide_bvh.joint_group_width()
    print(f"[2 build] B2 walks a ray with {group} lanes, {32 // group} rays per warp", flush=True)

    # --- 3. B1 kernel vs plain at the main path's shapes ---
    t0 = time.perf_counter()
    cs_host = compile_scene(mesh_room(248), "cpu")
    host_s = time.perf_counter() - t0
    cs = cs_host.to("cuda")
    sa = cs.arrays
    tab_bytes = {n: getattr(sa, n).numel() * getattr(sa, n).element_size() for n in ("wnode_rec", "wleaf_rec")}
    print(f"[3 scene] {cs.static.n_prims} triangles, host compile {host_s:.1f}s, Hopper wide tables "
          f"{sum(tab_bytes.values())} bytes {tab_bytes}, all tables {sa.byte_size()} bytes", flush=True)
    dev = torch.device("cuda", 0)
    max_err = 0.0
    ms = plain_ms = b1_bound = None
    ray_sets = _rays(cs)
    plain_res = {}  # (ray set, any hit) -> traverse_plain's results, B2's reference in phase 9
    for name, o, d, t_max in ray_sets:
        for any_hit in (False, True):
            label = f"{name}/{'any' if any_hit else 'closest'}"
            share_k, res_k = _lane_share(wide_bvh.traverse_cuda, 32, sa, o, d, t_max, any_hit)
            res_p = plain_res[name, any_hit] = wide_bvh.traverse_plain(sa, o, d, t_max, any_hit)
            max_err = max(max_err, _compare(name, any_hit, res_k, res_p))
            if res_p[5] != (0, 0):
                raise AssertionError(f"plain traversal stack overflow / iteration cap: {res_p[5]}")
            if not all(torch.equal(x, y.to(x.dtype)) for x, y in zip(res_k, res_p[:5])):
                raise AssertionError(f"B1 and the plain traversal differ on {label} (t, idx, b1, b2 or pops)")
            k_ms = _cuda_ms(lambda: wide_bvh.traverse_cuda(sa, o, d, t_max, any_hit), 20)
            pops = res_k[4].double()
            # one lane per ray in a fixed grid: a warp of 32 consecutive rays
            # pops as often as its longest walk
            n32 = -(-pops.numel() // 32) * 32
            per_warp = torch.nn.functional.pad(pops, (0, n32 - pops.numel())).view(-1, 32).max(1).values
            fixed = pops.sum().item() / (32 * per_warp.sum().item())
            print(f"  {label}: B1 {k_ms:.4f} ms, {1e6 * k_ms / pops.sum().item():.4f} ns per pop, pops/ray "
                  f"{pops.mean().item():.2f}; lanes with a ray {share_k:.4f} (one lane per ray in a fixed grid: "
                  f"{fixed:.4f})", flush=True)
            if label == "camera/closest":
                ms = k_ms
                plain_ms = _cuda_ms(lambda: wide_bvh.traverse_plain(sa, o, d, t_max, False), 2)
                # inputs read once (rays, the Hopper tables), outputs written
                # once (t, prim, b1, b2, pops); operations from this run's pops
                b1_bytes = _nbytes(o, d, t_max, sa.wnode_rec, sa.wleaf_rec, *res_k[:5])
                b1_bound = _bound(b1_bytes, float(pops.sum()) * B1_OPS_PER_POP)
                print(f"  camera/closest: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms for {o.shape[0]} rays; "
                      f"pops/ray max {int(pops.max().item())}; bound {b1_bound[0]:.4f} ms ({b1_bound[1]}: "
                      f"{b1_bytes} bytes, {float(pops.sum()):.0f} pops)", flush=True)
    counters = wide_bvh.traverse_cuda.counters[dev].tolist()
    if counters != [0, 0]:
        raise AssertionError(f"kernel stack overflows / iteration-cap hits: {counters}")
    print(f"[3 kernel-vs-plain] ok, equal on all six ray sets; max abs err {max_err:.3e}", flush=True)

    # --- 4. the mesh main path ---
    mesh_timing, b1_launches, mesh_img = _main_path("4 mesh main path", cs, "torch-wavefront/cuda-wide",
                                                    wide_bvh.traverse_cuda)
    counters = wide_bvh.traverse_cuda.counters[dev].tolist()
    if counters != [0, 0]:
        raise AssertionError(f"kernel stack overflows / iteration-cap hits: {counters}")

    # --- 5. the same mesh crop on cuda and cpu ---
    _check_crop("5 cuda-vs-cpu crop", cs, cs_host, cs.description)

    # --- 6. B3 kernel vs plain on the spheres gallery ---
    g_host = compile_scene(spheres_gallery(), "cpu")
    g = g_host.to("cuda")
    gd = g.description
    W, H = gd.film.x_resolution, gd.film.y_resolution
    icfg = {"kind": gd.integrator.kind, "max_depth": gd.integrator.max_depth,
            "rr_threshold": gd.integrator.rr_threshold, "strategy": gd.integrator.strategy,
            "light_strategy": gd.integrator.light_strategy}
    fcfg = {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")}
    consts = megakernel.extract_consts(g, make_camera(gd.camera, gd.film, "cuda"), icfg,
                                       {"kind": gd.sampler.kind, "spp": gd.sampler.pixel_samples}, fcfg)
    if consts is None:
        raise AssertionError("the spheres gallery is outside the megakernel's class")
    blob = megakernel.pack_consts(consts).to("cuda")
    mode = megakernel.kernel_mode(consts)
    idx = torch.arange(W * H, device="cuda")
    lanes = (idx % W, idx // W, idx)
    L_k, w_k, nv_k = megakernel.megakernel_cuda(blob, mode, *lanes, 0, COMPARE_SPP, SEED)
    L_p, w_p, nv_p = megakernel.megakernel_plain(consts, *lanes, 0, COMPARE_SPP, SEED)
    torch.cuda.synchronize()
    diff = (L_k - L_p).abs()
    rel = diff / (L_p.abs() + 1e-2)
    b3_err = diff.max().item()
    dnv = abs(nv_k.double().sum().item() - nv_p.double().sum().item())
    print(f"[6 B3 kernel-vs-plain] {W}x{H} {COMPARE_SPP}spp: weights equal {torch.equal(w_k, w_p)}, "
          f"vertices {nv_k.double().sum().item():.0f} vs {nv_p.double().sum().item():.0f}, max |dL|/(|L|+1e-2) "
          f"{rel.max().item():.3e}, mean |dL| {diff.mean().item():.3e}, max |dL| {b3_err:.3e}, "
          f"image mean {L_p.mean().item():.5f}", flush=True)
    if not (torch.allclose(w_k, w_p) and dnv <= 4 and rel.max().item() < 2e-2 and diff.mean().item() < 1e-4
            and L_p.mean().item() > 0):
        raise AssertionError("the brute megakernel and its plain twin disagree")
    spp = gd.sampler.pixel_samples
    b3_ms = _cuda_ms(lambda: megakernel.megakernel_cuda(blob, mode, *lanes, 0, spp, SEED), 5)
    t0 = time.perf_counter()
    megakernel.megakernel_plain(consts, *lanes, 0, spp, SEED)
    torch.cuda.synchronize()
    b3_plain_ms = 1e3 * (time.perf_counter() - t0)
    nv16 = megakernel.megakernel_cuda(blob, mode, *lanes, 0, spp, SEED)[2].double().sum().item()
    n_tri = sum(p["kind"] == "tri" for p in consts["prims"])
    n_sph = len(consts["prims"]) - n_tri
    # per path vertex: one closest-hit and one shadow test over every prim
    # plus the shading; inputs px, py, pid and the blob, outputs L, w, nv
    b3_ops = nv16 * (2 * (n_tri * B3_OPS_TRI + n_sph * B3_OPS_SPH) + B3_OPS_SHADE)
    b3_bound = _bound(3 * 4 * W * H + megakernel.BLOB_FLOATS * 4 + 5 * 4 * W * H, b3_ops)
    print(f"  {W}x{H} {spp}spp: kernel {b3_ms:.4f} ms, plain {b3_plain_ms:.1f} ms; {nv16:.0f} path vertices; "
          f"bound {b3_bound[0]:.4f} ms ({b3_bound[1]}, {b3_ops:.4g} ops), kernel at "
          f"{100 * b3_bound[0] / b3_ms:.2f}% of it", flush=True)

    # --- 7. the gallery main path ---
    g_timing, b3_launches, _img = _main_path("7 gallery main path", g, "torch-megakernel/cuda-brute",
                                             megakernel.megakernel_cuda)
    print(f"  kernel share of the render wall: {100 * b3_ms / (1e3 * g_timing['wall_s']):.1f}%", flush=True)

    # --- 8. the same gallery crop on cuda and cpu ---
    _check_crop("8 cuda-vs-cpu gallery crop", g, g_host, gd)

    # --- 9. B2 against B1 on the six ray sets of phase 3 ---
    b2_ms = {}
    b2_err = 0.0
    for name, o, d, t_max in ray_sets:
        for any_hit in (False, True):
            label = f"{name}/{'any' if any_hit else 'closest'}"
            ref_res = wide_bvh.traverse_cuda(sa, o, d, t_max, any_hit)
            share, res = _lane_share(wide_bvh.traverse_joint_cuda, 32 // group, sa, o, d, t_max, any_hit)
            if not all(torch.equal(x, y) for x, y in zip(res, ref_res)):
                raise AssertionError(f"the cooperative kernel differs from B1 on {label}")
            b2_err = max(b2_err, _compare(f"B2 {name}", any_hit, res, plain_res[name, any_hit]))
            times = [_cuda_ms(lambda: wide_bvh.traverse_cuda(sa, o, d, t_max, any_hit), 20),
                     _cuda_ms(lambda: wide_bvh.traverse_joint_cuda(sa, o, d, t_max, any_hit), 20)]
            b2_ms[label] = times
            pops = float(res[4].double().sum())
            print(f"  {label}: equal to B1; B1 {times[0]:.4f} ms, B2 {times[1]:.4f} ms ({times[1] / times[0]:.3f}x), "
                  f"{1e6 * times[1] / pops:.4f} ns per pop; groups with a ray {share:.4f}", flush=True)
    if wide_bvh.traverse_joint_cuda.counters[dev].tolist() != [0, 0]:
        raise AssertionError("cooperative kernel stack overflows / iteration-cap hits")
    b2_cam_ms = b2_ms["camera/closest"][1]
    print(f"[9 B2 vs B1] ok, bit-equal on all six ray sets; max abs err against plain {b2_err:.3e}; camera/closest "
          f"{b2_cam_ms:.4f} ms against B1 {b2_ms['camera/closest'][0]:.4f} ms", flush=True)

    # --- 10. the mesh main path through the joint kernel ---
    with mock.patch.dict(os.environ, PBRT_TPU_JOINT="1"):
        _t, b2_launches, joint_img = _main_path("10 mesh main path, joint", cs, "torch-wavefront/cuda-wide-joint",
                                                wide_bvh.traverse_joint_cuda)
        if wide_bvh.traverse_cuda.launches != 0:
            raise AssertionError("the joint route launched B1")
    rel_img = np.abs(joint_img - mesh_img).sum() / max(np.abs(mesh_img).sum(), 1e-30)
    print(f"  joint image against phase 4's: sum|a-b|/sum|b| {rel_img:.3e}, bit-equal "
          f"{bool(np.array_equal(joint_img, mesh_img))}", flush=True)
    if not rel_img < 1e-6:
        raise AssertionError("the joint route's image differs from the wavefront's")

    # --- 11. B4 kernel vs plain on material_room ---
    m_host = compile_scene(material_room(), "cpu")
    m = m_host.to("cuda")
    md = m.description
    W, H = md.film.x_resolution, md.film.y_resolution
    icfg = {"kind": "path", "max_depth": md.integrator.max_depth, "rr_threshold": md.integrator.rr_threshold,
            "light_strategy": md.integrator.light_strategy}
    wconsts = megakernel_wide.extract_wide_consts(m, make_camera(md.camera, md.film, "cuda"), icfg,
                                                  {"kind": md.sampler.kind, "spp": md.sampler.pixel_samples}, fcfg,
                                                  megakernel_wide.DEFAULT_MAX_TRIS)
    if wconsts is None:
        raise AssertionError("material_room is outside the wide megakernel's class")
    wblob = megakernel_wide.pack_wide_consts(wconsts).to("cuda")
    wmode = megakernel_wide.kernel_mode(wconsts)
    idx = torch.arange(W * H, device="cuda")
    lanes = (idx % W, idx // W, idx)
    L_k, w_k, nv_k = megakernel_wide.wide_megakernel_cuda(wblob, wmode, m.arrays, *lanes, 0, COMPARE_SPP, SEED)
    t0 = time.perf_counter()
    L_p, w_p, nv_p = megakernel_wide.wide_megakernel_plain(wconsts, m.arrays, *lanes, 0, COMPARE_SPP, SEED)
    torch.cuda.synchronize()
    b4_plain2_s = time.perf_counter() - t0
    ok, desc_cmp = _wide_tolerance(L_k, w_k, nv_k, L_p, w_p, nv_p)
    b4_err = (L_k - L_p).abs().max().item()
    print(f"[11 B4 kernel-vs-plain] material_room {m.static.n_tris} triangles, {W}x{H} {COMPARE_SPP}spp: {desc_cmp}, "
          f"image mean {L_p.mean().item():.5f}; plain twin {b4_plain2_s:.1f} s", flush=True)
    if not ok:
        raise AssertionError("the wide megakernel and its plain twin disagree")
    spp = md.sampler.pixel_samples
    b4_ms = _cuda_ms(lambda: megakernel_wide.wide_megakernel_cuda(wblob, wmode, m.arrays, *lanes, 0, spp, SEED), 3)
    t0 = time.perf_counter()
    megakernel_wide.wide_megakernel_plain(wconsts, m.arrays, *lanes, 0, spp, SEED)
    torch.cuda.synchronize()
    b4_plain_ms = 1e3 * (time.perf_counter() - t0)
    pops = megakernel_wide.wide_megakernel_cuda.pops[dev]
    pops.zero_()
    nv16 = megakernel_wide.wide_megakernel_cuda(wblob, wmode, m.arrays, *lanes, 0, spp, SEED)[2].double().sum().item()
    pops_c, pops_s = pops.tolist()
    if megakernel_wide.wide_megakernel_cuda.counters[dev].tolist() != [0, 0]:
        raise AssertionError("wide megakernel stack overflows / iteration-cap hits")
    print(f"  16 spp path vertices {nv16:.0f} (the per-lane kernel's: {MATERIAL_ROOM_VERTICES})", flush=True)
    if nv16 != MATERIAL_ROOM_VERTICES:
        raise AssertionError("the wide megakernel traced other paths than the per-lane kernel on material_room")
    # inputs px, py, pid (int32) and the wide tables read once, outputs L, w,
    # nv written once; operations from this run's pops and path vertices
    b4_bytes = 3 * 4 * W * H + _nbytes(m.arrays.wnode_rec, m.arrays.wleaf_rec) + 5 * 4 * W * H
    b4_ops = (pops_c + pops_s) * B1_OPS_PER_POP + nv16 * B3_OPS_SHADE
    b4_bound = _bound(b4_bytes, b4_ops)
    print(f"  {W}x{H} {spp}spp: kernel {b4_ms:.4f} ms, plain {b4_plain_ms:.1f} ms; {nv16:.0f} path vertices "
          f"({nv16 / (W * H * spp):.3f} per sample), pops closest {pops_c} shadow {pops_s}; bound "
          f"{b4_bound[0]:.4f} ms ({b4_bound[1]}, {b4_ops:.4g} ops, {b4_bytes} bytes), kernel at "
          f"{100 * b4_bound[0] / b4_ms:.2f}% of it", flush=True)

    # --- 12. the material_room main path through B4 ---
    with mock.patch.dict(os.environ, PBRT_TPU_WIDEMEGA="1"):
        m_timing, b4_launches, _img = _main_path("12 material_room main path", m, "torch-megakernel/cuda-wide",
                                                 megakernel_wide.wide_megakernel_cuda)
        if b4_launches != 1:
            raise AssertionError(f"the material_room render made {b4_launches} wide megakernel launches, not 1")
        print(f"  kernel share of the render wall: {100 * b4_ms / (1e3 * m_timing['wall_s']):.1f}%", flush=True)

        # --- 13. the same material_room crop on cuda and cpu ---
        _check_crop("13 cuda-vs-cpu material_room crop", m, m_host, md)

    # --- 14. the mesh room through B4 beside the wavefront ---
    with mock.patch.dict(os.environ, PBRT_TPU_WIDEMEGA="1", PBRT_TPU_WIDEMEGA_MAX_TRIS="200000"):
        mm_timing, _n, _img = _main_path("14 mesh room through B4", cs, "torch-megakernel/cuda-wide",
                                         megakernel_wide.wide_megakernel_cuda)
        x0, x1, y0, y1 = CROP_BOUNDS
        ys, xs = torch.meshgrid(torch.arange(y0, y1, device="cuda"), torch.arange(x0, x1, device="cuda"),
                                indexing="ij")
        crop = (xs.reshape(-1), ys.reshape(-1), (ys * cs.description.film.x_resolution + xs).reshape(-1))
        b4_fn = R_.make_persistent_fn(cs)
        mega = b4_fn(cs.arrays, *crop, 0, CROP_SPP, SEED)
        mega_tier = R_.LAST_PERSISTENT_TIER
        # the render's B4 kernel alone (the route's blob and mode, timed as in
        # phase 11 by CUDA events around the launch wrapper), and its paths
        mW, mH = cs.description.film.x_resolution, cs.description.film.y_resolution
        midx = torch.arange(mW * mH, device="cuda")
        mlanes = (midx % mW, midx // mW, midx)
        mspp = cs.description.sampler.pixel_samples
        b4_launch = lambda: megakernel_wide.wide_megakernel_cuda(  # noqa: E731
            b4_fn.blob, b4_fn.mode, cs.arrays, *mlanes, 0, mspp, SEED)
        mesh_b4_ms = _cuda_ms(b4_launch, 3)
        mesh_nv = b4_launch()[2].double().sum().item()
    wave = R_.make_persistent_fn(cs)(cs.arrays, *crop, 0, CROP_SPP, SEED)
    ok, desc_cmp = _wide_tolerance(*mega, *wave)
    vps_b4 = mm_timing["n_vertices"] / mm_timing["wall_s"]
    vps_wave = mesh_timing["n_vertices"] / mesh_timing["wall_s"]
    print(f"[14 mesh room B4 vs wavefront] path_vertex_samples_per_sec B4 {vps_b4:.1f}, wavefront (phase 4) "
          f"{vps_wave:.1f}, ratio {vps_b4 / vps_wave:.3f}; B4 kernel {mesh_b4_ms:.4f} ms beside the render wall "
          f"{1e3 * mm_timing['wall_s']:.4f} ms; 16 spp path vertices {mesh_nv:.0f} (the per-lane kernel's: "
          f"{MESH_ROOM_VERTICES}); {x1 - x0}x{y1 - y0} {CROP_SPP}spp crop ({mega_tier} vs "
          f"{R_.LAST_PERSISTENT_TIER}): {desc_cmp}", flush=True)
    if not ok:
        raise AssertionError("the wide megakernel and the wavefront disagree on the mesh room crop")
    if mesh_nv != MESH_ROOM_VERTICES:
        raise AssertionError("the wide megakernel traced other paths than the per-lane kernel on the mesh room")

    report = {"kernels": [
        {"name": "wide_traverse", "route": "cuda", "source": "pbrt_tpu_torch/csrc/wide_traverse.cu",
         "replaces": "pbrt_tpu/device/pallas_bvh.py:90", "launches": b1_launches, "max_abs_err": max_err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": b1_bound[0], "bound_by": b1_bound[1], "library_ms": None},
        {"name": "wide_traverse_joint", "route": "cuda", "source": "pbrt_tpu_torch/csrc/wide_traverse_joint.cu",
         "replaces": "pbrt_tpu/device/pallas_bvh.py:326", "launches": b2_launches, "max_abs_err": b2_err,
         "ms": b2_cam_ms, "plain_ms": plain_ms, "bound_ms": b1_bound[0], "bound_by": b1_bound[1],
         "library_ms": None},
        {"name": "brute_megakernel", "route": "cuda", "source": "pbrt_tpu_torch/csrc/megakernel.cu",
         "replaces": "pbrt_tpu/device/megakernel.py:814", "launches": b3_launches, "max_abs_err": b3_err,
         "ms": b3_ms, "plain_ms": b3_plain_ms, "bound_ms": b3_bound[0], "bound_by": b3_bound[1],
         "library_ms": None},
        {"name": "wide_megakernel", "route": "cuda", "source": "pbrt_tpu_torch/csrc/megakernel_wide.cu",
         "replaces": "pbrt_tpu/device/megakernel_wide.py:525", "launches": b4_launches, "max_abs_err": b4_err,
         "ms": b4_ms, "plain_ms": b4_plain_ms, "bound_ms": b4_bound[0], "bound_by": b4_bound[1],
         "library_ms": None},
    ]}
    print(json.dumps(report))
    print(_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
