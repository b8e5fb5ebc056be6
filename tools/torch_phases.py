#!/usr/bin/env python3
"""Where the time goes in pbrt_tpu_torch's main path, on one CUDA GPU.

    python3 tools/torch_phases.py [--scene mesh|gallery|material_room|mesh_b4] [--reps 5] [--out FILE.json]

Renders at 1000x500, 16 spp, depth 5 one of: the 123,650-triangle mesh room
on the wavefront (--scene mesh, the default), the spheres gallery (--scene
gallery; the brute megakernel), material_room (--scene material_room; the
wide megakernel, PBRT_TPU_WIDEMEGA=1) or the mesh room through the wide
megakernel (--scene mesh_b4; also PBRT_TPU_WIDEMEGA_MAX_TRIS=200000), and
reports, with the card's name and power limit:
 1. end to end: render wall time and path_vertex_samples_per_sec over
    --reps untraced renders after a warm-up (median, min, max);
 2. the traversal kernel against its plain PyTorch twin on the main path's
    ray sets (camera, one cosine bounce, shadow rays; closest and any hit),
    by CUDA events (mesh only; chip_smoke.py times the megakernel);
 3. layers (mesh only; a megakernel render is one kernel launch): one
    render with a synchronize around every call into a layer
    (camera regeneration, closest-hit query, shadow query, of which the
    kernel itself), the rest being shading, NEE, sampling, Russian roulette,
    flush and loop control; the synchronizes serialise host and device, so
    the traced wall minus the untraced median is the tracing cost;
 3g. launch path (the megakernel scenes): the route's one call with a
    synchronize before and after: host time until it returns, device time
    by CUDA events, the whole call; for the wide megakernel also its
    closest-hit and shadow pops per path vertex, the device time per pop,
    and the cycle split of its instrumented instantiation (phases as shares
    of lane-cycles, the share of walk lanes holding a ray, resident blocks
    per SM); then one such call under torch.profiler for the device busy
    share (device time / untraced call wall);
 4. device (mesh only): one untraced render under torch.profiler: total
    kernel time, the device busy share (kernel time / wall) and the top
    kernels (--out also keeps the chrome trace).
--all-matte gives every material of the scene the room's matte (Kd 0.6,
the panel's black Kd kept), so that a wide-megakernel run with and without
it tells shading divergence from geometry. The spans are wrapped around the
port's functions from this script; the program itself carries no tracing
code but B4's instrumented instantiation, which no route launches.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _spanned(fn, name, spans):
    import torch

    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
        return out

    return wrapped


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=("mesh", "gallery", "material_room", "mesh_b4"), default="mesh")
    ap.add_argument("--all-matte", action="store_true", help="every material matte (Kd 0.6), the panel's kept")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the full record as JSON here (with --scene mesh, the profiled "
                                  "render's chrome trace beside it, FILE.trace.json)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_phases: needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.scene.builder import compile_scene
    from pbrt_tpu_torch.scene.host import HostMaterial
    from pbrt_tpu_torch.scenes import material_room, mesh_room, spheres_gallery

    if args.scene in ("material_room", "mesh_b4"):
        os.environ["PBRT_TPU_WIDEMEGA"] = "1"
    if args.scene == "mesh_b4":
        os.environ["PBRT_TPU_WIDEMEGA_MAX_TRIS"] = "200000"
    make = {"mesh": mesh_room, "mesh_b4": mesh_room, "gallery": spheres_gallery, "material_room": material_room}
    rec = {"device": torch.cuda.get_device_name(0), "nvidia_smi": chip_smoke._smi(),
           "torch": torch.__version__, "cuda": torch.version.cuda, "scene": args.scene,
           "all_matte": args.all_matte}
    desc = make[args.scene]()
    if args.all_matte:
        for prim in desc.primitives:
            if prim.area_light is None:
                prim.material = HostMaterial(kind="matte", params={"Kd": ("const", np.full(3, 0.6))})
    t0 = time.perf_counter()
    cs = compile_scene(desc, "cpu")
    rec["host_compile_s"] = time.perf_counter() - t0
    cs = cs.to("cuda")

    # --- 1. end to end, untraced ---
    R_.render_compiled(cs, seed=args.seed, spp=2)  # warm-up
    walls, vps = [], []
    for _ in range(args.reps):
        R_.render_compiled(cs, seed=args.seed)
        tm = R_.render_compiled.last_timing
        walls.append(tm["wall_s"])
        vps.append(tm["n_vertices"] / tm["wall_s"])
    rec["render"] = {"reps": args.reps, "wall_s": walls, "wall_s_median": statistics.median(walls),
                     "vps": vps, "vps_median": statistics.median(vps), "n_vertices": tm["n_vertices"],
                     "tier": tm["tier"]}
    print(f"render: wall median {statistics.median(walls):.4f}s (min {min(walls):.4f} max {max(walls):.4f}), "
          f"path_vertex_samples_per_sec median {statistics.median(vps):.1f}", flush=True)

    if args.scene == "mesh":  # the wavefront
        _traversal_and_layers(args, cs, rec, statistics.median(walls))
        _device(args, cs, rec, statistics.median(walls))
    else:
        _launch_path(args, cs, rec)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
    print(json.dumps({"ok": True, "busy_share": rec["device"]["busy_share"], "nvidia_smi": rec["nvidia_smi"]}))
    return 0


def _traversal_and_layers(args, cs, rec, wall_median):
    import chip_smoke
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import integrator, wide_bvh

    # --- 2. traversal kernel vs plain on the main path's ray sets ---
    rec["traversal"] = []
    for name, o, d, t_max in chip_smoke._rays(cs):
        for any_hit in (False, True):
            k_ms = chip_smoke._cuda_ms(lambda: wide_bvh.traverse_cuda(cs.arrays, o, d, t_max, any_hit), 20)
            p_ms = chip_smoke._cuda_ms(lambda: wide_bvh.traverse_plain(cs.arrays, o, d, t_max, any_hit), 2)
            pops = wide_bvh.traverse_cuda(cs.arrays, o, d, t_max, any_hit)[4].double()
            row = {"rays": name, "query": "any" if any_hit else "closest", "n": o.shape[0],
                   "kernel_ms": k_ms, "plain_ms": p_ms, "pops_mean": pops.mean().item(),
                   "pops_max": int(pops.max().item())}
            rec["traversal"].append(row)
            print(f"traversal {name}/{row['query']}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
                  f"{o.shape[0] / k_ms / 1e3:.1f} Mrays/s, pops/ray {row['pops_mean']:.2f}", flush=True)

    # --- 3. layers, with a synchronize around every layer call ---
    spans: dict = {}
    saved = {n: getattr(integrator, n) for n in ("intersect", "intersect_p")}
    saved_regen = R_.make_regen
    saved_kernel = wide_bvh.traverse_cuda
    try:
        integrator.intersect = _spanned(saved["intersect"], "closest_query", spans)
        integrator.intersect_p = _spanned(saved["intersect_p"], "shadow_query", spans)
        R_.make_regen = lambda *a, **k: _spanned(saved_regen(*a, **k), "regen", spans)
        kern = _spanned(saved_kernel, "kernel", spans)
        kern.launches = 0
        kern.counters, kern.iterations, kern.queues = (saved_kernel.counters, saved_kernel.iterations,
                                                       saved_kernel.queues)
        # wide_intersect and the kernel's own launch count look the name up
        # in the module at call time
        wide_bvh.traverse_cuda = kern
        R_.render_compiled(cs, seed=args.seed)
    finally:
        integrator.intersect, integrator.intersect_p = saved["intersect"], saved["intersect_p"]
        R_.make_regen = saved_regen
        wide_bvh.traverse_cuda = saved_kernel
    traced = R_.render_compiled.last_timing["wall_s"]
    layers = {"regen": spans.get("regen", 0.0),
              "closest_query": spans.get("closest_query", 0.0),
              "shadow_query": spans.get("shadow_query", 0.0)}
    layers["shading_nee_flush_loop"] = traced - sum(layers.values())
    rec["layers"] = {"traced_wall_s": traced, "tracing_cost_s": traced - wall_median,
                     "seconds": layers, "kernel_s_within_queries": spans.get("kernel", 0.0),
                     "kernel_launches": kern.launches}
    print(f"layers (traced wall {traced:.4f}s): " + ", ".join(
        f"{k} {v:.4f}s ({100 * v / traced:.1f}%)" for k, v in layers.items())
        + f"; kernel itself {spans.get('kernel', 0.0):.4f}s over {kern.launches} launches", flush=True)


def _launch_path(args, cs, rec):
    """The megakernel scenes: where the render wall goes around the one
    launch. The route's function is called as render_compiled calls it,
    with a synchronize before and after: host time until the call returns,
    kernel time by CUDA events, and the whole call."""
    import numpy as np
    import torch

    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import megakernel_wide

    desc = cs.description
    W, H = desc.film.x_resolution, desc.film.y_resolution
    spp = desc.sampler.pixel_samples
    ys, xs = np.mgrid[0:H, 0:W]
    lanes = [torch.as_tensor(a.ravel().astype(np.int64), device="cuda") for a in (xs, ys, ys * W + xs)]
    wave = R_.make_persistent_fn(cs)
    rows = []
    for _ in range(args.reps + 1):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        Lw, w, nv = wave(cs.arrays, *lanes, 0, spp, args.seed)
        stop.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rows.append({"host_to_return_ms": 1e3 * (t1 - t0), "call_ms": 1e3 * (t2 - t0),
                     "device_ms": start.elapsed_time(stop)})
    rows = rows[1:]  # the first call carries one-time set-up
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    rec["launch_path"] = {"rows": rows, "median": med}
    print(f"launch path (median of {len(rows)}): host until the call returns {med['host_to_return_ms']:.4f} ms, "
          f"device (events around the call) {med['device_ms']:.4f} ms, whole call {med['call_ms']:.4f} ms",
          flush=True)
    if R_.LAST_PERSISTENT_TIER == "torch-megakernel/cuda-wide":
        # the wide megakernel's own counters, over one more call
        pops = megakernel_wide.wide_megakernel_cuda.pops[torch.device("cuda", 0)]
        pops.zero_()
        n_v = wave(cs.arrays, *lanes, 0, spp, args.seed)[2].double().sum().item()
        pc, ps = pops.tolist()
        rec["wide_megakernel"] = {"path_vertices": n_v, "closest_pops": pc, "shadow_pops": ps,
                                  "pops_per_vertex": (pc + ps) / n_v,
                                  "ns_per_pop": 1e6 * med["device_ms"] / (pc + ps)}
        print(f"wide megakernel: {n_v:.0f} path vertices ({n_v / (W * H * spp):.3f} per sample); pops per vertex "
              f"closest {pc / n_v:.2f}, shadow {ps / n_v:.2f}; {rec['wide_megakernel']['ns_per_pop']:.4f} ns of "
              f"device time per pop", flush=True)
        _wide_split(args, cs, rec, wave, lanes, med["device_ms"])

    # device busy share of one call under the profiler: every device event
    # recorded lies inside the call, which is the render's timed window
    # less its few float64 adds
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave(cs.arrays, *lanes, 0, spp, args.seed)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
    dev_s = sum(e.time_range.elapsed_us() / 1e6 for e in prof.events() if e.device_type == DeviceType.CUDA)
    # against the untraced call, as for the mesh: the profiler slows the host
    busy = dev_s / (med["call_ms"] / 1e3)
    rec["device"] = {"profiled_call_s": call_s, "kernel_time_s": dev_s, "busy_share": busy,
                     "busy_share_of_profiled_call": dev_s / call_s}
    print(f"device: {1e3 * dev_s:.4f} ms of device time; untraced call {med['call_ms']:.4f} ms -> busy "
          f"{100 * busy:.1f}%, idle {100 * (1 - busy):.1f}% (of the profiled call, {1e3 * call_s:.4f} ms: "
          f"busy {100 * dev_s / call_s:.1f}%)", flush=True)


def _wide_split(args, cs, rec, wave, lanes, device_ms):
    """The wide megakernel's cycle split: the route's launch (wave, the
    route's function, gives its blob and mode) through the kernel's
    instrumented instantiation (clock64 counters, (0,2) sampler with area
    lights only), each field as a share of the total and as that share of
    the instrumented launch's device time; plus the kernel's resident blocks
    per SM."""
    import torch

    from pbrt_tpu_torch.device import megakernel_wide

    blob, mode = wave.blob, wave.mode
    spp = cs.description.sampler.pixel_samples
    run = lambda: megakernel_wide.wide_megakernel_split(blob, mode, cs.arrays, *lanes, 0, spp, args.seed)  # noqa: E731
    run()  # warm-up
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    split = run()[3]
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop)
    total = split["total"]
    phases = ("walk", "shade_nee", "flush_regen", "wait", "idle_tail")
    shares = {k: split[k] / total for k in phases}
    # the share of the walk phase's lane-cycles in which threads had a ray,
    # and of the shading phase's (slots that walked) in which they shaded
    busy = {"walk": split["walk_busy"] / max(split["walk_lanes"], 1),
            "shade_nee": split["shade_busy"] / max(split["shade_nee"], 1)}
    occ = megakernel_wide.occupancy(mode)
    rec["wide_split"] = {"cycles": split, "shares": shares, "busy_of_phase": busy, "instrumented_ms": ms,
                         "uninstrumented_ms": device_ms, "blocks_per_sm": occ}
    print(f"wide megakernel split (instrumented launch {ms:.4f} ms against {device_ms:.4f} ms; {occ} blocks of "
          f"128 threads per SM; {split['iterations']} block iterations): "
          + ", ".join(f"{k} {100 * v:.1f}% ({v * ms:.2f} ms)" for k, v in shares.items())
          + "; threads with work: " + ", ".join(f"{k} {100 * v:.1f}%" for k, v in busy.items()), flush=True)


def _device(args, cs, rec, wall_median):
    from pbrt_tpu_torch import render as R_

    # --- 4. device time under the profiler (no synchronizing spans) ---
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        R_.render_compiled(cs, seed=args.seed)
    wall = R_.render_compiled.last_timing["wall_s"]
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out.with_suffix(".trace.json")))
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            s_, c_ = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (s_ + e.time_range.elapsed_us() / 1e6, c_ + 1)
    rows = [(s_, c_, k) for k, (s_, c_) in by_name.items()]
    rows.sort(reverse=True)
    dev_s = sum(r[0] for r in rows)
    # busy share against the untraced wall: the profiler slows the host side
    busy = dev_s / wall_median
    rec["device"] = {"profiled_wall_s": wall, "kernel_time_s": dev_s, "busy_share": busy,
                     "kernel_launches": sum(r[1] for r in rows),
                     "top": [{"name": k[:120], "s": s, "count": c} for s, c, k in rows[:15]]}
    print(f"device: kernel time {dev_s:.4f}s in {rec['device']['kernel_launches']} kernels; untraced wall "
          f"{wall_median:.4f}s -> busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}% "
          f"(profiled wall {wall:.4f}s)", flush=True)
    for s, c, k in rows[:10]:
        print(f"  {s:.4f}s  x{c:6d}  {k[:100]}")


if __name__ == "__main__":
    sys.exit(main())
