#!/usr/bin/env python3
"""Where the time goes in pbrt_tpu_torch's main path, on one CUDA GPU.

    python3 tools/torch_phases.py [--scene mesh|gallery|material_room|mesh_b4|material_room_wave|area_box|
                                           textured_room|textured_gallery|checker_room|sphere_room|
                                           sphere_room_248|zoo_room|zoo_room_248|quadric_room|
                                           quadric_room_kd|fog_room|sss_room|motion_room|
                                           realistic_room|bdpt_mesh|mlt_mesh|sppm_mesh]
                                  [--reps 5] [--out FILE.json] [--package-root DIR]

Renders at 1000x500, 16 spp, depth 5 one of: the 123,650-triangle mesh room
on the wavefront (--scene mesh, the default), the spheres gallery (--scene
gallery; the brute megakernel), material_room (--scene material_room; the
wide megakernel, PBRT_TPU_WIDEMEGA=1), the mesh room through the wide
megakernel (--scene mesh_b4; also PBRT_TPU_WIDEMEGA_MAX_TRIS=200000),
material_room on the wavefront (--scene material_room_wave), area_box
on the brute wavefront (--scene area_box), textured_room on the wavefront
(--scene textured_room), textured_gallery through the brute megakernel's
textured instantiation (--scene textured_gallery), material_room with
the checkerboard floor through the wide megakernel (--scene checker_room)
or sphere_room, seven full spheres beside material_room's triangles, on
the wavefront's mixed query (--scene sphere_room; sphere_room_248: the same
spheres among the mesh room's 123,650 triangles), or zoo_room, material_room
re-dressed in substrate, disney, mix, fourier, translucent and hair, on the
wavefront (--scene zoo_room; zoo_room_248: among the mesh room's terrain),
or quadric_room, the mesh room's enclosure with 30 quadrics of the six
kinds, 64 instances of a prop, an alpha-cut panel and goniometric and
projection lights, on the wavefront's binary-BVH walk (--scene
quadric_room; quadric_room_kd: its kd variant at n_side 40 without
instances, on the kd walk), or, through the per-sample wave, fog_room
(volpath: the mesh room's enclosure in a homogeneous fog, an interface box
of grid smoke; --scene fog_room) or sss_room (path: a subsurface and a
kdsubsurface sphere in the enclosure; --scene sss_room), motion_room (the
mesh room with a spinning UV sphere, a translating box and a moving
sphere quadric under a dollying camera: the time-aware binary-BVH walk;
--scene motion_room) or the mesh room under the realistic camera (--scene
realistic_room), or the mesh room under bidirectional path tracing
(--scene bdpt_mesh: B1 for every subpath and connection query), MLT
(--scene mlt_mesh: chip_smoke.py phase 48's settings, 1 mutation per
pixel, 4,096 chains, 100,000 bootstrap samples) or SPPM (--scene
sppm_mesh: phase 49's, 4 iterations of 500,000 photons, radius 0.024),
and reports, with the card's name and power limit:
 1. end to end: render wall time and path_vertex_samples_per_sec (MLT:
    mutations per second; SPPM: photons per second) over --reps untraced
    renders after a warm-up (median, min, max);
 2. the traversal kernel against its plain PyTorch twin on the main path's
    ray sets (camera, one cosine bounce, shadow rays; closest and any hit),
    by CUDA events (mesh and material_room_wave; chip_smoke.py times the
    megakernels);
 3. layers (the wavefront scenes; a megakernel render is one kernel
    launch): one render with a synchronize around every call into a layer
    (camera regeneration, closest-hit query, shadow query, of which the
    traversal kernel itself and, in a mixed scene, the spheres' tests and
    merge; on the walk's scenes the walk itself, split into the closest
    queries' walks, the shadow queries' walks and the alpha re-casts (the
    walks after a query's first); lobe evaluation: make_bsdf and the integrator's calls of
    bsdf_f, bsdf_pdf and bsdf_sample), the rest being shading, NEE, sampling,
    Russian roulette, flush and loop control; on the wave's scenes also
    medium sampling (media.medium_sample, with its delta tracking), shadow
    transmittance (media.transmittance_shadow: the null-crossing queries
    and ratio tracking) and the BSSRDF's probe chain (integrator.
    probe_chain); a span nested in another counts in the outer one only;
    the synchronizes serialise host and device, so the traced wall minus
    the untraced median is the tracing cost;
 3g. launch path (the megakernel scenes): the route's one call with a
    synchronize before and after: host time until it returns, device time
    by CUDA events, the whole call; for the wide megakernel also its
    closest-hit and shadow pops per path vertex, the device time per pop,
    and the cycle split of its instrumented instantiation (phases as shares
    of lane-cycles, the share of walk lanes holding a ray, resident blocks
    per SM); for the brute megakernel (--scene gallery) the cycle split of
    its instrumented instantiation (test pool, shading + NEE, flush +
    regeneration, slots waiting for a shadow ray, the grid's tail), its
    test counts and resident blocks per SM; then one such call under
    torch.profiler for the device busy share (device time / untraced call
    wall);
 4. device (the wavefront scenes): one untraced render under
    torch.profiler: total kernel time, device kernels per render and per
    wavefront iteration (closest-hit queries), the device busy share
    (kernel time / wall) and the top kernels (--out also keeps the chrome
    trace); on the wave's scenes per wave bounce (its iterations and last
    pickup) instead;
 5. BDPT (--scene bdpt_mesh) in place of 2-4: one render with a
    synchronize around the camera subpaths, the light subpaths, the
    connections of t >= 2 (of which the MIS weights and B1) and the splats
    (the t = 1 connections and the film's index_add_); then one render under
    torch.profiler: device kernels per wave and the busy share;
 6. MLT (--scene mlt_mesh) in place of 2-4: one render with a synchronize
    around the bootstrap (each depth's evaluation of its samples, its own
    subpaths and connections within it), the chains' subpaths, their
    connections of t >= 2, their splats (the t = 1 connections and the
    film's index_add_) and the accept step (the proposal, the acceptance
    and the next state); then one render under torch.profiler: device
    kernels per chain step and the busy share;
 7. SPPM (--scene sppm_mesh) in place of 2-4: the render's own split
    (render_sppm.last_timing: the camera pass, the grid, the photon trace
    and the deposit, each span ended by a synchronize at a point where the
    host loop reads the device anyway, or just before one); then one
    render under torch.profiler: device kernels per iteration and the
    busy share.
--package-root DIR imports pbrt_tpu_torch from DIR (the root of a `git
archive` of another commit) in place of this checkout's, so that one call
measures two designs with the same script: the walks' and medium_track's
device time over their launches (4) read the same way for both.
The motion scene's traversal rows (2) run the walk's motion entry at
uniform shutter fractions from --seed, and its layers count the motion
walk as a span within the queries.
--all-matte gives every material of the scene the room's matte (Kd 0.6,
the panel's black Kd kept), so that a wide-megakernel run with and without
it tells shading divergence from geometry. The spans are wrapped around the
port's functions from this script; the program itself carries no tracing
code but the megakernels' instrumented instantiations, which no route
launches, and the host loops' own seconds (MLT per depth, SPPM per phase),
each ended by a synchronize where the loop reads the device anyway.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


_DEPTH = [0]  # spans open: a span inside another counts in the outer one only


def _spanned(fn, name, spans, within=False):
    """fn with a synchronized span: a layer's (counted only outside any
    other layer's span) or, with `within`, a span inside a layer's (the
    kernel, the walks, the spheres' merge), always counted."""
    import torch

    def wrapped(*args, **kw):
        if within:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
            return out
        if _DEPTH[0]:
            return fn(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _DEPTH[0] += 1
        try:
            out = fn(*args, **kw)
        finally:
            _DEPTH[0] -= 1
        torch.cuda.synchronize()
        spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
        return out

    return wrapped


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="mesh",
                    choices=("mesh", "gallery", "material_room", "mesh_b4", "material_room_wave", "area_box",
                             "textured_room", "textured_gallery", "checker_room", "sphere_room", "sphere_room_248",
                             "zoo_room", "zoo_room_248", "quadric_room", "quadric_room_kd", "fog_room",
                             "sss_room", "motion_room", "realistic_room", "bdpt_mesh", "mlt_mesh", "sppm_mesh"))
    ap.add_argument("--all-matte", action="store_true", help="every material matte (Kd 0.6), the panel's kept")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the full record as JSON here (with --scene mesh, the profiled "
                                  "render's chrome trace beside it, FILE.trace.json)")
    ap.add_argument("--package-root", help="import pbrt_tpu_torch from this checkout root instead")
    args = ap.parse_args()
    if args.package_root:
        sys.path.insert(0, str(Path(args.package_root).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_phases: needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.scene.builder import compile_scene
    from pbrt_tpu_torch.scene.host import HostMaterial
    from pbrt_tpu_torch.scenes import area_box, fog_room, material_room, mesh_room, motion_room, quadric_room, \
        realistic_mesh_room, sphere_room, spheres_gallery, sss_room, textured_gallery, textured_room, zoo_room

    def bdpt_mesh():
        desc = mesh_room(248)
        desc.integrator.kind = "bdpt"
        return desc

    def mlt_mesh():
        desc = mesh_room(248)
        desc.integrator = dataclasses.replace(desc.integrator, kind="mlt", mutations_per_pixel=1, n_chains=4096,
                                              n_bootstrap=100_000)
        return desc

    def sppm_mesh():
        desc = mesh_room(248)
        desc.integrator = dataclasses.replace(desc.integrator, kind="sppm", num_iterations=4,
                                              photons_per_iteration=-1, initial_radius=0.024)
        return desc


    if args.scene in ("material_room", "mesh_b4", "checker_room"):
        os.environ["PBRT_TPU_WIDEMEGA"] = "1"
    if args.scene == "mesh_b4":
        os.environ["PBRT_TPU_WIDEMEGA_MAX_TRIS"] = "200000"
    make = {"mesh": mesh_room, "mesh_b4": mesh_room, "gallery": spheres_gallery, "material_room": material_room,
            "material_room_wave": material_room, "area_box": area_box, "textured_room": textured_room,
            "textured_gallery": textured_gallery, "checker_room": lambda: material_room(checker=True),
            "sphere_room": sphere_room, "sphere_room_248": lambda: sphere_room(248), "zoo_room": zoo_room,
            "zoo_room_248": lambda: zoo_room(248), "quadric_room": lambda: quadric_room(248),
            "quadric_room_kd": lambda: quadric_room(40, instances=False, accelerator="kdtree"),
            "fog_room": fog_room, "sss_room": sss_room, "motion_room": motion_room,
            "realistic_room": realistic_mesh_room, "bdpt_mesh": bdpt_mesh, "mlt_mesh": mlt_mesh,
            "sppm_mesh": sppm_mesh}
    import pbrt_tpu_torch

    rec = {"device": torch.cuda.get_device_name(0), "nvidia_smi": chip_smoke._smi(),
           "package": str(Path(pbrt_tpu_torch.__file__).resolve().parent),
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
    # the work a render does: path vertices, or MLT's mutations, or SPPM's photons
    work = "n_vertices"
    for _ in range(args.reps):
        R_.render_compiled(cs, seed=args.seed)
        tm = R_.render_compiled.last_timing
        work = next(k for k in ("n_vertices", "mutations", "photons") if k in tm)
        walls.append(tm["wall_s"])
        vps.append(tm[work] / tm["wall_s"])
    rec["render"] = {"reps": args.reps, "wall_s": walls, "wall_s_median": statistics.median(walls),
                     "vps": vps, "vps_median": statistics.median(vps), "work": work, work: tm[work],
                     "tier": tm["tier"]}
    rate = {"n_vertices": "path_vertex_samples_per_sec", "mutations": "mutations per second",
            "photons": "photons per second"}[work]
    print(f"render: wall median {statistics.median(walls):.4f}s (min {min(walls):.4f} max {max(walls):.4f}), "
          f"{rate} median {statistics.median(vps):.1f}", flush=True)

    if tm["tier"].startswith("torch-bdpt/"):
        _bdpt_layers(args, cs, rec, statistics.median(walls))
    elif tm["tier"].startswith("torch-mlt/"):
        _mlt_layers(args, cs, rec, statistics.median(walls))
    elif tm["tier"].startswith("torch-sppm/"):
        _sppm_layers(args, cs, rec, statistics.median(walls))
    elif tm["tier"].startswith(("torch-wavefront", "torch-wave/")):
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


# the integrator's calls into the lobe layer (bsdf_sample's own calls of
# bsdf_f and bsdf_pdf run inside its span)
LOBE_CALLS = ("make_bsdf", "bsdf_f", "bsdf_pdf", "bsdf_sample")


def _traversal_and_layers(args, cs, rec, wall_median):
    import torch

    import chip_smoke
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import bvh_walk, integrator, intersect, media, wide_bvh

    # --- 2. traversal kernel vs plain on the main path's ray sets ---
    rec["traversal"] = []
    route = intersect.route_name(cs.static)
    if cs.static.has_motion and route == "bvh":
        # the motion entry at uniform shutter fractions, one per ray
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        times = {}

        def time_of(o):
            if o.shape[0] not in times:
                times[o.shape[0]] = torch.rand(o.shape[0], device="cuda", generator=gen)
            return times[o.shape[0]]

        kernel = lambda o, d, t_max, any_hit: bvh_walk.bvh_walk_motion_cuda(  # noqa: E731
            cs.arrays, cs.static, o, d, t_max, any_hit, time=time_of(o))
        plain = lambda o, d, t_max, any_hit: bvh_walk.walk_plain(  # noqa: E731
            cs.arrays, cs.static, o, d, t_max, any_hit, time=time_of(o))
    elif route in ("bvh", "kdtree"):
        walk_k = bvh_walk.kd_walk_cuda if route == "kdtree" else bvh_walk.bvh_walk_cuda
        walk_p = bvh_walk.kd_walk_plain if route == "kdtree" else bvh_walk.walk_plain
        kernel = lambda o, d, t_max, any_hit: walk_k(cs.arrays, cs.static, o, d, t_max, any_hit)  # noqa: E731
        plain = lambda o, d, t_max, any_hit: walk_p(cs.arrays, cs.static, o, d, t_max, any_hit)  # noqa: E731
    else:
        kernel = lambda o, d, t_max, any_hit: wide_bvh.traverse_cuda(cs.arrays, o, d, t_max, any_hit)  # noqa: E731
        plain = lambda o, d, t_max, any_hit: wide_bvh.traverse_plain(cs.arrays, o, d, t_max, any_hit)  # noqa: E731
    for name, o, d, t_max in (chip_smoke._rays(cs) if cs.static.has_wide_tri or route in ("bvh", "kdtree") else ()):
        for any_hit in (False, True):
            k_ms = chip_smoke._cuda_ms(lambda: kernel(o, d, t_max, any_hit), 20)
            p_ms = chip_smoke._cuda_ms(lambda: plain(o, d, t_max, any_hit), 2)
            pops = kernel(o, d, t_max, any_hit)[4].double()
            row = {"rays": name, "query": "any" if any_hit else "closest", "n": o.shape[0],
                   "kernel_ms": k_ms, "plain_ms": p_ms, "pops_mean": pops.mean().item(),
                   "pops_max": int(pops.max().item())}
            rec["traversal"].append(row)
            print(f"traversal {name}/{row['query']}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
                  f"{o.shape[0] / k_ms / 1e3:.1f} Mrays/s, pops/ray {row['pops_mean']:.2f}", flush=True)

    # --- 3. layers, with a synchronize around every layer call ---
    spans: dict = {}
    saved = {n: getattr(integrator, n) for n in ("intersect", "intersect_p", "probe_chain") + LOBE_CALLS}
    saved_media = {n: getattr(media, n) for n in ("medium_sample", "transmittance_shadow")}
    saved_regen = R_.make_regen
    # the wave's camera samples (make_wave_fn calls these itself)
    saved_cam = {n: getattr(R_, n) for n in ("_film_sample", "_shutter_fraction", "generate_rays",
                                             "realistic_generate_rays", "ray_differential_dirs")}
    saved_kernel = wide_bvh.traverse_cuda
    saved_spheres = intersect._mixed_spheres
    saved_walk = intersect.walk_intersect
    saved_motion = bvh_walk.bvh_walk_motion_cuda
    # the walk's span by the query that calls it: a query's first walk, or a
    # re-cast past an alpha cut-out
    query = {"name": None, "walks": 0}

    def in_query(fn, name):
        def wrapped(*a, **k):
            query["name"], query["walks"] = name, 0
            return fn(*a, **k)
        return wrapped

    def walk(*a, **k):
        name = "walk_alpha_recast" if query["walks"] else f"walk_{query['name']}"
        query["walks"] += 1
        return _spanned(saved_walk, name, spans, within=True)(*a, **k)

    try:
        intersect._mixed_spheres = _spanned(saved_spheres, "sphere_merge", spans, within=True)
        intersect.walk_intersect = walk
        motion_walk = _spanned(saved_motion, "motion_walk", spans, within=True)
        motion_walk.launches, motion_walk.counters = 0, saved_motion.counters
        bvh_walk.bvh_walk_motion_cuda = motion_walk  # walk_intersect looks the entry up at call time
        integrator.intersect = in_query(_spanned(saved["intersect"], "closest_query", spans), "closest")
        integrator.intersect_p = in_query(_spanned(saved["intersect_p"], "shadow_query", spans), "shadow")
        for n in LOBE_CALLS:
            setattr(integrator, n, _spanned(saved[n], "lobe_eval", spans))
        integrator.probe_chain = _spanned(saved["probe_chain"], "bssrdf_probes", spans)
        media.medium_sample = _spanned(saved_media["medium_sample"], "medium_sample", spans)
        media.transmittance_shadow = _spanned(saved_media["transmittance_shadow"], "shadow_transmittance", spans)
        R_.make_regen = lambda *a, **k: _spanned(saved_regen(*a, **k), "regen", spans)
        for n, fn in saved_cam.items():
            setattr(R_, n, _spanned(fn, "regen", spans))
        kern = _spanned(saved_kernel, "kernel", spans, within=True)
        kern.launches = 0
        kern.counters, kern.iterations, kern.queues = (saved_kernel.counters, saved_kernel.iterations,
                                                       saved_kernel.queues)
        # wide_intersect and the kernel's own launch count look the name up
        # in the module at call time
        wide_bvh.traverse_cuda = kern
        R_.render_compiled(cs, seed=args.seed)
    finally:
        for n, fn in saved.items():
            setattr(integrator, n, fn)
        for n, fn in saved_media.items():
            setattr(media, n, fn)
        R_.make_regen = saved_regen
        for n, fn in saved_cam.items():
            setattr(R_, n, fn)
        wide_bvh.traverse_cuda = saved_kernel
        intersect._mixed_spheres = saved_spheres
        intersect.walk_intersect = saved_walk
        bvh_walk.bvh_walk_motion_cuda = saved_motion
    traced = R_.render_compiled.last_timing["wall_s"]
    layers = {"regen": spans.get("regen", 0.0),
              "closest_query": spans.get("closest_query", 0.0),
              "shadow_query": spans.get("shadow_query", 0.0),
              "lobe_eval": spans.get("lobe_eval", 0.0)}
    for k in ("medium_sample", "shadow_transmittance", "bssrdf_probes"):
        if k in spans:
            layers[k] = spans[k]
    layers["shading_nee_flush_loop"] = traced - sum(layers.values())
    rec["layers"] = {"traced_wall_s": traced, "tracing_cost_s": traced - wall_median,
                     "seconds": layers, "kernel_s_within_queries": spans.get("kernel", 0.0),
                     "sphere_merge_s_within_queries": spans.get("sphere_merge", 0.0),
                     "walk_s_within_queries": {k: spans.get(k, 0.0) for k in
                                               ("walk_closest", "walk_shadow", "walk_alpha_recast")},
                     "motion_walk_s_within_queries": spans.get("motion_walk", 0.0),
                     "motion_walk_launches": motion_walk.launches,
                     "kernel_launches": kern.launches}
    print(f"layers (traced wall {traced:.4f}s): " + ", ".join(
        f"{k} {v:.4f}s ({100 * v / traced:.1f}%)" for k, v in layers.items())
        + f"; kernel itself {spans.get('kernel', 0.0):.4f}s over {kern.launches} launches; spheres' tests and "
          f"merge {spans.get('sphere_merge', 0.0):.4f}s; walks: closest {spans.get('walk_closest', 0.0):.4f}s, shadow "
          f"{spans.get('walk_shadow', 0.0):.4f}s, alpha re-casts {spans.get('walk_alpha_recast', 0.0):.4f}s; the "
          f"motion walk {spans.get('motion_walk', 0.0):.4f}s over {motion_walk.launches} launches", flush=True)


def _bdpt_layers(args, cs, rec, wall_median):
    """BDPT's layers: one render with a synchronize around each call into
    the camera subpaths, the light subpaths, the connections of t >= 2 and
    the splats (t = 1 connections and the film adds); the MIS weights and
    B1 as spans within them. Then one render under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import bdpt, wide_bvh

    spans: dict = {}
    names = {"generate_camera_subpath": "camera_subpath", "generate_light_subpath": "light_subpath",
             "connect_bdpt": "connections", "connect_t1": "splats", "_splat": "splats"}
    saved = {n: getattr(bdpt, n) for n in list(names) + ["_mis_weight"]}
    saved_kernel = wide_bvh.traverse_cuda
    waves = [0]

    def counted(*a, **k):
        waves[0] += 1
        return saved_wave(*a, **k)

    saved_wave = bdpt.bdpt_wave
    try:
        for n, span in names.items():
            setattr(bdpt, n, _spanned(saved[n], span, spans))
        bdpt._mis_weight = _spanned(saved["_mis_weight"], "mis_weight", spans, within=True)
        kern = _spanned(saved_kernel, "kernel", spans, within=True)
        kern.launches = 0
        kern.counters, kern.iterations, kern.queues = (saved_kernel.counters, saved_kernel.iterations,
                                                       saved_kernel.queues)
        wide_bvh.traverse_cuda = kern
        R_.render_compiled(cs, seed=args.seed)
    finally:
        for n, fn in saved.items():
            setattr(bdpt, n, fn)
        wide_bvh.traverse_cuda = saved_kernel
    traced = R_.render_compiled.last_timing["wall_s"]
    layers = {k: spans.get(k, 0.0) for k in ("camera_subpath", "light_subpath", "connections", "splats")}
    layers["loop_and_film"] = traced - sum(layers.values())
    rec["layers"] = {"traced_wall_s": traced, "tracing_cost_s": traced - wall_median, "seconds": layers,
                     "mis_weight_s_within": spans.get("mis_weight", 0.0),
                     "kernel_s_within": spans.get("kernel", 0.0), "kernel_launches": kern.launches}
    print(f"bdpt layers (traced wall {traced:.4f}s): " + ", ".join(
        f"{k} {v:.4f}s ({100 * v / traced:.1f}%)" for k, v in layers.items())
        + f"; within them the MIS weights {spans.get('mis_weight', 0.0):.4f}s, B1 {spans.get('kernel', 0.0):.4f}s "
          f"over {kern.launches} launches", flush=True)
    bdpt.bdpt_wave = counted
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            R_.render_compiled(cs, seed=args.seed)
    finally:
        bdpt.bdpt_wave = saved_wave
    dev_s = sum(e.time_range.elapsed_us() / 1e6 for e in prof.events() if e.device_type == DeviceType.CUDA)
    n_kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy = dev_s / wall_median
    rec["device"] = {"kernel_time_s": dev_s, "busy_share": busy, "kernel_launches": n_kernels, "waves": waves[0],
                     "kernels_per_wave": n_kernels / max(waves[0], 1)}
    print(f"device: kernel time {dev_s:.4f}s in {n_kernels} kernels over {waves[0]} waves "
          f"({n_kernels / max(waves[0], 1):.1f} per wave); untraced wall {wall_median:.4f}s -> busy "
          f"{100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%", flush=True)


def _profiled_render(args, cs, wall_median):
    """One render under torch.profiler: (device kernel seconds, kernels,
    the busy share against the untraced wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pbrt_tpu_torch import render as R_

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        R_.render_compiled(cs, seed=args.seed)
    dev_s = sum(e.time_range.elapsed_us() / 1e6 for e in prof.events() if e.device_type == DeviceType.CUDA)
    n_kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return dev_s, n_kernels, dev_s / wall_median


def _mlt_layers(args, cs, rec, wall_median):
    """MLT's layers: one render with a synchronize around each call into the
    bootstrap, the chains' subpaths, connections, splats and accept step
    (B1 a span within them); then one render under torch.profiler."""
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import mlt, wide_bvh

    spans: dict = {}
    names = {"_bootstrap": "bootstrap", "generate_camera_subpath": "subpaths", "generate_light_subpath": "subpaths",
             "connect_bdpt": "connections", "connect_t1": "splats", "_splat_step": "splats", "_propose": "accept",
             "_weights": "accept", "_accept": "accept"}
    saved = {n: getattr(mlt, n) for n in names}
    saved_kernel = wide_bvh.traverse_cuda
    try:
        for n, span in names.items():
            setattr(mlt, n, _spanned(saved[n], span, spans))
        kern = _spanned(saved_kernel, "kernel", spans, within=True)
        kern.launches = 0
        kern.counters, kern.iterations, kern.queues = (saved_kernel.counters, saved_kernel.iterations,
                                                       saved_kernel.queues)
        wide_bvh.traverse_cuda = kern
        R_.render_compiled(cs, seed=args.seed)
    finally:
        for n, fn in saved.items():
            setattr(mlt, n, fn)
        wide_bvh.traverse_cuda = saved_kernel
    tm = R_.render_compiled.last_timing
    traced = tm["wall_s"]
    layers = {k: spans.get(k, 0.0) for k in ("bootstrap", "subpaths", "connections", "splats", "accept")}
    layers["loop"] = traced - sum(layers.values())
    rec["layers"] = {"traced_wall_s": traced, "tracing_cost_s": traced - wall_median, "seconds": layers,
                     "kernel_s_within": spans.get("kernel", 0.0), "kernel_launches": kern.launches,
                     "chain_steps": tm["chain_steps"], "acceptance": tm["acceptance"]}
    print(f"mlt layers (traced wall {traced:.4f}s, {tm['chain_steps']} chain steps): " + ", ".join(
        f"{k} {v:.4f}s ({100 * v / traced:.1f}%)" for k, v in layers.items())
        + f"; within them B1 {spans.get('kernel', 0.0):.4f}s over {kern.launches} launches", flush=True)
    dev_s, n_kernels, busy = _profiled_render(args, cs, wall_median)
    steps = tm["chain_steps"]
    rec["device"] = {"kernel_time_s": dev_s, "busy_share": busy, "kernel_launches": n_kernels,
                     "kernels_per_chain_step": n_kernels / max(steps, 1)}
    print(f"device: kernel time {dev_s:.4f}s in {n_kernels} kernels ({n_kernels / max(steps, 1):.1f} per chain "
          f"step, the bootstraps' with them); untraced wall {wall_median:.4f}s -> busy {100 * busy:.1f}%, idle "
          f"{100 * (1 - busy):.1f}%", flush=True)


def _sppm_layers(args, cs, rec, wall_median):
    """SPPM's layers from the render's own split, then one render under
    torch.profiler."""
    from pbrt_tpu_torch import render as R_

    tm = R_.render_compiled.last_timing
    n_it = tm["iterations"]
    rec["layers"] = {"seconds": tm["split"], "iterations": n_it, "max_run": tm["max_run"], "dropped": tm["dropped"],
                     "pairs": tm["pairs"]}
    print(f"sppm layers ({n_it} iterations, wall {tm['wall_s']:.4f}s): " + ", ".join(
        f"{k} {v:.4f}s ({100 * v / tm['wall_s']:.1f}%)" for k, v in tm["split"].items())
        + f"; {tm['pairs']} photon-visible point pairs, longest cell run {tm['max_run']}, dropped {tm['dropped']}",
        flush=True)
    dev_s, n_kernels, busy = _profiled_render(args, cs, wall_median)
    rec["device"] = {"kernel_time_s": dev_s, "busy_share": busy, "kernel_launches": n_kernels,
                     "kernels_per_iteration": n_kernels / max(n_it, 1)}
    print(f"device: kernel time {dev_s:.4f}s in {n_kernels} kernels ({n_kernels / max(n_it, 1):.1f} per "
          f"iteration); untraced wall {wall_median:.4f}s -> busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%",
          flush=True)


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
        if wave.mode == 1:  # the instrumented instantiation's: (0,2), area lights, EXT = 0
            _wide_split(args, cs, rec, wave, lanes, med["device_ms"])
    if R_.LAST_PERSISTENT_TIER == "torch-megakernel/cuda-brute" and wave.mode == 0:
        _brute_split(args, cs, rec, wave, lanes, med["device_ms"])  # (0,2), path, untextured only

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


def _brute_split(args, cs, rec, wave, lanes, device_ms):
    """The brute megakernel's cycle split: the route's launch through the
    kernel's instrumented instantiation (clock64 counters, (0,2) sampler and
    path only), each field as a share of the total and as that share of the
    instrumented launch's device time; its test counts; its resident blocks
    per SM."""
    import torch

    from pbrt_tpu_torch.device import megakernel

    spp = cs.description.sampler.pixel_samples
    dev = torch.device("cuda", 0)
    run = lambda: megakernel.megakernel_split(wave.blob, wave.mode, *lanes, 0, spp, args.seed)  # noqa: E731
    run()  # warm-up
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _l, _w, nv, split = run()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop)
    tests = {k: split[k] for k in ("closest", "shadow", "shadow_tri", "shadow_sph")}
    total = split["total"]
    phases = ("pool", "shade_nee", "flush_regen", "wait", "idle_tail")
    shares = {k: split[k] / total for k in phases}
    busy = {"pool": split["pool_busy"] / max(split["pool_lanes"], 1),
            "shade_nee": split["shade_busy"] / max(split["shade_nee"], 1)}
    occ = megakernel.occupancy(wave.mode)
    n_v = nv.double().sum().item()
    rec["brute_split"] = {"cycles": split, "shares": shares, "busy_of_phase": busy, "instrumented_ms": ms,
                          "uninstrumented_ms": device_ms, "blocks_per_sm": occ, "tests": tests, "path_vertices": n_v}
    print(f"brute megakernel split (instrumented launch {ms:.4f} ms against {device_ms:.4f} ms; {occ} blocks of "
          f"128 path slots per SM; {split['iterations']} block iterations): "
          + ", ".join(f"{k} {100 * v:.1f}% ({v * ms:.2f} ms)" for k, v in shares.items())
          + "; threads with work: " + ", ".join(f"{k} {100 * v:.1f}%" for k, v in busy.items())
          + f"; {n_v:.0f} path vertices; tests {tests}", flush=True)


def _device(args, cs, rec, wall_median):
    from pbrt_tpu_torch import render as R_

    # --- 4. device time under the profiler (no synchronizing spans) ---
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pbrt_tpu_torch.device import integrator

    # wavefront iterations = closest-hit queries (one per iteration), counted
    # without a synchronize; the wave's bounces = its waves times its
    # iterations and last pickup
    n_iter = [0]
    wave_scene = R_.render_compiled.last_timing["tier"].startswith("torch-wave/")
    name = "trace_wave" if wave_scene else "intersect"
    closest = getattr(integrator, name)
    per_call = (integrator.wave_iterations(cs.static, cs.description.integrator.kind,
                                           cs.description.integrator.max_depth) + 1) if wave_scene else 1

    def counted(*a, **k):
        n_iter[0] += per_call
        return closest(*a, **k)

    setattr(integrator, name, counted)
    R_.trace_wave = integrator.trace_wave
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            R_.render_compiled(cs, seed=args.seed)
    finally:
        setattr(integrator, name, closest)
        R_.trace_wave = integrator.trace_wave
    wall = R_.render_compiled.last_timing["wall_s"]
    if args.out and args.scene == "mesh":
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
    n_kernels = sum(r[1] for r in rows)
    rec["device"] = {"profiled_wall_s": wall, "kernel_time_s": dev_s, "busy_share": busy,
                     "kernel_launches": n_kernels, "iterations": n_iter[0],
                     "kernels_per_iteration": n_kernels / max(n_iter[0], 1),
                     "top": [{"name": k[:120], "s": s, "count": c} for s, c, k in rows[:15]]}
    # the hand-written walk and tracking kernels by name, wherever they rank
    mine = {k: {"s": s_, "count": c_} for k, (s_, c_) in by_name.items()
            if any(n in k for n in ("walk_kernel", "track_kernel"))}
    rec["device"]["walk_and_track_kernels"] = mine
    print(f"package {rec['package']}", flush=True)
    print(f"device: kernel time {dev_s:.4f}s in {n_kernels} kernels over {n_iter[0]} "
          f"{'wave bounces' if wave_scene else 'wavefront iterations'} "
          f"({n_kernels / max(n_iter[0], 1):.1f} per iteration); untraced wall {wall_median:.4f}s -> busy "
          f"{100 * busy:.1f}%, idle {100 * (1 - busy):.1f}% (profiled wall {wall:.4f}s)", flush=True)
    for s, c, k in rows[:10]:
        print(f"  {s:.4f}s  x{c:6d}  {k[:100]}")
    for k, v in mine.items():
        print(f"  walk/track kernel {k[:80]}: {v['s']:.4f}s over {v['count']} launches "
              f"({1e3 * v['s'] / max(v['count'], 1):.4f} ms each)", flush=True)
    if cs.static.n_media:
        _grid_shares(args, cs, rec)


def _grid_shares(args, cs, rec):
    """A scene with media: one more render whose tracking calls each record
    their rays, the share of them in a grid medium, their steps and the
    longest ray's (host reads per launch, outside every timed render)."""
    import torch

    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import media

    grid = torch.as_tensor([i for i, k in enumerate(cs.static.media_kinds) if k == "heterogeneous"],
                           dtype=torch.int64, device=cs.arrays.device)
    shares = {"delta_track": [], "ratio_track": []}
    saved = {n: getattr(media, n) for n in shares}  # media calls them by these names

    def recording(name):
        fn = saved[name]

        def wrapped(sa, static, med, *a):
            out = fn(sa, static, med, *a)
            steps = out[-1]
            shares[name].append((int(med.shape[0]), int(torch.isin(med.long(), grid).sum()), int(steps.sum()),
                                 int(steps.max()) if steps.numel() else 0))
            return out
        return wrapped

    try:
        for n in shares:
            setattr(media, n, recording(n))
        R_.render_compiled(cs, seed=args.seed)
    finally:
        for n, fn in saved.items():
            setattr(media, n, fn)
    out = {}
    for n, rows in shares.items():
        if rows:
            share = [r[1] / max(r[0], 1) for r in rows]
            out[n] = {"launches": len(rows), "rays_per_launch": statistics.mean(r[0] for r in rows),
                      "grid_rays": sum(r[1] for r in rows), "share_mean": statistics.mean(share),
                      "share_min": min(share), "share_max": max(share),
                      "launches_without_a_grid_ray": sum(1 for r in rows if r[1] == 0),
                      "steps_per_grid_ray": sum(r[2] for r in rows) / max(sum(r[1] for r in rows), 1),
                      "longest_ray_steps_mean": statistics.mean(r[3] for r in rows),
                      "longest_ray_steps_max": max(r[3] for r in rows)}
            print(f"medium_track {n}: {json.dumps(out[n])}", flush=True)
    rec["medium_track_grid_shares"] = out


if __name__ == "__main__":
    sys.exit(main())
