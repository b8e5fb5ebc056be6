#!/usr/bin/env python3
"""Variants of the wide-BVH walk kernels, timed against the tree's kernels on
one CUDA GPU.

    python3 tools/walk_variants.py [--reps 20] [--only NAME ...] [--out FILE.json]

Each variant is a committed kernel source (csrc/wide_traverse.cu,
wide_traverse_joint.cu or megakernel_wide.cu, with csrc/*.cuh) with a few
lines replaced (VARIANTS below), written beside the build directory and
built with the tree's flags. It keeps the tree kernel's C interface, so it
runs through the same wrapper code. On the six ray sets of chip_smoke.py
phase 3 (the 123,650-triangle mesh room, 500,000 rays each) a traversal
variant must return the tree kernel's t, idx, b1, b2 and pops bit for bit,
and a B4 variant the tree B4's image, weights and path vertices on
material_room and the mesh room at 16 spp; then the two are timed with CUDA
events in turns (tree, variant, variant, tree), the traversal kernels with
ns per pop and the share of workers (lanes, or lane groups) holding a ray.
The variants are the walk's design questions:
 - b2_gw8: the cooperative kernel (B2) with 8 lanes per ray, one child and
   two leaf rows each, 4 rays per warp (the tree: 4 lanes per ray);
 - b1_child_entries, b4_child_entries: stack entries that carry the hit
   children's metas, pushed in reverse pop order as the children are
   tested, so a pop needs no meta load (the tree: (node, mask, direction)
   entries, the meta read from the parent's record);
 - b1_chunk32: B1's warps take ray ids 32 at a time and hand them to idle
   lanes from that reserve (the tree: exactly as many as it has idle
   lanes);
 - b1_refill1, 4, 16, 32 and b2_refill1, 2: a warp takes new rays once
   that many of its lanes (B1) or lane groups (B2) are idle, or all of them
   (the tree: REFILL_MIN = 8 lanes in B1, 4 groups in B2);
 - b1_fixed_grid: B1 as one thread per ray over a grid that covers the
   rays, the earlier B1's grid (the tree: persistent lanes over the queue);
 - b1_smem_top: the root's record and its interior children's records in
   shared memory, copied once per block with cp.async (the tree reads every
   record through L1);
 - b1_prefetch: a lane loads its next ray's data when it takes the id and
   starts the ray one iteration later, so the warp's other lanes do not
   wait on those loads;
 - b1_inner_loop, 16, 32: B1 popping in an inner loop with one ballot per
   pop until REFILL_MIN (8, 16, 32) lanes are idle, refilling between those
   loops (the tree checks for finished rays and refills at every pop);
 - b1_bounds10: B1 under __launch_bounds__(128, 10).
The variants live only here: no route builds them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

HEADER = "wide_traverse.cuh"

_CHILD_ENTRIES_POP = '''    ++r.pops;
    const int e = r.top;
    const int s = --r.sp;
    if (s > 0) r.top = stack[s - 1];

    if (e > 0) {
        // the children in reverse pop order; each hit child's meta is pushed
        // as it is found, the last one stays on top
        const int dirb = (r.dir_bits >> (e >> 21)) & 1;
        const float4* rec = reinterpret_cast<const float4*>(node_rec + (size_t)(e & 0x1FFFFF) * WT_NODE_REC);
        const int first = dirb ? 0 : 14, step = dirb ? 2 : -2;
        int cnt = 0, pending = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float4 a = __ldg(rec + first + i * step);
            const float4 b = __ldg(rec + first + i * step + 1);
            const int meta = __float_as_int(b.z);
            if (meta != 0 && wt_box(r, a, b)) {
                if (cnt > 0 && s + cnt - 1 < WT_STACK) stack[s + cnt - 1] = pending;
                pending = meta;
                ++cnt;
            }
        }
        if (cnt > 0) {
            if (s + cnt > WT_STACK) {
                atomicAdd(&counters[0], 1u);
            } else {
                r.top = pending;
                r.sp = s + cnt;
            }
        }
        return;
    }
'''

_CHUNK_TAKE = '''__shared__ int wt_reserve[32][2];  // per warp of the block: next id, end of its chunk

__device__ __forceinline__ int queue_take(unsigned idle, int me, int* queue, int n_rays, bool& drained) {
    int* res = wt_reserve[threadIdx.x >> 5];
    const int need = __popc(idle);
    const int next = res[0], left = res[1] - next;
    int fresh = 0;
    if (left < need) {
        if ((threadIdx.x & 31) == 0) fresh = atomicAdd(&queue[0], 32);
        fresh = __shfl_sync(0xffffffffu, fresh, 0);
    }
    const int k = __popc(idle & ((1u << me) - 1u));
    const int id = k < left ? next + k : fresh + (k - left);
    const int nnext = left < need ? fresh + (need - left) : next + need;
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
        res[0] = nnext;
        if (left < need) res[1] = fresh + 32;
    }
    __syncwarp();
    drained = nnext >= n_rays;
    return id;
}

// End of a block'''

_SMEM_TOP_DECL = '''#define WT_TOP 9  // the root and its (at most 8) interior children
__shared__ float4 wt_top_rec[WT_TOP][16];
__shared__ int wt_top_id[WT_TOP];

__device__ __forceinline__ float4 wt_rec_load(int slot, const float4* __restrict__ g, int i) {
    return slot >= 0 ? wt_top_rec[slot][i] : __ldg(g + i);
}

// One pop of a live ray'''

_SMEM_TOP_LOADS = '''        int slot = -1;
#pragma unroll
        for (int t = 0; t < WT_TOP; ++t) slot = wt_top_id[t] == (e & 0x1FFFFF) ? t : slot;
        int mask = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const float4 a = wt_rec_load(slot, rec, 2 * c);
            const float4 b = wt_rec_load(slot, rec, 2 * c + 1);'''

_SMEM_TOP_FILL = '''    WideRay r;
    r.sp = 0;
    {  // the top records into shared memory, once per block
        const int root = __float_as_int(__ldg(node_rec + 6)) & 0x1FFFFF;
        if (threadIdx.x < WT_TOP) {
            int id = root;
            if (threadIdx.x > 0) {
                const int m = __float_as_int(__ldg(node_rec + (size_t)root * WT_NODE_REC + (threadIdx.x - 1) * 8 + 6));
                id = m > 0 ? (m & 0x1FFFFF) : -1;
            }
            wt_top_id[threadIdx.x] = id;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < WT_TOP * 16; i += blockDim.x) {
            const int id = wt_top_id[i / 16];
            if (id >= 0) {
                const float4* src = reinterpret_cast<const float4*>(node_rec + (size_t)id * WT_NODE_REC) + i % 16;
                const unsigned dst = (unsigned)__cvta_generic_to_shared(&wt_top_rec[i / 16][i % 16]);
                asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(dst), "l"(src));
            }
        }
        asm volatile("cp.async.commit_group;\\ncp.async.wait_group 0;\\n" ::);
        __syncthreads();
    }'''

_FIXED_GRID_BODY = '''    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    WideRay r;
    r.sp = 0;
    int stack[WT_STACK];
    if (i < n_rays) {
        wide_init(r, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2], t_max[i],
                  any_hit != 0);
        wide_walk(r, stack, node_rec, leaf_rec, counters);
        out_t[i] = r.t_best;
        out_idx[i] = r.best_idx;
        out_b1[i] = r.b1;
        out_b2[i] = r.b2;
        out_pops[i] = r.pops;
    }
    // the warp pops as often as its longest walk
    const unsigned long long m = __reduce_max_sync(0xffffffffu, i < n_rays ? (unsigned)r.pops : 0u);
    if ((threadIdx.x & 31) == 0 && m) atomicAdd(iters, m);
}
'''

_PREFETCH_LOOP = '''    int ray = -1;  // the lane's ray id, -1 none
    int pend = -1;  // the lane's next ray id, its data loading into p*
    float po0 = 0.0f, po1 = 0.0f, po2 = 0.0f, pd0 = 0.0f, pd1 = 0.0f, pd2 = 0.0f, pt = 0.0f;
    bool drained = false;
    unsigned int n_iter = 0;
    for (;;) {
        if (ray >= 0 && r.sp == 0) {  // the lane's ray is done
            out_t[ray] = r.t_best;
            out_idx[ray] = r.best_idx;
            out_b1[ray] = r.b1;
            out_b2[ray] = r.b2;
            out_pops[ray] = r.pops;
            ray = -1;
        }
        if (pend >= 0) {  // its data was loaded in the last iteration
            ray = pend;
            pend = -1;
            wide_init(r, po0, po1, po2, pd0, pd1, pd2, pt, any_hit != 0);
        }
        const unsigned idle = __ballot_sync(0xffffffffu, ray < 0);
        if (idle != 0 && !drained && (__popc(idle) >= REFILL_MIN || idle == 0xffffffffu)) {
            const int id = queue_take(idle, lane, queue, n_rays, drained);
            if (ray < 0 && id < n_rays) {
                pend = id;
                po0 = o[3 * id];
                po1 = o[3 * id + 1];
                po2 = o[3 * id + 2];
                pd0 = d[3 * id];
                pd1 = d[3 * id + 1];
                pd2 = d[3 * id + 2];
                pt = t_max[id];
            }
        }
        const bool live = r.sp > 0;
        if (__ballot_sync(0xffffffffu, live) == 0) {
            if (drained && __ballot_sync(0xffffffffu, ray >= 0 || pend >= 0) == 0) break;
            continue;
        }
        ++n_iter;
        if (live) wide_pop(r, stack, node_rec, leaf_rec, counters);
    }
'''


_INNER_LOOP = '''    int ray = -1;  // the lane's ray id, -1 none
    bool drained = false;  // warp-uniform: the queue holds no ray for it
    unsigned int n_iter = 0;
    for (;;) {
        if (ray >= 0 && r.sp == 0) {  // the lane's ray is done
            out_t[ray] = r.t_best;
            out_idx[ray] = r.best_idx;
            out_b1[ray] = r.b1;
            out_b2[ray] = r.b2;
            out_pops[ray] = r.pops;
            ray = -1;
        }
        const unsigned idle = __ballot_sync(0xffffffffu, ray < 0);
        if (drained && idle == 0xffffffffu) break;
        if (idle != 0 && !drained) {
            const int id = queue_take(idle, lane, queue, n_rays, drained);
            if (ray < 0 && id < n_rays) {
                ray = id;
                wide_init(r, o[3 * id], o[3 * id + 1], o[3 * id + 2], d[3 * id], d[3 * id + 1], d[3 * id + 2],
                          t_max[id], any_hit != 0);
            }
        }
        // walk until REFILL_MIN lanes are free (all of them once the queue is drained)
        for (;;) {
            const unsigned lv = __ballot_sync(0xffffffffu, r.sp > 0);
            if (lv == 0 || (!drained && __popc(lv) <= 32 - REFILL_MIN)) break;
            ++n_iter;
            if (r.sp > 0) wide_pop(r, stack, node_rec, leaf_rec, counters);
        }
    }
'''


def _between(src: str, start: str, end: str, new: str) -> str:
    """src with the text from `start` up to (not including) `end` replaced."""
    i = src.index(start)
    j = src.index(end, i)
    return src[:i] + new + src[j:]


def _replace(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise RuntimeError(f"variant patch does not apply: {old[:60]!r}")
    return src.replace(old, new)


def _child_entries(s):
    """The header with child-meta stack entries; wide_init seeds the root's
    meta from record 0, so it takes node_rec."""
    s = _replace(s, "float t_max, bool any_hit) {", "float t_max, bool any_hit,\n"
                 "                                          const float* __restrict__ node_rec) {")
    s = _replace(s, "r.top = (0 << 9) | (1 << 1) | 0;", "r.top = __float_as_int(__ldg(node_rec + 6));")
    return _between(s, "    ++r.pops;\n    const int e = wt_pop_meta(r, stack, node_rec);",
                    "    // leaf: its n valid rows, in order j", _CHILD_ENTRIES_POP)


def _refill(n):
    return lambda s: re.sub(r"#define REFILL_MIN \d+ ", f"#define REFILL_MIN {n} ", s, count=1)


# name -> (tree kernel: "b1", "b2" or "b4", {file: patch(text) -> text})
VARIANTS = {
    "b2_gw8": ("b2", {"wide_traverse_joint.cu": lambda s: _replace(s, "#define GW 4 ", "#define GW 8 ")}),
    "b1_child_entries": ("b1", {HEADER: _child_entries, "wide_traverse.cu": lambda s: _replace(
        s, "t_max[id], any_hit != 0);", "t_max[id], any_hit != 0, node_rec);")}),
    "b4_child_entries": ("b4", {HEADER: _child_entries, "megakernel_wide.cu": lambda s: _replace(_replace(
        s, "fld(st, F_TMAX, slot), true);", "fld(st, F_TMAX, slot), true, node_rec);"),
        "                                  false);", "                                  false, node_rec);")}),
    "b1_chunk32": ("b1", {HEADER: lambda s: _between(s, "__device__ __forceinline__ int queue_take(",
                                                     "// End of a block", _CHUNK_TAKE),
                          "wide_traverse.cu": lambda s: _replace(
                              s, "    WideRay r;\n    r.sp = 0;", "    WideRay r;\n    r.sp = 0;\n"
                              "    if ((threadIdx.x & 31) == 0) wt_reserve[threadIdx.x >> 5][0] = "
                              "wt_reserve[threadIdx.x >> 5][1] = 0;\n    __syncwarp();")}),
    "b1_refill1": ("b1", {"wide_traverse.cu": _refill(1)}),
    "b1_refill4": ("b1", {"wide_traverse.cu": _refill(4)}),
    "b1_refill16": ("b1", {"wide_traverse.cu": _refill(16)}),
    "b1_refill32": ("b1", {"wide_traverse.cu": _refill(32)}),
    "b2_refill1": ("b2", {"wide_traverse_joint.cu": _refill(1)}),
    "b2_refill2": ("b2", {"wide_traverse_joint.cu": _refill(2)}),
    "b1_fixed_grid": ("b1", {"wide_traverse.cu": lambda s: _replace(_between(
        s, "    const int lane = threadIdx.x & 31;\n    WideRay r;", "// queue: two int32", _FIXED_GRID_BODY + "\n"),
        "wt_grid((const void*)wide_traverse_kernel, THREADS, n_rays, THREADS, &blocks);",
        "cudaSuccess; blocks = (n_rays + THREADS - 1) / THREADS;")}),
    "b1_smem_top": ("b1", {
        HEADER: lambda s: _replace(_replace(s, "// One pop of a live ray", _SMEM_TOP_DECL), '''        int mask = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const float4 a = __ldg(rec + 2 * c);
            const float4 b = __ldg(rec + 2 * c + 1);''', _SMEM_TOP_LOADS),
        "wide_traverse.cu": lambda s: _replace(s, "    WideRay r;\n    r.sp = 0;", _SMEM_TOP_FILL)}),
    "b1_prefetch": ("b1", {"wide_traverse.cu": lambda s: _between(
        s, "    int ray = -1;  // the lane's ray id, -1 none", "    queue_finish(queue, iters, n_iter);",
        _PREFETCH_LOOP)}),
    "b1_inner_loop": ("b1", {"wide_traverse.cu": lambda s: _between(
        s, "    int ray = -1;  // the lane's ray id, -1 none", "    queue_finish(queue, iters, n_iter);", _INNER_LOOP)}),
    "b1_inner_loop16": ("b1", {"wide_traverse.cu": lambda s: _refill(16)(_between(
        s, "    int ray = -1;  // the lane's ray id, -1 none", "    queue_finish(queue, iters, n_iter);", _INNER_LOOP))}),
    "b1_inner_loop32": ("b1", {"wide_traverse.cu": lambda s: _refill(32)(_between(
        s, "    int ray = -1;  // the lane's ray id, -1 none", "    queue_finish(queue, iters, n_iter);", _INNER_LOOP))}),
    "b1_bounds10": ("b1", {"wide_traverse.cu": lambda s: _replace(
        s, "__global__ void __launch_bounds__(THREADS)", "__global__ void __launch_bounds__(THREADS, 10)")}),
}


class _Kernel:
    """A variant's launch, with the attributes wide_bvh._launch counts on."""

    def __init__(self, name, fn):
        self.__name__ = name
        self.fn = fn
        self.launches = 0
        self.counters, self.iterations, self.queues = {}, {}, {}

    def __call__(self, tables, o, d, t_max, any_hit):
        from pbrt_tpu_torch.device import wide_bvh

        return wide_bvh._launch(self, self.fn, tables, o, d, t_max, any_hit)


def _write_variant(name: str) -> Path:
    """The variant's sources in the build directory; returns its kernel source."""
    from pbrt_tpu_torch.device import nvcc

    base, patches = VARIANTS[name]
    source = {"b1": "wide_traverse.cu", "b2": "wide_traverse_joint.cu", "b4": "megakernel_wide.cu"}[base]
    out = nvcc.BUILD_DIR / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for f in (source, HEADER) + (("pt_common.cuh",) if base == "b4" else ()):
        text = (nvcc.CSRC / f).read_text()
        if f in patches:
            text = patches[f](text)
        (out / f).write_text(text)
    return out / source


def _b4_cases(cs_mesh):
    """(label, tables, blob, mode, lanes, spp) of B4 on material_room and the
    mesh room at their 1000x500, 16 spp renders (chip_smoke phases 11, 14)."""
    import torch

    from pbrt_tpu_torch.device import megakernel_wide as mw
    from pbrt_tpu_torch.device.camera import make_camera
    from pbrt_tpu_torch.scene.builder import compile_scene
    from pbrt_tpu_torch.scenes import material_room

    cases = []
    for label, cs in (("material_room", compile_scene(material_room(), "cuda")), ("mesh room", cs_mesh)):
        desc = cs.description
        icfg = {"kind": "path", "max_depth": desc.integrator.max_depth, "rr_threshold": desc.integrator.rr_threshold,
                "light_strategy": desc.integrator.light_strategy}
        fcfg = {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")}
        consts = mw.extract_wide_consts(cs, make_camera(desc.camera, desc.film, "cuda"), icfg,
                                        {"kind": desc.sampler.kind, "spp": desc.sampler.pixel_samples}, fcfg, 200000)
        W, H = desc.film.x_resolution, desc.film.y_resolution
        idx = torch.arange(W * H, device="cuda")
        cases.append((label, cs.arrays, mw.pack_wide_consts(consts).to("cuda"), mw.kernel_mode(consts),
                      (idx % W, idx // W, idx), desc.sampler.pixel_samples))
    return cases


def _b4_run(info):
    """B4's launch through megakernel_wide's wrapper, with the library of
    `info` (None: the tree's)."""
    from pbrt_tpu_torch.device import megakernel_wide as mw

    if info is not None:
        info["lib"].wide_megakernel.argtypes = mw._ARGTYPES
        info["lib"].wide_megakernel.restype = ctypes.c_int

    def run(tables, blob, mode, lanes, spp):
        saved = mw.build_kernel
        if info is not None:
            mw.build_kernel = lambda: info
        try:
            return mw.wide_megakernel_cuda(blob, mode, tables, *lanes, 0, spp, 0)
        finally:
            mw.build_kernel = saved

    return run


def _time_b4(name, info, cases, reps):
    import torch

    import chip_smoke

    tree, var = _b4_run(None), _b4_run(info)
    rows = []
    for label, tables, blob, mode, lanes, spp in cases:
        a, b = tree(tables, blob, mode, lanes, spp), var(tables, blob, mode, lanes, spp)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"variant {name} differs from the tree's B4 on {label}")
        turns = [chip_smoke._cuda_ms(lambda: k(tables, blob, mode, lanes, spp), reps) for k in (tree, var, var, tree)]
        rows.append({"scene": label, "tree_ms": [turns[0], turns[3]], "variant_ms": turns[1:3],
                     "path_vertices": a[2].double().sum().item()})
        print(f"  {label}: tree {turns[0]:.4f} / {turns[3]:.4f} ms, variant {turns[1]:.4f} / {turns[2]:.4f} ms "
              f"({(turns[1] + turns[2]) / (turns[0] + turns[3]):.3f}x)", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="*", choices=list(VARIANTS), help="variants to run (default: all)")
    ap.add_argument("--out", help="also write the record as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("walk_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from pbrt_tpu_torch.device import megakernel_wide, nvcc, wide_bvh
    from pbrt_tpu_torch.scene.builder import compile_scene
    from pbrt_tpu_torch.scenes import mesh_room

    names = args.only or list(VARIANTS)
    rec = {"device": torch.cuda.get_device_name(0), "nvidia_smi": chip_smoke._smi(), "reps": args.reps,
           "variants": {}}
    print(f"walk_variants: {rec['device']}; nvidia-smi: {rec['nvidia_smi']}", flush=True)
    paths = {n: _write_variant(n) for n in names}
    built = nvcc.build_all([wide_bvh.KERNEL_SOURCE, wide_bvh.JOINT_SOURCE, megakernel_wide.KERNEL_SOURCE,
                            *paths.values()])
    tree = {"b1": (wide_bvh.build_kernel(), wide_bvh.traverse_cuda, "wide_traverse", 32),
            "b2": (wide_bvh.build_joint_kernel(), wide_bvh.traverse_joint_cuda, "wide_traverse_joint",
                   32 // wide_bvh.joint_group_width())}

    def report(info, entry):
        regs = sorted(set(re.findall(r"Used \d+ registers[^\n]*", info["log"])))
        occ = nvcc.occupancy(getattr(info["lib"], entry + "_occupancy"))
        return regs, occ

    for base, (info, _k, entry, _w) in tree.items():
        regs, occ = report(info, entry)
        print(f"[tree {base}] ptxas {regs}; blocks per SM {occ}", flush=True)
    cs = compile_scene(mesh_room(248), "cuda")
    sa = cs.arrays
    ray_sets = chip_smoke._rays(cs)
    b4_cases = None
    for name in names:
        base = VARIANTS[name][0]
        info = built[paths[name]]
        if base == "b4":
            regs = sorted(set(re.findall(r"Used \d+ registers[^\n]*|\d+ bytes spill stores", info["log"])))
            occ = nvcc.occupancy(info["lib"].wide_megakernel_occupancy, 1)
            print(f"[{name}] ptxas {regs}; blocks per SM {occ}", flush=True)
            b4_cases = b4_cases or _b4_cases(cs)
            rows = _time_b4(name, info, b4_cases, 3)
            rec["variants"][name] = {"base": base, "ptxas": regs, "blocks_per_sm": occ, "rows": rows}
            continue
        info_t, tree_k, entry, workers_t = tree[base]
        fn = getattr(info["lib"], entry)
        fn.argtypes = wide_bvh._ARGTYPES
        fn.restype = ctypes.c_int
        var_k = _Kernel(name, fn)
        workers = 4 if name == "b2_gw8" else workers_t
        regs, occ = report(info, entry)
        print(f"[{name}] ptxas {regs}; blocks per SM {occ}", flush=True)
        rows = []
        for set_name, o, d, t_max in ray_sets:
            for any_hit in (False, True):
                label = f"{set_name}/{'any' if any_hit else 'closest'}"
                share_t, res_t = chip_smoke._lane_share(tree_k, workers_t, sa, o, d, t_max, any_hit)
                share_v, res_v = chip_smoke._lane_share(var_k, workers, sa, o, d, t_max, any_hit)
                if not all(torch.equal(x, y) for x, y in zip(res_t, res_v)):
                    raise AssertionError(f"variant {name} differs from the tree's {base} on {label}")
                if any(k.counters[torch.device("cuda", 0)].tolist() != [0, 0] for k in (var_k,)):
                    raise AssertionError(f"variant {name}: stack overflows / iteration-cap hits")
                turns = []
                for k in (tree_k, var_k, var_k, tree_k):
                    turns.append(chip_smoke._cuda_ms(lambda: k(sa, o, d, t_max, any_hit), args.reps))
                ms_t, ms_v = statistics.mean([turns[0], turns[3]]), statistics.mean(turns[1:3])
                pops = res_t[4].double().sum().item()
                rows.append({"rays": label, "tree_ms": [turns[0], turns[3]], "variant_ms": turns[1:3],
                             "pops": pops, "tree_share": share_t, "variant_share": share_v})
                print(f"  {label}: tree {turns[0]:.4f} / {turns[3]:.4f} ms, variant {turns[1]:.4f} / {turns[2]:.4f} "
                      f"ms ({ms_v / ms_t:.3f}x); ns per pop {1e6 * ms_t / pops:.4f} vs {1e6 * ms_v / pops:.4f}; "
                      f"workers with a ray {share_t:.4f} vs {share_v:.4f}", flush=True)
        tot_t = sum(statistics.mean(r["tree_ms"]) for r in rows)
        tot_v = sum(statistics.mean(r["variant_ms"]) for r in rows)
        print(f"[{name}] six sets: tree {tot_t:.4f} ms, variant {tot_v:.4f} ms ({tot_v / tot_t:.3f}x)", flush=True)
        rec["variants"][name] = {"base": base, "ptxas": regs, "blocks_per_sm": occ, "rows": rows,
                                 "tree_ms_total": tot_t, "variant_ms_total": tot_v}
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
    print(json.dumps({"ok": True, "nvidia_smi": rec["nvidia_smi"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
