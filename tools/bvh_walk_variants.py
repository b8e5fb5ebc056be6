#!/usr/bin/env python3
"""The binary BVH walk and the kd walk (csrc/bvh_walk.cu) against an earlier
design and against variants of themselves, timed on one CUDA GPU.

    python3 tools/bvh_walk_variants.py [--walk bvh|kd] [--parent DIR] [--reps 10] [--only NAME ...]
                                       [--out FILE.json]

--walk kd (the kd walk; below, "The kd walk") or bvh (the default: this
paragraph and the next ones).

--parent DIR: the root of a checkout of an earlier commit (a `git archive`)
whose csrc/bvh_walk.cu has the parent design's C interface (one thread per
ray over bvh_packed and prim_test_data, no ray queue): its library is built
from DIR and run as the variant "parent".

Each other variant is the tree's csrc/bvh_walk.cu with a few lines replaced
(VARIANTS below), one lever of the design undone or moved, written beside
the build directory and built with the tree's flags; it keeps the tree's C
interface, so it runs through the same wrapper. The rays are chip_smoke.py
phase 34's six sets on quadric_room(248) (camera, bounce and shadow rays,
closest and any hit, 500,000 each) and phase 43's 500,000 camera rays of
motion_room(248) at their shutter times (the motion entry, MOTION 2).
Before any timing a variant must return the tree's t, prim, b1, b2 and
pops bit for bit; the parent must return the tree's t, prim, b1 and b2 on
every ray and its pops on the closest-hit sets (its pops are the nodes it
popped and tested; the tree's, the boxes it tested: the two counts agree
wherever no walk stops early), and its instrumented entry must count the
tree's prim tests and mark the tree's rows on the camera rays (the bound's
count). Then the two are timed with CUDA events in turns (the tree,
variant, variant, tree; the parent, tree, tree, parent), with ns per ray,
and the share of lanes holding a ray of each (one lane per ray in a fixed
grid: a warp loops as often as its longest walk; a queue variant: node
visits / (32 x its warps' loop iterations), from a counter of its own).
The variants, each one lever:
 - queue: persistent lanes over a ray queue (B1's queue_take and
   queue_finish, wide_traverse.cuh), refilled once 8 lanes of a warp are
   idle; queue_inner16: the same lanes visiting in an inner loop with one
   ballot per visit, refilled once 16 are idle (the tree: one thread per
   ray over a grid that covers the rays);
 - bounds8, bounds6, bounds_none: __launch_bounds__(128, 8), (128, 6),
   (128) (the tree: BW_MIN_BLOCKS = 7);
 - smem_stack32: the far-child stack in shared memory, 32 entries (the
   tree: 64 entries in local memory; a variant whose stack overflows
   fails its gate);
 - no_caches: the instanced ray and the motion group's M(dt) computed for
   every candidate prim (the tree: once per (ray, instance), (ray, group));
 - ptd_triangles: a triangle's vertices read from its prim_test_data row
   with scalar loads (the tree: the 48-byte walk row as three float4).
A variant that fails to build or to pass its gate is reported and skipped.
The variants live only here: no route builds them.

The kd walk (--walk kd): phase 34's six sets on quadric_room(40)'s kd
variant and phase 43's kd motion rooms' 500,000 camera rays at their
shutter times (chip_smoke.KD_MOTION_ROOM_ARGS: MOTION 2, and MOTION 1 on the
keyframe room). --parent DIR: a checkout whose kd entries have the parent
design's C interface (the kd_* tables, prim_test_data and prim_kind; a
96-entry stack); every variant and the parent must return the tree's t,
prim, b1, b2 and pops (the nodes visited) bit for bit on every set, then
each is timed in turns as above. The kd variants, each one lever:
 - kd_node_tables: each node from the kd_* tables (kd_flags, then
   kd_split and kd_above, or a leaf's kd_above and kd_nprims: dependent
   scalar loads) in place of its 8-byte record;
 - kd_leaf_ids: each leaf candidate through kd_prim_ids into its
   prim_test_data row, prim_kind and anim_gid (scalar loads) in place of
   the leaf's contiguous 48-byte rows;
 - kd_stack96, kd_stack32: the todo stack 96 or 32 entries deep (the
   tree: KD_STACK = 48);
 - kd_bounds6, kd_bounds8, kd_bounds_none: the static instantiation under
   __launch_bounds__(128, 6), (128, 8), (128) (the tree: KD_MIN_BLOCKS =
   7); kd_motion_bounds6, kd_motion_bounds7: the motion ones under (128,
   6), (128, 7) (the tree: no cap, KD_MIN_BLOCKS_MOTION = 1);
 - kd_queue, kd_queue16: persistent lanes over a ray queue (B1's), a warp
   refilled once 8 (16) of its lanes are idle, one node visit per
   iteration (the tree: one thread per ray over a grid that covers the
   rays); its share of lanes holding a ray from a counter of its own;
 - kd_no_cache: the motion group's M(dt) for every candidate (the tree:
   once per (ray, group)).
Both kd_node_tables and kd_leaf_ids read the tables through pointers a
C entry of the variant (kd_variant_tables) sets before the launches.
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
sys.path.insert(0, str(ROOT / "tools"))

SOURCE = "bvh_walk.cu"
HEADERS = ("quadric.cuh", "wide_traverse.cuh")

_KERNEL_HEAD = '''template <bool COUNT, int MOTION>
__global__ void __launch_bounds__(THREADS, BW_MIN_BLOCKS)
bvh_walk_kernel(const float* __restrict__ o_in, const float* __restrict__ d_in, const float* __restrict__ t_max_in,
                int n_rays, BwTables tb, int any_hit, float* __restrict__ out_t, int* __restrict__ out_prim,
                float* __restrict__ out_b1, float* __restrict__ out_b2, int* __restrict__ out_pops,
                unsigned int* __restrict__ counters, int* __restrict__ out_tests, BwMotion mo) {
'''

_WRITE = '''            out_t[ray] = w.t_best;
            out_prim[ray] = w.prim;
            out_b1[ray] = w.b1;
            out_b2[ray] = w.b2;
            out_pops[ray] = w.pops;
            if (COUNT) {
                out_tests[4 * ray] = w.n_tri;
                out_tests[4 * ray + 1] = w.n_quad;
                out_tests[4 * ray + 2] = w.n_inst;
                out_tests[4 * ray + 3] = w.visits;
            }
'''

_QUEUE_HEAD = '''__device__ int bw_queue[2];  // the ray queue: zero at load, re-zeroed by each launch's last block
__device__ unsigned long long bw_iters;  // the warps' loop iterations (bvh_walk_iterations)

''' + _KERNEL_HEAD + '''    int* queue = bw_queue;
    const int lane = threadIdx.x & 31;
    BwWalk w;
    w.live = false;
    int2 stack[BW_STACK];
    int st_row[COUNT ? BW_STACK : 1];
    int ray = -1;
    bool drained = false;
    unsigned int n_iter = 0;
    for (;;) {
        if (ray >= 0 && !w.live) {
''' + _WRITE + '''            ray = -1;
        }
        const unsigned idle = __ballot_sync(0xffffffffu, ray < 0);
'''

# persistent lanes over a ray queue (B1's queue_take, queue_finish): a lane
# whose ray is done writes it; once BW_REFILL_MIN lanes of the warp are idle
# (or all of them) the warp takes that many ray ids; each iteration visits
# one node of every live lane's ray
_QUEUE = _QUEUE_HEAD + '''        if (idle != 0 && !drained && (__popc(idle) >= BW_REFILL_MIN || idle == 0xffffffffu)) {
            const int id = queue_take(idle, lane, queue, n_rays, drained);
            if (ray < 0 && id < n_rays) {
                ray = id;
                bw_start<COUNT, MOTION>(w, id, o_in, d_in, t_max_in, tb, mo);
            }
        }
        const bool live = w.live;
        if (__ballot_sync(0xffffffffu, live) == 0) {
            if (drained && __ballot_sync(0xffffffffu, ray >= 0) == 0) break;
            continue;
        }
        ++n_iter;
        if (live) bw_visit<COUNT, MOTION>(w, stack, st_row, tb, any_hit != 0, counters, mo);
    }
    queue_finish(queue, &bw_iters, n_iter);
}

'''

# the same lanes, visiting in an inner loop with one ballot per visit until
# BW_REFILL_MIN lanes are free (all of them once the queue is drained)
_QUEUE_INNER = _QUEUE_HEAD + '''        if (drained && idle == 0xffffffffu) break;
        if (idle != 0 && !drained) {
            const int id = queue_take(idle, lane, queue, n_rays, drained);
            if (ray < 0 && id < n_rays) {
                ray = id;
                bw_start<COUNT, MOTION>(w, id, o_in, d_in, t_max_in, tb, mo);
            }
        }
        for (;;) {
            const unsigned lv = __ballot_sync(0xffffffffu, w.live);
            if (lv == 0 || (!drained && __popc(lv) <= 32 - BW_REFILL_MIN)) break;
            ++n_iter;
            if (w.live) bw_visit<COUNT, MOTION>(w, stack, st_row, tb, any_hit != 0, counters, mo);
        }
    }
    queue_finish(queue, &bw_iters, n_iter);
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


# the queue variants' counter: bvh_walk_iterations(out) copies the warps'
# loop iterations summed since the last call to *out and zeroes them
_ITERATIONS = '''
extern "C" int bvh_walk_iterations(unsigned long long* out) {
    const unsigned long long zero = 0;
    cudaError_t e = cudaMemcpyFromSymbol(out, bw_iters, sizeof(zero));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(bw_iters, &zero, sizeof(zero));
    return (int)e;
}
'''


def _queue(body, refill):
    """The kernel as persistent lanes over a ray queue (body: _QUEUE or
    _QUEUE_INNER), the grid the resident blocks (wide_traverse.cuh), with
    a counter of its warps' loop iterations (_ITERATIONS)."""
    def patch(s):
        s = _replace(s, '#include "quadric.cuh"\n', '#include "quadric.cuh"\n#include "wide_traverse.cuh"\n'
                     f"#define BW_REFILL_MIN {refill}\n")
        s = _between(s, "// One thread per ray over a grid that covers the rays", "// One todo entry of the kd walk",
                     body)
        return _replace(s, "        const int blocks = (n_rays + THREADS - 1) / THREADS;\n        bvh_walk_kernel",
                        "        int blocks = 0;\n        const int err = wt_grid((const void*)bvh_walk_kernel<COUNT, "
                        "MOTION>, THREADS, n_rays, THREADS, &blocks);\n        if (err != 0) return err;\n"
                        "        bvh_walk_kernel") + _ITERATIONS
    return patch


def _smem_stack(entries):
    """The far-child stack in shared memory, entries deep, one column per
    thread (the tree: BW_STACK entries in local memory)."""
    def patch(s):
        s = re.sub(r"#define BW_STACK \d+ ", f"#define BW_STACK {entries} ", s, count=1)
        s = _replace(s, "    BwWalk w;\n    int2 stack[BW_STACK];\n",
                     "    BwWalk w;\n    __shared__ int2 bw_sstack[BW_STACK][THREADS];\n"
                     "    int2* stack = &bw_sstack[0][threadIdx.x];\n")
        s = _replace(s, "stack[w.sp] = make_int2(", "stack[w.sp * THREADS] = make_int2(")
        return _replace(s, "const int2 e = stack[--w.sp];", "const int2 e = stack[(--w.sp) * THREADS];")
    return patch


def _define(name, value):
    return lambda s: re.sub(rf"#define {name} \d+ ", f"#define {name} {value} ", s, count=1)


# name -> patch(text of csrc/bvh_walk.cu) -> text
VARIANTS = {
    "queue": _queue(_QUEUE, 8),
    "queue_inner16": _queue(_QUEUE_INNER, 16),
    "bounds8": _define("BW_MIN_BLOCKS", 8),
    "bounds6": _define("BW_MIN_BLOCKS", 6),
    "bounds_none": lambda s: _replace(s, "void __launch_bounds__(THREADS, BW_MIN_BLOCKS)",
                                      "void __launch_bounds__(THREADS)"),
    "smem_stack32": _smem_stack(32),
    "no_caches": lambda s: _replace(_replace(s, "if (iid != 0 && iid != w.c_iid) {", "if (iid != 0) {"),
                                    "if (gid != w.c_gid) {", "{"),
    "ptd_triangles": lambda s: _replace(
        s, "const float v[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};\n"
        "            float t, c1, c2;\n            if (bw_test<MOTION>(iid != 0",
        "const float* vr = tb.ptd + (size_t)p * tb.cols;\n"
        "            const float v[9] = {__ldg(vr), __ldg(vr + 1), __ldg(vr + 2), __ldg(vr + 3), __ldg(vr + 4),\n"
        "                                __ldg(vr + 5), __ldg(vr + 6), __ldg(vr + 7), __ldg(vr + 8)};\n"
        "            (void)q0;\n            (void)q1;\n"
        "            float t, c1, c2;\n            if (bw_test<MOTION>(iid != 0"),
}

# the parent design's C interface (one thread per ray, no queue): o, d,
# t_max, n_rays, nodes, ptd, cols, prim_kind, prim_inst, inst_w2i,
# max_leaf, any_hit, t, prim, b1, b2, pops, counters, stream
_PARENT_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7)


def _write_variant(name: str) -> Path:
    """The variant's source and the headers in the build directory; returns its source."""
    from pbrt_tpu_torch.device import nvcc

    out = nvcc.BUILD_DIR / "variants" / f"bvh_walk_{name}"
    out.mkdir(parents=True, exist_ok=True)
    for f in (SOURCE,) + HEADERS:
        text = (nvcc.CSRC / f).read_text()
        (out / f).write_text(VARIANTS[name](text) if f == SOURCE else text)
    return out / SOURCE


class _Variant:
    """A variant's library launched through device/bvh_walk.py's wrapper
    code, with the wrapper's attributes of its own."""

    def __init__(self, name, info, motion):
        from pbrt_tpu_torch.device import bvh_walk

        self.__name__ = name
        self.info = info
        self.entry = "bvh_walk_motion" if motion else "bvh_walk"
        lib = info["lib"]
        for e, extra in (("bvh_walk", []), ("bvh_walk_counted", [ctypes.c_void_p] * 4),
                         ("bvh_walk_motion", bvh_walk._MOTION_ARGTYPES),
                         ("bvh_walk_motion_counted", bvh_walk._MOTION_ARGTYPES + [ctypes.c_void_p] * 4)):
            getattr(lib, e).argtypes = bvh_walk._BVH_ARGTYPES + extra
            getattr(lib, e).restype = ctypes.c_int
        self.launches, self.counters = 0, {}

    def __call__(self, sa, st, o, d, t_max, any_hit, time=None, prim_tests=None, rows_read=None):
        from pbrt_tpu_torch.device import bvh_walk

        R, counters, outs, stream = bvh_walk._outputs(self, o, d, t_max)
        args = bvh_walk._bvh_args(sa, o, d, t_max, any_hit, outs, counters, stream)
        if time is not None:
            args += bvh_walk._motion_args(sa, st, time, R, o.device)
        saved = bvh_walk.build_kernel
        bvh_walk.build_kernel = lambda: self.info
        try:
            return bvh_walk._launch_bvh(self, self.entry, sa, args, R, o.device, prim_tests, rows_read, outs)
        finally:
            bvh_walk.build_kernel = saved


class _Parent:
    """The parent design's library (one thread per ray over bvh_packed and
    prim_test_data) with its own argument list."""

    def __init__(self, info, motion):
        from pbrt_tpu_torch.device import bvh_walk

        self.__name__ = "parent"
        self.lib = info["lib"]
        self.entry = "bvh_walk_motion" if motion else "bvh_walk"
        for e, extra in (("bvh_walk", []), ("bvh_walk_counted", [ctypes.c_void_p] * 4),
                         ("bvh_walk_motion", bvh_walk._MOTION_ARGTYPES),
                         ("bvh_walk_motion_counted", bvh_walk._MOTION_ARGTYPES + [ctypes.c_void_p] * 4)):
            getattr(self.lib, e).argtypes = _PARENT_ARGTYPES + extra
            getattr(self.lib, e).restype = ctypes.c_int
        self.launches, self.counters = 0, {}

    def __call__(self, sa, st, o, d, t_max, any_hit, time=None, prim_tests=None, rows_read=None):
        from pbrt_tpu_torch.device import bvh_walk

        R, counters, outs, stream = bvh_walk._outputs(self, o, d, t_max)
        t, prim, b1, b2, pops = outs
        args = [o.data_ptr(), d.data_ptr(), t_max.data_ptr(), R, sa.bvh_packed.data_ptr(),
                sa.prim_test_data.data_ptr(), sa.prim_test_data.shape[1], sa.prim_kind.data_ptr(),
                sa.prim_inst.data_ptr(), sa.inst_w2i.data_ptr(), int(st.max_leaf), int(bool(any_hit)), t.data_ptr(),
                prim.data_ptr(), b1.data_ptr(), b2.data_ptr(), pops.data_ptr(), counters.data_ptr(), stream]
        if time is not None:
            args += bvh_walk._motion_args(sa, st, time, R, o.device)
        entry = self.entry
        if prim_tests is not None:
            entry += "_counted"
            args += [prim_tests.data_ptr(), *(x.data_ptr() for x in rows_read)]
        err = getattr(self.lib, entry)(*args)
        if err != 0:
            raise RuntimeError(f"parent {entry} launch failed: cudaError {err}")
        return outs


def _ptxas(info) -> list[dict]:
    import ptxas_report

    return [{k: r[k] for k in ("template", "registers", "spill_stores", "spill_loads", "stack_frame")}
            for r in ptxas_report.parse(info["log"]) if "bvh_walk_kernel" in r["function"]]


def _occupancy(info, motion) -> int:
    from pbrt_tpu_torch.device import nvcc

    return nvcc.occupancy(info["lib"].bvh_walk_occupancy, 0, motion)


def _counted(walk, sa, st, o, d, t_max, time=None, any_hit=False):
    """One instrumented launch: (outputs, prim tests (R, 3 or 4), the row marks)."""
    import torch

    dev = o.device
    cols = 4 if walk.__name__ != "parent" else 3
    tests = torch.zeros((o.shape[0], cols), dtype=torch.int32, device=dev)
    seen = tuple(torch.zeros(n, dtype=torch.int32, device=dev)
                 for n in (sa.bvh_packed.shape[0], sa.prim_test_data.shape[0], sa.inst_w2i.shape[0]))
    res = walk(sa, st, o, d, t_max, any_hit, time=time, prim_tests=tests, rows_read=seen)
    return res, tests, seen


def _share(walk, sa, st, o, d, t_max, any_hit, time, visits):
    """The share of lanes holding a ray. One lane per ray in a fixed grid
    (the tree, the parent and every variant but the queues): a warp loops
    as often as its longest walk, chip_smoke._warp_share of the node visits
    (the parent's: its pops, one node per loop). A queue variant: the node
    visits over 32 x its warps' loop iterations in one launch, read from
    its own counter."""
    import chip_smoke

    if walk.__name__ == "parent":
        return chip_smoke._warp_share(walk(sa, st, o, d, t_max, any_hit, time=time)[4])
    if not walk.__name__.startswith("queue"):
        return chip_smoke._warp_share(visits)
    n_iter = ctypes.c_ulonglong(0)
    read = walk.info["lib"].bvh_walk_iterations
    if read(ctypes.byref(n_iter)) != 0:
        raise RuntimeError("bvh_walk_iterations failed")
    walk(sa, st, o, d, t_max, any_hit, time=time)
    if read(ctypes.byref(n_iter)) != 0:
        raise RuntimeError("bvh_walk_iterations failed")
    return float(visits.double().sum()) / max(32.0 * float(n_iter.value), 1.0)


# the kd variants' tables: pointers in constant memory that kd_variant_tables
# sets (kd_flags, kd_split, kd_above, kd_nprims, kd_prim_ids, prim_kind, anim_gid)
_KD_TABLES = '''
__constant__ const int* kdv_flags;
__constant__ const float* kdv_split;
__constant__ const int* kdv_above;
__constant__ const int* kdv_nprims;
__constant__ const int* kdv_prim_ids;
__constant__ const int* kdv_prim_kind;
__constant__ const int* kdv_anim_gid;
'''

_KD_TABLES_ENTRY = '''
extern "C" int kd_variant_tables(const void* flags, const void* split, const void* above, const void* nprims,
                                 const void* prim_ids, const void* prim_kind, const void* anim_gid) {
    const void* p[7] = {flags, split, above, nprims, prim_ids, prim_kind, anim_gid};
    const void* syms[7] = {&kdv_flags, &kdv_split, &kdv_above, &kdv_nprims, &kdv_prim_ids, &kdv_prim_kind,
                           &kdv_anim_gid};
    for (int i = 0; i < 7; ++i) {
        const cudaError_t e = cudaMemcpyToSymbol(syms[i], &p[i], sizeof(void*));
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}
'''

_KD_NODE = """        const int2 nd = __ldg(node_rec + node);
        const int fl = nd.y & 3;
"""

_KD_ROW = """            const float4 q0 = __ldg(pr), q1 = __ldg(pr + 1), q2 = __ldg(pr + 2);
            const bool tri = (__float_as_int(q2.y) & 15) == 0;
            const int pid = __float_as_int(q2.z);
"""


def _kd_tables(patch):
    """patch, with the kd variant tables' pointers and their C entry."""
    def apply(s):
        s = _replace(s, '#include "quadric.cuh"\n', '#include "quadric.cuh"\n' + _KD_TABLES)
        return patch(s) + _KD_TABLES_ENTRY
    return apply


# the kd walk as persistent lanes over a ray queue (B1's queue_take,
# queue_finish): a lane whose ray is done writes it; once KD_REFILL_MIN
# lanes of the warp are idle (or all of them) the warp takes that many ray
# ids; each iteration is one node visit of every live lane's ray
_KD_QUEUE = """__device__ int kd_queue[2];  // the ray queue: zero at load, re-zeroed by each launch's last block
__device__ unsigned long long kd_iters;  // the warps' loop iterations (kd_walk_iterations)

struct KdEntry {
    int node;
    float lo, hi;
};

template <int MOTION>
__global__ void __launch_bounds__(THREADS, MOTION ? KD_MIN_BLOCKS_MOTION : KD_MIN_BLOCKS)
kd_walk_kernel(const float* __restrict__ o_in, const float* __restrict__ d_in, const float* __restrict__ t_max_in,
               int n_rays, const int2* __restrict__ node_rec, const float4* __restrict__ leaf_rec,
               const float* __restrict__ kd_lo, const float* __restrict__ kd_hi, const float* __restrict__ ptd,
               int cols, int any_hit, float* __restrict__ out_t, int* __restrict__ out_prim,
               float* __restrict__ out_b1, float* __restrict__ out_b2, int* __restrict__ out_pops,
               unsigned int* __restrict__ counters, BwMotion mo) {
    int* queue = kd_queue;
    const int lane = threadIdx.x & 31;
    int ray = -1;
    bool drained = false, live = false;
    unsigned int n_iter = 0;
    float o[3], d[3], inv[3], dt = 0.0f, t_best = 0.0f, b1 = 0.0f, b2 = 0.0f, tmin = 0.0f, tmax = 0.0f;
    BwRay r;
    int prim = -1, pops = 0, node = 0, sp = 0, c_gid = -1;
    float m[12];
    KdEntry stack[KD_STACK];
    for (;;) {
        if (ray >= 0 && !live) {
            out_t[ray] = t_best;
            out_prim[ray] = prim;
            out_b1[ray] = b1;
            out_b2[ray] = b2;
            out_pops[ray] = pops;
            ray = -1;
        }
        const unsigned idle = __ballot_sync(0xffffffffu, ray < 0);
        if (idle != 0 && !drained && (__popc(idle) >= KD_REFILL_MIN || idle == 0xffffffffu)) {
            const int id = queue_take(idle, lane, queue, n_rays, drained);
            if (ray < 0 && id < n_rays) {
                ray = id;
                dt = MOTION ? mo.time[ray] : 0.0f;
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    o[a] = o_in[3 * ray + a];
                    d[a] = d_in[3 * ray + a];
                    inv[a] = bw_inv(d[a]);
                }
                bw_setup(r, o, d);
                const float t_max = t_max_in[ray];
                t_best = t_max;
                b1 = 0.0f;
                b2 = 0.0f;
                prim = -1;
                pops = 0;
                sp = 0;
                c_gid = -1;
                node = 0;
                float tn = -INFINITY, tf = INFINITY;
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    const float t0 = (__ldg(kd_lo + a) - o[a]) * inv[a];
                    const float t1 = (__ldg(kd_hi + a) - o[a]) * inv[a];
                    tn = qf_max(tn, qf_min(t0, t1));
                    tf = qf_min(tf, qf_max(t0, t1));
                }
                tf = tf * BW_SLAB;
                live = tn <= tf && tf > 0.0f && t_max > 0.0f;
                tmin = qf_max(tn, 0.0f);
                tmax = qf_min(tf, t_max);
            }
        }
        if (__ballot_sync(0xffffffffu, live) == 0) {
            if (drained && __ballot_sync(0xffffffffu, ray >= 0) == 0) break;
            continue;
        }
        ++n_iter;
        if (!live) continue;
        if (t_best < tmin) {
            live = false;
            continue;
        }
        if (pops >= BW_ITER_CAP) {
            atomicAdd(&counters[1], 1u);
            live = false;
            continue;
        }
        ++pops;
        const int2 nd = __ldg(node_rec + node);
        const int fl = nd.y & 3;
        if (fl != 3) {
            const float s = __int_as_float(nd.x);
            const float o_a = bw_pick(o, fl), d_a = bw_pick(d, fl);
            const float tp = (s - o_a) * bw_pick(inv, fl);
            const bool below_first = o_a < s || (o_a == s && d_a <= 0.0f);
            const int above = nd.y >> 2;
            const int first = below_first ? node + 1 : above;
            const int second = below_first ? above : node + 1;
            if (tp > tmax || tp <= 0.0f) {
                node = first;
            } else if (tp < tmin) {
                node = second;
            } else {
                if (sp < KD_STACK) {
                    stack[sp] = KdEntry{second, tp, tmax};
                    ++sp;
                } else {
                    atomicAdd(&counters[0], 1u);
                }
                node = first;
                tmax = tp;
            }
            continue;
        }
        const float4* pr = leaf_rec + (size_t)nd.x * 3;
        const int n = nd.y >> 2;
        float tl = INFINITY, w1 = 0.0f, w2 = 0.0f;
        int win = -1;
        for (int k = 0; k < n; ++k, pr += 3) {
            const float4 q0 = __ldg(pr), q1 = __ldg(pr + 1), q2 = __ldg(pr + 2);
            const bool tri = (__float_as_int(q2.y) & 15) == 0;
            const int pid = __float_as_int(q2.z);
            float g[12];
            if (MOTION == 2) {
                const int gid = __float_as_int(q2.w);
                if (gid != c_gid) {
                    bw_anim_matrix(mo.anim + (size_t)gid * BW_ANIM_COLS, dt, m);
                    c_gid = gid;
                }
                bw_motion_g(m, mo.anim_c, pid, tri, g);
            }
            const float v[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
            float t, c1, c2;
            if (bw_test<MOTION>(r, pid, tri, v, ptd + (size_t)pid * cols, cols, g, mo, dt, t_best, t, c1, c2) &&
                t < tl) {
                tl = t;
                w1 = c1;
                w2 = c2;
                win = pid;
            }
        }
        const bool better = tl < t_best;
        if (better) {
            t_best = tl;
            prim = win;
            b1 = w1;
            b2 = w2;
        }
        if (sp == 0 || (better && any_hit)) {
            live = false;
            continue;
        }
        --sp;
        node = stack[sp].node;
        tmin = stack[sp].lo;
        tmax = stack[sp].hi;
    }
    queue_finish(queue, &kd_iters, n_iter);
}

"""

_KD_ITERATIONS = '''
extern "C" int kd_walk_iterations(unsigned long long* out) {
    const unsigned long long zero = 0;
    cudaError_t e = cudaMemcpyFromSymbol(out, kd_iters, sizeof(zero));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(kd_iters, &zero, sizeof(zero));
    return (int)e;
}
'''


def _kd_queue(refill):
    """The kd kernel as persistent lanes over a ray queue (_KD_QUEUE), the
    grid the resident blocks (wide_traverse.cuh), with a counter of its
    warps' loop iterations (_KD_ITERATIONS)."""
    def patch(s):
        s = _replace(s, '#include "quadric.cuh"\n', '#include "quadric.cuh"\n#include "wide_traverse.cuh"\n'
                     f"#define KD_REFILL_MIN {refill}\n")
        s = _between(s, "// One todo entry of the kd walk", "static BwMotion bw_motion(", _KD_QUEUE)
        return _replace(s, "        const int blocks = (n_rays + THREADS - 1) / THREADS;\n        kd_walk_kernel",
                        "        int blocks = 0;\n        const int err = wt_grid((const void*)kd_walk_kernel<MOTION>, "
                        "THREADS, n_rays, THREADS, &blocks);\n        if (err != 0) return err;\n"
                        "        kd_walk_kernel") + _KD_ITERATIONS
    return patch


KD_VARIANTS = {
    "kd_node_tables": _kd_tables(lambda s: _replace(s, _KD_NODE, """        const int fl = __ldg(kdv_flags + node);
        int2 nd;
        if (fl != 3) {
            nd.x = __float_as_int(__ldg(kdv_split + node));
            nd.y = fl | (__ldg(kdv_above + node) << 2);
        } else {
            nd.x = __ldg(kdv_above + node);
            nd.y = 3 | (__ldg(kdv_nprims + node) << 2);
        }
""")),
    "kd_leaf_ids": _kd_tables(lambda s: _replace(s, _KD_ROW, """\
            const int pid = __ldg(kdv_prim_ids + (int)((pr - leaf_rec) / 3));
            const float* vr = ptd + (size_t)pid * cols;
            const bool tri = __ldg(kdv_prim_kind + pid) == 0;
            const float4 q0 = make_float4(__ldg(vr), __ldg(vr + 1), __ldg(vr + 2), __ldg(vr + 3));
            const float4 q1 = make_float4(__ldg(vr + 4), __ldg(vr + 5), __ldg(vr + 6), __ldg(vr + 7));
            const float4 q2 = make_float4(__ldg(vr + 8), 0.0f, 0.0f,
                                          __int_as_float(kdv_anim_gid ? __ldg(kdv_anim_gid + pid) : 0));
""")),
    "kd_stack96": _define("KD_STACK", 96),
    "kd_stack32": _define("KD_STACK", 32),
    "kd_bounds6": _define("KD_MIN_BLOCKS", 6),
    "kd_bounds8": _define("KD_MIN_BLOCKS", 8),
    "kd_bounds_none": lambda s: _replace(s, "MOTION ? KD_MIN_BLOCKS_MOTION : KD_MIN_BLOCKS)",
                                         "MOTION ? KD_MIN_BLOCKS_MOTION : 1)"),
    "kd_motion_bounds6": _define("KD_MIN_BLOCKS_MOTION", 6),
    "kd_motion_bounds7": _define("KD_MIN_BLOCKS_MOTION", 7),
    "kd_queue": _kd_queue(8),
    "kd_queue16": _kd_queue(16),
    "kd_no_cache": lambda s: _replace(s, "                if (gid != c_gid) {", "                {"),
}

# the parent design's kd C interface: o, d, t_max, n_rays, kd_flags,
# kd_split, kd_above, kd_nprims, kd_prim_ids, kd_lo, kd_hi, ptd, cols,
# prim_kind, any_hit, t, prim, b1, b2, pops, counters, stream
_KD_PARENT_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int]
                       + [ctypes.c_void_p] + [ctypes.c_int] + [ctypes.c_void_p] * 7)


class _KdWalk:
    """A kd library (the tree's, a variant's or, with parent, the parent
    design's) launched with the arguments of its C interface."""

    def __init__(self, name, info, motion, parent=False):
        from pbrt_tpu_torch.device import bvh_walk

        self.__name__ = name
        self.info, self.parent = info, parent
        self.lib = info["lib"]
        self.entry = "kd_walk_motion" if motion else "kd_walk"
        base = _KD_PARENT_ARGTYPES if parent else bvh_walk._KD_ARGTYPES
        for e, extra in (("kd_walk", []), ("kd_walk_motion", bvh_walk._MOTION_ARGTYPES)):
            getattr(self.lib, e).argtypes = base + extra
            getattr(self.lib, e).restype = ctypes.c_int
        self.launches, self.counters = 0, {}
        self.tables_of = None  # the scene whose tables kd_variant_tables holds

    def __call__(self, sa, st, o, d, t_max, any_hit, time=None):
        from pbrt_tpu_torch.device import bvh_walk

        if self.parent:
            R, counters, outs, stream = bvh_walk._outputs(self, o, d, t_max)
            args = [o.data_ptr(), d.data_ptr(), t_max.data_ptr(), R] + [
                getattr(sa, n).data_ptr() for n in ("kd_flags", "kd_split", "kd_above", "kd_nprims", "kd_prim_ids",
                                                    "kd_lo", "kd_hi", "prim_test_data")] + [
                sa.prim_test_data.shape[1], sa.prim_kind.data_ptr(), int(bool(any_hit))] + [
                x.data_ptr() for x in outs] + [counters.data_ptr(), stream]
        else:
            if hasattr(self.lib, "kd_variant_tables") and self.tables_of is not sa:
                ptrs = [getattr(sa, n).data_ptr() for n in ("kd_flags", "kd_split", "kd_above", "kd_nprims",
                                                             "kd_prim_ids", "prim_kind")]
                gid = 0 if sa.anim_gid is None else sa.anim_gid.data_ptr()
                fn = self.lib.kd_variant_tables
                fn.argtypes, fn.restype = [ctypes.c_void_p] * 7, ctypes.c_int
                if fn(*ptrs, gid) != 0:
                    raise RuntimeError("kd_variant_tables failed")
                self.tables_of = sa
            R, args, outs = bvh_walk._kd_args(self, sa, st, o, d, t_max, any_hit)
        if time is not None:
            args += bvh_walk._motion_args(sa, st, time, o.shape[0], o.device)
        err = getattr(self.lib, self.entry)(*args)
        if err != 0:
            raise RuntimeError(f"{self.__name__} {self.entry} launch failed: cudaError {err}")
        return outs


def _kd_queue_share(walk, sa, st, o, d, t_max, any_hit, tm, pops) -> float:
    """A kd queue variant's share of lanes holding a ray: the node visits
    (pops) over 32 x its warps' loop iterations in one launch."""
    n_iter = ctypes.c_ulonglong(0)
    read = walk.lib.kd_walk_iterations
    if read(ctypes.byref(n_iter)) != 0:
        raise RuntimeError("kd_walk_iterations failed")
    walk(sa, st, o, d, t_max, any_hit, time=tm)
    if read(ctypes.byref(n_iter)) != 0:
        raise RuntimeError("kd_walk_iterations failed")
    return float(pops.double().sum()) / max(32.0 * float(n_iter.value), 1.0)


def _kd_ptxas(info) -> list[dict]:
    import ptxas_report

    return [{k: r[k] for k in ("template", "registers", "spill_stores", "spill_loads", "stack_frame")}
            for r in ptxas_report.parse(info["log"]) if "kd_walk_kernel" in r["function"]]


def _main_kd(args, rec) -> None:
    """--walk kd: the tree's kd walk, its variants and the parent design on
    phase 34's kd sets and phase 43's kd motion rays, in turns."""
    import torch

    import chip_smoke
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.device import bvh_walk, nvcc
    from pbrt_tpu_torch.scene.builder import compile_scene

    names = list(args.only if args.only is not None else KD_VARIANTS)
    sources = {}
    for n in names:
        out = nvcc.BUILD_DIR / "variants" / f"bvh_walk_{n}"
        out.mkdir(parents=True, exist_ok=True)
        for f in (SOURCE,) + HEADERS:
            text = (nvcc.CSRC / f).read_text()
            (out / f).write_text(KD_VARIANTS[n](text) if f == SOURCE else text)
        sources[n] = out / SOURCE
    if args.parent:
        sources["parent"] = Path(args.parent).resolve() / "pbrt_tpu_torch" / "csrc" / SOURCE
    try:
        nvcc.build_all([bvh_walk.KERNEL_SOURCE, *sources.values()])
    except RuntimeError as e:
        print(f"[build] {str(e)[-3000:]}", flush=True)
    tree_info = nvcc.build(bvh_walk.KERNEL_SOURCE)
    occ = [nvcc.occupancy(tree_info["lib"].kd_walk_occupancy, m) for m in (0, 1, 2)]
    rec["tree"] = {"ptxas": _kd_ptxas(tree_info), "blocks_per_sm": occ}
    print(f"[tree] ptxas {rec['tree']['ptxas']}; blocks per SM (MOTION 0, 1, 2) {occ}", flush=True)
    dev = torch.device("cuda", 0)
    q = compile_scene(scenes.quadric_room(40, instances=False, accelerator="kdtree"), "cpu").to(dev)
    cases = [(q, f"{name}/{'any' if any_hit else 'closest'}", o, d, t_max, any_hit, None)
             for name, o, d, t_max in chip_smoke._rays(q) for any_hit in (False, True)]
    for rotate, label in ((True, "motion2 camera/closest"), (False, "motion1 camera/closest")):
        mr = compile_scene(scenes.motion_room(*chip_smoke.KD_MOTION_ROOM_ARGS[rotate]), "cpu").to(dev)
        o, d, t_max, tm = chip_smoke._motion_rays(mr)
        cases.append((mr, label, o, d, t_max, False, tm))
    tree = {m: _KdWalk("tree", tree_info, m) for m in (False, True)}
    want = {}
    for cs, label, o, d, t_max, any_hit, tm in cases:
        want[label] = tree[tm is not None](cs.arrays, cs.static, o, d, t_max, any_hit, time=tm)
    for name in names + (["parent"] if args.parent else []):
        try:
            info = nvcc.build(sources[name])
            parent = name == "parent"
            var = {m: _KdWalk(name, info, m, parent) for m in (False, True)}
            entry = {"ptxas": _kd_ptxas(info), "rows": []}
            if not parent:
                entry["blocks_per_sm"] = [nvcc.occupancy(info["lib"].kd_walk_occupancy, m) for m in (0, 1, 2)]
            print(f"[{name}] ptxas {entry['ptxas']}; blocks per SM {entry.get('blocks_per_sm')}", flush=True)
            for cs, label, o, d, t_max, any_hit, tm in cases:
                sa, st = cs.arrays, cs.static
                k_t, k_v = tree[tm is not None], var[tm is not None]
                res_t = want[label]
                res_v = k_v(sa, st, o, d, t_max, any_hit, time=tm)
                same = [torch.equal(x, y) for x, y in zip(res_t, res_v)]
                if not all(same):
                    raise AssertionError(f"{name} differs from the tree on {label}: t, prim, b1, b2, pops {same}")
                if k_v.counters[dev].tolist() != [0, 0]:
                    raise AssertionError(f"{name}: stack overflows / iteration-cap hits")
                order = (k_v, k_t, k_t, k_v) if parent else (k_t, k_v, k_v, k_t)
                turns = [chip_smoke._cuda_ms(lambda: k(sa, st, o, d, t_max, any_hit, time=tm), args.reps)
                         for k in order]
                inner, outer = statistics.mean(turns[1:3]), statistics.mean([turns[0], turns[3]])
                ms_t, ms_v = (inner, outer) if parent else (outer, inner)
                row = {"rays": label, "n": o.shape[0], "turns_ms": turns, "tree_ms": ms_t, "variant_ms": ms_v,
                       "tree_ns_per_ray": 1e6 * ms_t / o.shape[0], "variant_ns_per_ray": 1e6 * ms_v / o.shape[0],
                       "pops_per_ray": float(res_t[4].double().mean()),
                       "lanes_with_a_ray": chip_smoke._warp_share(res_t[4])}
                if name.startswith("kd_queue"):
                    row["variant_lanes"] = _kd_queue_share(k_v, sa, st, o, d, t_max, any_hit, tm, res_t[4])
                entry["rows"].append(row)
                print(f"  {label}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                                 for k, v in row.items() if k != "rays"), flush=True)
            six = [r for r in entry["rows"] if not r["rays"].startswith("motion")]
            entry["tree_ms_six"] = sum(r["tree_ms"] for r in six)
            entry["variant_ms_six"] = sum(r["variant_ms"] for r in six)
            print(f"[{name}] six sets: tree {entry['tree_ms_six']:.4f} ms, {name} {entry['variant_ms_six']:.4f} ms "
                  f"({entry['variant_ms_six'] / entry['tree_ms_six']:.3f}x)", flush=True)
            rec["variants"][name] = entry
        except (RuntimeError, AssertionError) as e:
            print(f"[{name}] failed: {str(e)[-2000:]}", flush=True)
            rec["variants"][name] = {"error": str(e)[-2000:]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--walk", choices=("bvh", "kd"), default="bvh")
    ap.add_argument("--parent", help="root of a checkout with the parent design's csrc/bvh_walk.cu")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", nargs="*", choices=list(VARIANTS) + list(KD_VARIANTS),
                    help="variants to run (default: all of the walk's)")
    ap.add_argument("--out", help="also write the record as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bvh_walk_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.device import bvh_walk, nvcc
    from pbrt_tpu_torch.scene.builder import compile_scene

    rec = {"device": torch.cuda.get_device_name(0), "nvidia_smi": chip_smoke._smi(), "reps": args.reps,
           "walk": args.walk, "variants": {}}
    print(f"bvh_walk_variants: {rec['device']}; nvidia-smi: {rec['nvidia_smi']}", flush=True)
    if args.walk == "kd":
        _main_kd(args, rec)
        return _finish(args, rec)
    names = list(args.only if args.only is not None else VARIANTS)
    sources = {n: _write_variant(n) for n in names}
    if args.parent:
        sources["parent"] = Path(args.parent).resolve() / "pbrt_tpu_torch" / "csrc" / SOURCE
    try:
        nvcc.build_all([bvh_walk.KERNEL_SOURCE, *sources.values()])
    except RuntimeError as e:
        print(f"[build] {str(e)[-3000:]}", flush=True)
    tree_info = nvcc.build(bvh_walk.KERNEL_SOURCE)
    rec["tree"] = {"ptxas": _ptxas(tree_info), "blocks_per_sm": [_occupancy(tree_info, m) for m in (0, 1, 2)]}
    print(f"[tree] ptxas {rec['tree']['ptxas']}; blocks per SM (MOTION 0, 1, 2) {rec['tree']['blocks_per_sm']}",
          flush=True)
    dev = torch.device("cuda", 0)
    q = compile_scene(scenes.quadric_room(248), "cpu").to(dev)
    mr = compile_scene(scenes.motion_room(248), "cpu").to(dev)
    cases = [(q, f"{name}/{'any' if any_hit else 'closest'}", o, d, t_max, any_hit, None)
             for name, o, d, t_max in chip_smoke._rays(q) for any_hit in (False, True)]
    o, d, t_max, tm = chip_smoke._motion_rays(mr)
    cases.append((mr, "motion camera/closest", o, d, t_max, False, tm))
    # the tree's results and node visits per case: every variant is held to them
    tree = {m: _Variant("tree", tree_info, m) for m in (False, True)}
    want = {}
    for cs, label, o, d, t_max, any_hit, tm in cases:
        walk = tree[tm is not None]
        res = walk(cs.arrays, cs.static, o, d, t_max, any_hit, time=tm)
        res_c, tests, _seen = _counted(walk, cs.arrays, cs.static, o, d, t_max, tm, any_hit)
        if not all(torch.equal(x, y) for x, y in zip(res, res_c)):
            raise AssertionError(f"the tree's instrumented entry walked other paths on {label}")
        want[label] = res, tests[:, 3]
    for name in names + (["parent"] if args.parent else []):
        try:
            rec["variants"][name] = _run_variant(name, nvcc.build(sources[name]), cases, tree, want, args.reps)
        except (RuntimeError, AssertionError) as e:
            print(f"[{name}] failed: {str(e)[-2000:]}", flush=True)
            rec["variants"][name] = {"error": str(e)[-2000:]}
    return _finish(args, rec)


def _finish(args, rec) -> int:
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
    print(json.dumps({"ok": True, "nvidia_smi": rec["nvidia_smi"]}))
    return 0


def _run_variant(name, info, cases, tree, want, reps) -> dict:
    """One variant's gate and turns on every case (main's); returns its record."""
    import torch

    import chip_smoke

    dev = torch.device("cuda", 0)
    parent = name == "parent"
    var = {m: (_Parent(info, m) if parent else _Variant(name, info, m)) for m in (False, True)}
    entry = {"ptxas": _ptxas(info), "rows": []}
    if not parent:
        entry["blocks_per_sm"] = [_occupancy(info, m) for m in (0, 1, 2)]
    print(f"[{name}] ptxas {entry['ptxas']}; blocks per SM {entry.get('blocks_per_sm')}", flush=True)
    for cs, label, o, d, t_max, any_hit, tm in cases:
        sa, st = cs.arrays, cs.static
        k_t, k_v = tree[tm is not None], var[tm is not None]
        res_t, visits = want[label]
        res_v = k_v(sa, st, o, d, t_max, any_hit, time=tm)
        same = [torch.equal(x, y) for x, y in zip(res_t, res_v)]
        if not all(same[:4]) or (not same[4] and not (parent and any_hit)):
            raise AssertionError(f"{name} differs from the tree on {label}: t, prim, b1, b2, pops {same}")
        if k_v.counters[dev].tolist() != [0, 0]:
            raise AssertionError(f"{name}: stack overflows / iteration-cap hits")
        row = {"rays": label, "n": o.shape[0]}
        if parent and label in ("camera/closest", "motion camera/closest"):
            # the bound's count: the same pops, prim tests and rows read
            _r, tests_p, seen_p = _counted(k_v, sa, st, o, d, t_max, tm)
            _r, tests_t, seen_t = _counted(k_t, sa, st, o, d, t_max, tm)
            row["bound_count_equal"] = bool(torch.equal(tests_p, tests_t[:, :3]) and all(
                torch.equal(a, b) for a, b in zip(seen_p, seen_t)))
            if not row["bound_count_equal"]:
                raise AssertionError(f"the parent's instrumented entry counts other work on {label}")
        order = (k_v, k_t, k_t, k_v) if parent else (k_t, k_v, k_v, k_t)
        turns = [chip_smoke._cuda_ms(lambda: k(sa, st, o, d, t_max, any_hit, time=tm), reps) for k in order]
        ms_t = statistics.mean(turns[1:3]) if parent else statistics.mean([turns[0], turns[3]])
        ms_v = statistics.mean([turns[0], turns[3]]) if parent else statistics.mean(turns[1:3])
        row.update({"turns_ms": turns, "order": "parent, tree, tree, parent" if parent else
                    "tree, variant, variant, tree", "tree_ms": ms_t, "variant_ms": ms_v,
                    "tree_ns_per_ray": 1e6 * ms_t / o.shape[0], "variant_ns_per_ray": 1e6 * ms_v / o.shape[0],
                    "box_tests_per_ray": float(res_t[4].double().mean()),
                    "tree_lanes": _share(k_t, sa, st, o, d, t_max, any_hit, tm, visits),
                    "variant_lanes": _share(k_v, sa, st, o, d, t_max, any_hit, tm, visits)})
        if parent:
            row["parent_pops_per_ray"] = float(res_v[4].double().mean())
        entry["rows"].append(row)
        print(f"  {label}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                         for k, v in row.items() if k not in ("rays", "order")), flush=True)
    six = [r for r in entry["rows"] if not r["rays"].startswith("motion")]
    entry["tree_ms_six"] = sum(r["tree_ms"] for r in six)
    entry["variant_ms_six"] = sum(r["variant_ms"] for r in six)
    print(f"[{name}] six sets: tree {entry['tree_ms_six']:.4f} ms, {name} {entry['variant_ms_six']:.4f} ms "
          f"({entry['variant_ms_six'] / entry['tree_ms_six']:.3f}x)", flush=True)
    return entry


if __name__ == "__main__":
    sys.exit(main())
