"""Per-ray walks of the binary BVH and of the kd-tree: the hand-written CUDA
kernel and its plain PyTorch twins.

The reference walks these scenes in XLA, not Pallas: ``pbrt_tpu/device/
intersect.py _traverse`` (:487-694) pops one node per packet of 256 rays
over one shared stack, and ``_traverse_kd`` (:893-1048) does the same over
the kd-tree with conservative per-packet intervals. They serve every scene
the wide tables do not: instanced scenes, scenes with quadrics beside more
than 64 triangles (other than the mixed route's spheres), and scenes with
``Accelerator "kdtree"``. In eager PyTorch a packet loop would cost
hundreds of launches and a host sync per query, so the port walks each ray
on its own instead, as B1 does:

- ``bvh_walk_cuda`` (``csrc/bvh_walk.cu``, entry ``bvh_walk``): one thread
  per ray over the walk's records (``scene/arrays.py bvh_walk_records``:
  both child boxes in the parent's 64-byte record, a 48-byte row per
  prim) with a private stack of far children and their tn (near child
  first by the sign of the ray's direction on the node's axis, as pbrt's
  BVHAccel::Intersect), each leaf's prims through B1's watertight
  triangle test or the EFloat quadric test of ``csrc/quadric.cuh``, an
  instanced prim's ray brought into instance space first (t is kept) and
  kept while the instance repeats;
- ``kd_walk_cuda`` (entry ``kd_walk``): pbrt's KdTreeAccel::Intersect
  over the kd walk's records (``scene/arrays.py kd_walk_records``: an
  8-byte record per node, a 48-byte row per leaf entry, tested through
  the BVH walk's per-prim code), a todo stack of KD_STACK (node, t_min,
  t_max) entries, the kd build's depth bound for any int32 prim count; a
  tree deeper than that (``static.kd_depth``) is refused before the
  launch, by the twin too.

Both answer closest-hit and any-hit queries and write (t, prim, b1, b2,
pops; the BVH walk's pops are the boxes it tested): b1, b2 are the
barycentrics of a triangle hit, the object-space x and y of a quadric hit,
as the brute route writes them. A leaf's hits tie to its first prim;
across leaves only a strict improvement counts. ``walk_plain`` and
``kd_walk_plain`` are the same walks in plain PyTorch, lockstep over every
ray with a (R, STACK) or (R, KD_STACK) stack tensor, the BVH walk's over
the same records in the same order, the kd walk's over the ``kd_*`` tables
the records come from; the kernels are held to them (chip_smoke.py
phase 34), and they to the reference's queries
(tests/test_torch_bvh_walk.py). The reference's kd packet walk drops the
near child when every ray of a packet moves away from the split plane
(ROADMAP C); the per-ray walk here is pbrt's.

Motion blur: a scene with moving prims (``static.has_motion``) and a
per-ray shutter fraction ``time`` walks the same trees with each candidate
prim moved to the ray's time before its test (the reference's time-aware
leaf test, intersect.py :575-600; its kd loop through ``_test_prims``
:326-354): the keyframe rows lerped (``prim_test_data_end``, ``_mid``), or,
in a scene whose shutter transform rotates, the exact animated transform of
the prim's group (device/motion.py). The BVH was built over the swept
bounds, so the walk itself is unchanged. ``bvh_walk_motion_cuda`` and
``kd_walk_motion_cuda`` launch the kernel's motion instantiations (entries
bvh_walk_motion, kd_walk_motion); ``walk_plain`` and ``kd_walk_plain`` take
the time too.

``walk_intersect`` launches a kernel for CUDA tensors and runs a twin only
for CPU tensors; a build or launch failure raises. The kernel is compiled
with nvcc at its first launch (device/nvcc.py) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import nvcc
from .affine import xf_point, xf_vector
from .motion import motion_matrices, motion_quad, xform_point
from .prims import ray_quadric, ray_triangle
from ..scene.arrays import ANIM_REC_COLS
from .wide_bvh import SORT_MIN_RAYS, coherence_keys

STACK = 64  # far-child entries per ray of the BVH walk (intersect.STACK_DEPTH)
KD_STACK = 48  # (node, t_min, t_max) entries per ray (csrc/bvh_walk.cu KD_STACK): round(8 + 1.3 log2 n), n < 2^31
GEOM_TRI = 0  # scene.arrays.GEOM_TRI
KERNEL_SOURCE = nvcc.CSRC / "bvh_walk.cu"

# o, d, t_max, n_rays, bvh_packed, bw_node_rec, bw_prim_rec, ptd, ptd_cols,
# inst_w2i, any_hit, t, prim, b1, b2, pops, counters, stream
_BVH_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                 + [ctypes.c_void_p] + [ctypes.c_int] + [ctypes.c_void_p] * 7)
# o, d, t_max, n_rays, kd_node_rec, kd_leaf_rec, kd_lo, kd_hi, ptd,
# ptd_cols, any_hit, t, prim, b1, b2, pops, counters, stream
_KD_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                + [ctypes.c_void_p] * 7)
# the motion entries' extra arguments: motion, time, ptd_end, ptd_mid, anim
# rows, anim_gid, anim_c
_MOTION_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6


def motion_kind(static) -> int:
    """The walk's MOTION: 0 static, 1 keyframe rows, 2 the exact animated
    transform (a scene whose shutter transform rotates)."""
    if not static.has_motion:
        return 0
    return 2 if static.has_rot_motion else 1


def build_kernel() -> dict:
    """Compile (if needed) and load the walk kernels' library: {"lib",
    "seconds", "log", "path"} as device/nvcc.build returns it. Its C
    entries: bvh_walk, kd_walk, bvh_walk_occupancy(count, motion),
    kd_walk_occupancy(motion) and, in the same library, bvh_walk_counted (the
    instrumented build of the BVH walk: it also writes each ray's prim
    tests by kind and node visits and marks the table rows it read), and
    the motion walks bvh_walk_motion, bvh_walk_motion_counted and
    kd_walk_motion."""
    info = nvcc.build(KERNEL_SOURCE)
    lib = info["lib"]
    lib.bvh_walk.argtypes = _BVH_ARGTYPES
    lib.bvh_walk.restype = ctypes.c_int
    lib.bvh_walk_counted.argtypes = _BVH_ARGTYPES + [ctypes.c_void_p] * 4
    lib.bvh_walk_counted.restype = ctypes.c_int
    lib.kd_walk.argtypes = _KD_ARGTYPES
    lib.kd_walk.restype = ctypes.c_int
    lib.bvh_walk_motion.argtypes = _BVH_ARGTYPES + _MOTION_ARGTYPES
    lib.bvh_walk_motion.restype = ctypes.c_int
    lib.bvh_walk_motion_counted.argtypes = _BVH_ARGTYPES + _MOTION_ARGTYPES + [ctypes.c_void_p] * 4
    lib.bvh_walk_motion_counted.restype = ctypes.c_int
    lib.kd_walk_motion.argtypes = _KD_ARGTYPES + _MOTION_ARGTYPES
    lib.kd_walk_motion.restype = ctypes.c_int
    return info


def _check(name, x, dtype, shape, dev):
    if x is None or x.device != dev or x.dtype != dtype or not x.is_contiguous() or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be a contiguous {dtype} {tuple(shape)} tensor on {dev}")


def _outputs(wrapper, o, d, t_max):
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"{wrapper.__name__} takes CUDA tensors")
    R = o.shape[0]
    for name, x, shape in (("o", o, (R, 3)), ("d", d, (R, 3)), ("t_max", t_max, (R,))):
        _check(name, x, torch.float32, shape, dev)
    counters = wrapper.counters.get(dev)
    if counters is None:  # setdefault: a shard thread that loses the race takes the winner's tensor
        counters = wrapper.counters.setdefault(dev, torch.zeros(2, dtype=torch.int32, device=dev))
    out = (torch.empty(R, dtype=torch.float32, device=dev), torch.empty(R, dtype=torch.int32, device=dev),
           torch.empty(R, dtype=torch.float32, device=dev), torch.empty(R, dtype=torch.float32, device=dev),
           torch.empty(R, dtype=torch.int32, device=dev))
    return R, counters, out, torch.cuda.current_stream(dev).cuda_stream


def _motion_args(sa, static, time, R, dev):
    """The motion entries' extra arguments for a scene with motion."""
    kind = motion_kind(static)
    _check("time", time, torch.float32, (R,), dev)
    P, cols = sa.prim_test_data.shape
    if kind == 1:
        _check("prim_test_data_end", sa.prim_test_data_end, torch.float32, (P, cols), dev)
        mid = sa.prim_test_data_mid
        if mid is not None:
            _check("prim_test_data_mid", mid, torch.float32, (P, cols), dev)
        return [kind, time.data_ptr(), sa.prim_test_data_end.data_ptr(), 0 if mid is None else mid.data_ptr(), 0, 0, 0]
    _check("anim_rec", sa.anim_rec, torch.float32, (sa.anim_rec.shape[0], ANIM_REC_COLS), dev)
    _check("anim_gid", sa.anim_gid, torch.int32, (P,), dev)
    _check("anim_c", sa.anim_c, torch.float32, (P, 3, 4), dev)
    return [kind, time.data_ptr(), 0, 0, sa.anim_rec.data_ptr(), sa.anim_gid.data_ptr(), sa.anim_c.data_ptr()]


def bvh_walk_cuda(sa, static, o, d, t_max, any_hit: bool, prim_tests=None, rows_read=None):
    """Launch the BVH walk (entry bvh_walk). Returns (t, prim, b1, b2,
    pops): prim the closest (or any) hit's prim row, -1 on a miss, t the
    hit's t (t_max on a miss), pops the boxes tested. Adds one to
    ``bvh_walk_cuda.launches``; stack overflows and iteration-cap hits
    accumulate in ``bvh_walk_cuda.counters``. prim_tests: an int32 (R, 4) tensor launches the
    instrumented entry, which writes each ray's triangle tests, quadric
    tests, tests through an instance transform and node visits there; it
    then also takes rows_read, three zeroed int32 tensors of the bvh_packed
    rows, prims and instances, in which it marks what the walk read: a
    node's bits 1 (its box, tested at its parent), 2 (its offset and count:
    entered) and 4 (its split axis: an interior node entered), a prim row
    tested, an instance whose transform was applied."""
    R, counters, outs, stream = _outputs(bvh_walk_cuda, o, d, t_max)
    args = _bvh_args(sa, o, d, t_max, any_hit, outs, counters, stream)
    return _launch_bvh(bvh_walk_cuda, "bvh_walk", sa, args, R, o.device, prim_tests, rows_read, outs)


bvh_walk_cuda.launches = 0
bvh_walk_cuda.counters = {}  # device -> int32 (2,): stack overflows, iteration-cap hits


def _launch_bvh(wrapper, entry, sa, args, R, dev, prim_tests, rows_read, outs):
    """Launch entry (or, with prim_tests, its instrumented entry
    entry + "_counted") of the walk library with args; count the launch in
    wrapper.launches; raise on a launch error."""
    lib = build_kernel()["lib"]
    if prim_tests is not None:
        _check("prim_tests", prim_tests, torch.int32, (R, 4), dev)
        seen = tuple(rows_read)
        for name, x, n in zip(("node", "prim", "instance"), seen,
                              (sa.bvh_packed.shape[0], sa.prim_test_data.shape[0], sa.inst_w2i.shape[0])):
            _check(f"rows_read ({name})", x, torch.int32, (n,), dev)
        entry, args = entry + "_counted", [*args, prim_tests.data_ptr(), *(x.data_ptr() for x in seen)]
    with torch.cuda.device(dev):  # the C entry launches on the calling thread's current device
        err = getattr(lib, entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    nvcc.count_launch(wrapper)
    return outs


def _bvh_args(sa, o, d, t_max, any_hit, outs, counters, stream):
    dev = o.device
    P, cols = sa.prim_test_data.shape
    if sa.bw_node_rec is None:
        raise ValueError("the BVH walk needs the scene's walk records (scene.arrays.bvh_walk_records)")
    _check("bvh_packed", sa.bvh_packed, torch.float32, (sa.bvh_packed.shape[0], 12), dev)
    _check("bw_node_rec", sa.bw_node_rec, torch.float32, (sa.bw_node_rec.shape[0], 16), dev)
    _check("bw_prim_rec", sa.bw_prim_rec, torch.float32, (P, 12), dev)
    _check("prim_test_data", sa.prim_test_data, torch.float32, (P, cols), dev)
    _check("inst_w2i", sa.inst_w2i, torch.float32, (sa.inst_w2i.shape[0], 3, 4), dev)
    t, prim, b1, b2, pops = outs
    return [o.data_ptr(), d.data_ptr(), t_max.data_ptr(), o.shape[0], sa.bvh_packed.data_ptr(),
            sa.bw_node_rec.data_ptr(), sa.bw_prim_rec.data_ptr(), sa.prim_test_data.data_ptr(), cols,
            sa.inst_w2i.data_ptr(), int(bool(any_hit)), t.data_ptr(), prim.data_ptr(), b1.data_ptr(), b2.data_ptr(),
            pops.data_ptr(), counters.data_ptr(), stream]


def bvh_walk_motion_cuda(sa, static, o, d, t_max, any_hit: bool, time=None, prim_tests=None, rows_read=None):
    """Launch the BVH walk's motion instantiation (entry bvh_walk_motion,
    MOTION = motion_kind(static)) at the per-ray shutter fractions `time`
    (float32 (R,), required; walk_plain's signature); bvh_walk_cuda's
    outputs and instrumented entry
    (bvh_walk_motion_counted), counted in ``bvh_walk_motion_cuda.launches``
    and ``.counters``."""
    R, counters, outs, stream = _outputs(bvh_walk_motion_cuda, o, d, t_max)
    args = (_bvh_args(sa, o, d, t_max, any_hit, outs, counters, stream)
            + _motion_args(sa, static, time, R, o.device))
    return _launch_bvh(bvh_walk_motion_cuda, "bvh_walk_motion", sa, args, R, o.device, prim_tests, rows_read, outs)


bvh_walk_motion_cuda.launches = 0
bvh_walk_motion_cuda.counters = {}  # device -> int32 (2,): stack overflows, iteration-cap hits


def check_kd_depth(static):
    """Raise ValueError for a kd-tree deeper than the walks' todo stack
    (KD_STACK entries: a ray holds at most one per interior level)."""
    if static.kd_depth > KD_STACK:
        raise ValueError(f"the kd-tree is {static.kd_depth} interior levels deep; the kd walk's stack holds "
                         f"{KD_STACK}")


def _kd_args(wrapper, sa, static, o, d, t_max, any_hit):
    """The kd entries' arguments (the tree's depth checked first), with the
    outputs."""
    check_kd_depth(static)
    R, counters, outs, stream = _outputs(wrapper, o, d, t_max)
    dev = o.device
    P, cols = sa.prim_test_data.shape
    if sa.kd_node_rec is None:
        raise ValueError("the kd walk needs the scene's kd walk records (scene.arrays.kd_walk_records)")
    for name, dtype, shape in (("kd_node_rec", torch.int32, (sa.kd_node_rec.shape[0], 2)),
                               ("kd_leaf_rec", torch.float32, (sa.kd_leaf_rec.shape[0], 12)),
                               ("kd_lo", torch.float32, (3,)), ("kd_hi", torch.float32, (3,)),
                               ("prim_test_data", torch.float32, (P, cols))):
        _check(name, getattr(sa, name), dtype, shape, dev)
    t, prim, b1, b2, pops = outs
    args = [o.data_ptr(), d.data_ptr(), t_max.data_ptr(), R, sa.kd_node_rec.data_ptr(), sa.kd_leaf_rec.data_ptr(),
            sa.kd_lo.data_ptr(), sa.kd_hi.data_ptr(), sa.prim_test_data.data_ptr(), cols, int(bool(any_hit)),
            t.data_ptr(), prim.data_ptr(), b1.data_ptr(), b2.data_ptr(), pops.data_ptr(), counters.data_ptr(), stream]
    return R, args, outs


def kd_walk_cuda(sa, static, o, d, t_max, any_hit: bool):
    """Launch the kd-tree walk (entry kd_walk); bvh_walk_cuda's contract
    (pops: the nodes visited), counted in ``kd_walk_cuda.launches`` and
    ``.counters``; raises before the launch on a tree deeper than
    KD_STACK."""
    R, args, outs = _kd_args(kd_walk_cuda, sa, static, o, d, t_max, any_hit)
    return _launch_bvh(kd_walk_cuda, "kd_walk", sa, args, R, o.device, None, None, outs)


kd_walk_cuda.launches = 0
kd_walk_cuda.counters = {}  # device -> int32 (2,): stack overflows, iteration-cap hits


def kd_walk_motion_cuda(sa, static, o, d, t_max, any_hit: bool, time=None):
    """Launch the kd-tree walk's motion instantiation (entry
    kd_walk_motion); kd_walk_cuda's contract, counted in
    ``kd_walk_motion_cuda.launches`` and ``.counters``."""
    R, args, outs = _kd_args(kd_walk_motion_cuda, sa, static, o, d, t_max, any_hit)
    args += _motion_args(sa, static, time, R, o.device)
    return _launch_bvh(kd_walk_motion_cuda, "kd_walk_motion", sa, args, R, o.device, None, None, outs)


kd_walk_motion_cuda.launches = 0
kd_walk_motion_cuda.counters = {}  # device -> int32 (2,): stack overflows, iteration-cap hits


# ---------------------------------------------------------------------------
# Plain PyTorch walks (the kernels' twins)
# ---------------------------------------------------------------------------


def _inv_dir(d):
    """1/d with |d| clamped at 1e-30 (the reference's inv_d)."""
    return 1.0 / torch.where(d.abs() < 1e-30, torch.where(d < 0, -1e-30, 1e-30), d)


def _moved_rows(sa, static, rows, ids, is_tri, time):
    """The candidates' rows at their rays' times (A,): (triangle vertices
    (A, K, 9), a function giving the world-to-object (Q, 3, 4) of the
    quadric entries q)."""
    if motion_kind(static) == 1:
        mid = None if sa.prim_test_data_mid is None else sa.prim_test_data_mid[ids][..., 0:12]
        moved = motion_quad(rows[..., 0:12], sa.prim_test_data_end[ids][..., 0:12], mid, time[:, None, None])
        return moved[..., 0:9], lambda q: moved[q].reshape(-1, 3, 4)
    g = motion_matrices(sa, ids, time[:, None])  # (A, K, 3, 4)
    v = torch.cat([xform_point(g, rows[..., 3 * k:3 * k + 3]) for k in range(3)], dim=-1)
    return v, lambda q: motion_matrices(sa, ids[q], time[q[0]], quadric=True)


def _leaf_tests(sa, static, o, d, t_best, ids, valid, time=None):
    """The rays (A, 3) against their leaves' prims ids (A, K): (t (A, K),
    inf where missed or not valid, b1, b2). An instanced prim's ray is
    brought into instance space first; a quadric's params are its
    prim_test_data columns (with p1, p2 when the table has 26). The
    quadric test runs only on the entries that hold a quadric. With
    `time` (A,) in a scene with motion, each prim is moved to its ray's
    time first (_moved_rows)."""
    rows = sa.prim_test_data[ids]  # (A, K, C)
    is_tri = sa.prim_kind[ids] == GEOM_TRI
    ob = o[:, None, :].expand(ids.shape + (3,))
    db = d[:, None, :].expand(ids.shape + (3,))
    if static.has_instances:
        w2i = sa.inst_w2i[sa.prim_inst[ids].to(torch.int64)]
        ob = xf_point(w2i, ob)
        db = xf_vector(w2i, db)
    tb = t_best[:, None].expand(ids.shape)
    moving = time is not None and static.has_motion
    verts, w2o_of = _moved_rows(sa, static, rows, ids, is_tri, time) if moving else (rows[..., 0:9], None)
    hit, t, _b0, b1, b2 = ray_triangle(ob, db, verts[..., 0:3], verts[..., 3:6], verts[..., 6:9], tb)
    if static.n_spheres:
        q = torch.nonzero(valid & ~is_tri, as_tuple=True)
        if q[0].numel():
            rq = rows[q]
            par = rq[:, 12:18]
            if rq.shape[-1] >= 25:
                par = torch.cat([par, rq[:, 19:25]], dim=-1)
            w2o = w2o_of(q) if moving else rq[:, 0:12].reshape(-1, 3, 4)
            h_s, t_s, p_obj = ray_quadric(ob[q], db[q], w2o, par, rq[:, 18].to(torch.int64),
                                          tb[q], kinds=frozenset(static.quadric_kinds))
            hit, t, b1, b2 = (x.clone() for x in (hit, t, b1, b2))
            hit[q], t[q], b1[q], b2[q] = h_s, t_s, p_obj[:, 0], p_obj[:, 1]
    hit = hit & valid
    return torch.where(hit, t, math.inf), b1, b2


def _take_leaf(t_k, b1_k, b2_k, ids):
    """The nearest of a leaf's K tests, ties to the first: (t (A,), prim,
    b1, b2)."""
    t_new, k = torch.min(t_k, dim=1)  # torch.min returns the first minimum
    kk = k[:, None]
    return t_new, ids.gather(1, kk)[:, 0], b1_k.gather(1, kk)[:, 0], b2_k.gather(1, kk)[:, 0]


def _slab(lo, hi, o, inv_d, t_best):
    """The walk's box test of rays (A, 3) against boxes (A, 3): (enter, tn),
    enter = tn <= tf * 1.0000004 and tf > 0 and tn < t_best."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = torch.minimum(t0, t1).max(dim=1).values
    tf = torch.maximum(t0, t1).min(dim=1).values * 1.0000004
    return (tn <= tf) & (tf > 0) & (tn < t_best), tn


def walk_plain(sa, static, o, d, t_max, any_hit: bool, time=None):
    """The BVH walk in plain PyTorch on any device, over the walk's records
    (``sa.bw_node_rec``, ``bw_prim_rec``: scene.arrays.bvh_walk_records), a
    node at a time for every ray in lockstep: bvh_walk_cuda's outputs
    (prim int64) and the count of pushes dropped on a full stack. time: the
    rays' shutter fractions (bvh_walk_motion_cuda's twin).

    The walk is pbrt's BVHAccel::Intersect, with each child's box tested at
    its parent: the root's box first (bvh_packed row 0); an interior node
    tests both children's boxes (tn <= tf * 1.0000004, tf > 0, tn <
    t_best) and goes on in the near one that it hits (child 1 when the
    ray's direction is negative on the node's split axis), pushing the far
    one with its tn when it hits both; a leaf tests its prims at the t_best
    it starts with (the first prim of the nearest t wins; the ray's hit
    changes only when strictly nearer); a pop takes the top entry and drops
    it when its tn is no longer below t_best. pops counts the boxes tested,
    as a walk that tests each node's box when it pops it (the parent's
    design) counts its pops on closest-hit queries."""
    dev = o.device
    R = o.shape[0]
    node_rec = sa.bw_node_rec
    if node_rec is None:
        raise ValueError("walk_plain: the scene has no walk records (scene.arrays.bvh_walk_records)")
    boxes = node_rec[:, 0:12].reshape(-1, 2, 2, 3)  # (Ni, child, lo/hi, xyz)
    words = node_rec.view(torch.int32)
    refs = words[:, 12:14].to(torch.int64)  # (Ni, 2)
    axis = words[:, 14].to(torch.int64)
    rem = (sa.bw_prim_rec.view(torch.int32)[:, 9] >> 4).to(torch.int64)
    inv_d = _inv_dir(d)
    K = int(static.max_leaf)
    iota = torch.arange(K, device=dev)
    P = sa.prim_test_data.shape[0]
    st_ref = torch.zeros((R, STACK), dtype=torch.int64, device=dev)
    st_tn = torch.zeros((R, STACK), dtype=torch.float32, device=dev)
    slots = torch.arange(STACK, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    t_best = t_max.clone()
    prim = torch.full((R,), -1, dtype=torch.int64, device=dev)
    b1 = torch.zeros(R, dtype=torch.float32, device=dev)
    b2 = torch.zeros(R, dtype=torch.float32, device=dev)
    # the root: its box from bvh_packed row 0; a dead ray (t_max <= 0) tests nothing
    root = sa.bvh_packed[0]
    started = t_max > 0
    enter, _tn = _slab(root[0:3], root[3:6], o, inv_d, t_best)
    pops = started.to(torch.int64)
    live = started & enter
    cur = torch.full((R,), ~int(root[6]) if int(root[7]) > 0 else 0, dtype=torch.int64, device=dev)
    overflow = 0
    while True:
        act = torch.nonzero(live).squeeze(1)
        if act.numel() == 0:
            break
        c = cur[act]
        inner = c >= 0
        popping = [act[~inner]]
        # --- interior: both children's boxes, on in the near one ---
        ii = act[inner]
        if ii.numel():
            ci = c[inner]
            oi, ivi, tbi = o[ii], inv_d[ii], t_best[ii]
            hit0, tn0 = _slab(boxes[ci, 0, 0], boxes[ci, 0, 1], oi, ivi, tbi)
            hit1, tn1 = _slab(boxes[ci, 1, 0], boxes[ci, 1, 1], oi, ivi, tbi)
            pops[ii] += 2
            neg = d[ii].gather(1, axis[ci][:, None])[:, 0] < 0
            h_near, h_far = torch.where(neg, hit1, hit0), torch.where(neg, hit0, hit1)
            r_near = torch.where(neg, refs[ci, 1], refs[ci, 0])
            r_far = torch.where(neg, refs[ci, 0], refs[ci, 1])
            tn_far = torch.where(neg, tn0, tn1)
            # both hit: the far child is pushed (dropped and counted on a
            # full stack, as the kernel drops it)
            both = h_near & h_far
            s0 = sp[ii]
            push = both & (s0 < STACK)
            overflow += int((both & ~push).sum())
            pi, ps = ii[push], s0[push]
            st_ref[pi, ps] = r_far[push]
            st_tn[pi, ps] = tn_far[push]
            sp[ii] = s0 + push.to(torch.int64)
            cur[ii] = torch.where(h_near, r_near, r_far)
            popping.append(ii[~h_near & ~h_far])
        # --- leaf: its prims, rows ~ref .. ~ref + rem - 1 ---
        li = act[~inner]
        if li.numel():
            off = ~c[~inner]
            ids = torch.clamp(off[:, None] + iota[None, :], max=P - 1)
            valid = iota[None, :] < rem[off][:, None]
            t_k, b1_k, b2_k = _leaf_tests(sa, static, o[li], d[li], t_best[li], ids, valid,
                                          None if time is None else time[li])
            t_new, p_new, b1_new, b2_new = _take_leaf(t_k, b1_k, b2_k, ids)
            better = t_new < t_best[li]
            bi = li[better]
            t_best[bi] = t_new[better]
            prim[bi] = p_new[better]
            b1[bi] = b1_new[better]
            b2[bi] = b2_new[better]
            if any_hit:
                live[bi] = False
                popping[0] = li[~better]
        # --- pop: the top entry whose tn is still below t_best (the
        # entries above it are dropped); none left: the ray is done ---
        pp = torch.cat(popping)
        if pp.numel():
            ok = (slots[None, :] < sp[pp][:, None]) & (st_tn[pp] < t_best[pp][:, None])
            top = torch.where(ok, slots[None, :], -1).max(dim=1).values
            found = top >= 0
            live[pp[~found]] = False
            pf, tf = pp[found], top[found]
            cur[pf] = st_ref[pf, tf]
            sp[pf] = tf
    return t_best, prim, b1, b2, pops, overflow


def kd_walk_plain(sa, static, o, d, t_max, any_hit: bool, time=None, counts=None):
    """The kd-tree walk (pbrt's KdTreeAccel::Intersect) in plain PyTorch
    on any device: kd_walk_cuda's outputs (prim int64) and the count of
    pushes dropped on a full stack; with time, kd_walk_motion_cuda's twin.
    counts: a dict the walk fills with the work it did (the kd walk's
    bound, chip_smoke.py phase 34): "interior_visits" and "leaf_visits"
    (the pops of interior nodes and of leaves), "triangle_tests",
    "quadric_tests" and boolean masks of the rows it read, "nodes" (kd_flags), "prim_ids"
    (kd_prim_ids) and "prims" (prim_test_data). Its todo stack holds KD_STACK
    entries, the kernel's: a deeper tree raises (check_kd_depth)."""
    check_kd_depth(static)
    dev = o.device
    R = o.shape[0]
    inv_d = _inv_dir(d)
    K = int(static.kd_max_leaf)
    iota = torch.arange(K, device=dev)
    n_ids = sa.kd_prim_ids.shape[0]
    flags, split, above, nprims = sa.kd_flags, sa.kd_split, sa.kd_above.to(torch.int64), sa.kd_nprims
    pids = sa.kd_prim_ids.to(torch.int64)
    # the root interval: the tree's bounds (reference :915-921)
    t0 = (sa.kd_lo - o) * inv_d
    t1 = (sa.kd_hi - o) * inv_d
    tn = torch.minimum(t0, t1).max(dim=1).values
    tf = torch.maximum(t0, t1).min(dim=1).values * 1.0000004
    live = (tn <= tf) & (tf > 0) & (t_max > 0)
    node = torch.zeros(R, dtype=torch.int64, device=dev)
    tmin = torch.clamp(tn, min=0.0)
    tmax = torch.minimum(tf, t_max)
    st_n = torch.zeros((R, KD_STACK), dtype=torch.int64, device=dev)
    st_lo = torch.zeros((R, KD_STACK), dtype=torch.float32, device=dev)
    st_hi = torch.zeros((R, KD_STACK), dtype=torch.float32, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    t_best = t_max.clone()
    prim = torch.full((R,), -1, dtype=torch.int64, device=dev)
    b1 = torch.zeros(R, dtype=torch.float32, device=dev)
    b2 = torch.zeros(R, dtype=torch.float32, device=dev)
    pops = torch.zeros(R, dtype=torch.int64, device=dev)
    overflow = 0
    if counts is not None:
        counts.update(interior_visits=0, leaf_visits=0, triangle_tests=0, quadric_tests=0,
                      nodes=torch.zeros(flags.shape[0], dtype=torch.bool, device=dev),
                      prim_ids=torch.zeros(n_ids, dtype=torch.bool, device=dev),
                      prims=torch.zeros(sa.prim_kind.shape[0], dtype=torch.bool, device=dev))
    while True:
        # a ray whose best hit lies before its interval is done (pbrt:
        # `if ray.tMax < tMin break`)
        live = live & ~(t_best < tmin)
        act = torch.nonzero(live).squeeze(1)
        if act.numel() == 0:
            break
        pops[act] += 1
        na = node[act]
        fl = flags[na]
        is_leaf = fl == 3
        if counts is not None:
            counts["nodes"][na] = True
            n_leaf = int(is_leaf.sum())
            counts["interior_visits"] += act.numel() - n_leaf
            counts["leaf_visits"] += n_leaf
        # --- interior: the split plane's crossing picks the children ---
        ii = act[~is_leaf]
        if ii.numel():
            ni = node[ii]
            ax = fl[~is_leaf].to(torch.int64)[:, None]
            o_a = o[ii].gather(1, ax)[:, 0]
            d_a = d[ii].gather(1, ax)[:, 0]
            s = split[ni]
            tp = (s - o_a) * inv_d[ii].gather(1, ax)[:, 0]
            below_first = (o_a < s) | ((o_a == s) & (d_a <= 0))
            first = torch.where(below_first, ni + 1, above[ni])
            second = torch.where(below_first, above[ni], ni + 1)
            lo_i, hi_i = tmin[ii], tmax[ii]
            only_first = (tp > hi_i) | (tp <= 0)
            only_second = ~only_first & (tp < lo_i)
            both = ~only_first & ~only_second
            # both: push the second child with (tp, t_max), go on in the first
            s0 = sp[ii]
            push = both & (s0 < KD_STACK)
            overflow += int((both & ~push).sum())  # a push onto a full stack is dropped, as the kernel drops it
            pr, ps = ii[push], s0[push]
            st_n[pr, ps] = second[push]
            st_lo[pr, ps] = tp[push]
            st_hi[pr, ps] = hi_i[push]
            sp[ii] = s0 + push.to(torch.int64)
            node[ii] = torch.where(only_second, second, first)
            tmax[ii] = torch.where(both, tp, hi_i)
        # --- leaf: its listed prims, then the next todo entry ---
        li = act[is_leaf]
        if li.numel():
            nl = node[li]
            off = above[nl]
            ids = pids[torch.clamp(off[:, None] + iota[None, :], max=max(n_ids - 1, 0))]
            valid = iota[None, :] < nprims[nl][:, None].to(torch.int64)
            if counts is not None:
                tested = ids[valid]
                n_tri = int((sa.prim_kind[tested] == GEOM_TRI).sum())
                counts["triangle_tests"] += n_tri
                counts["quadric_tests"] += tested.numel() - n_tri
                counts["prims"][tested] = True
                counts["prim_ids"][(off[:, None] + iota[None, :])[valid]] = True
            t_k, b1_k, b2_k = _leaf_tests(sa, static, o[li], d[li], t_best[li], ids, valid,
                                          None if time is None else time[li])
            t_new, p_new, b1_new, b2_new = _take_leaf(t_k, b1_k, b2_k, ids)
            better = t_new < t_best[li]
            bi = li[better]
            t_best[bi] = t_new[better]
            prim[bi] = p_new[better]
            b1[bi] = b1_new[better]
            b2[bi] = b2_new[better]
            s0 = sp[li]
            empty = s0 == 0
            top = torch.clamp(s0 - 1, min=0)
            node[li] = st_n[li, top]
            tmin[li] = st_lo[li, top]
            tmax[li] = st_hi[li, top]
            sp[li] = top
            done = empty | (better & any_hit)
            live[li[done]] = False
    return t_best, prim, b1, b2, pops, overflow


# ---------------------------------------------------------------------------
# The query
# ---------------------------------------------------------------------------


def walk_intersect(sa, static, o, d, t_max, any_hit=False, sort=True, plain=False, time=None):
    """Closest-hit (or any-hit) query of a scene through its binary BVH, or
    its kd-tree when static.accel_kind is "kdtree". Returns (t, prim, hit,
    b1, b2): t = inf and prim = -1 on a miss. ``sort`` reorders rays by
    wide_bvh.coherence_keys before the walk and restores the order after;
    it cannot change a result. CUDA tensors launch the CUDA kernel, CPU
    tensors (or ``plain``) run the plain twin. time: the rays' shutter
    fractions (float32 (R,)); in a scene with motion it takes the motion
    walk, elsewhere it is ignored."""
    kd = static.accel_kind == "kdtree"
    moving = time is not None and static.has_motion
    if plain or o.device.type == "cpu":
        walk = kd_walk_plain if kd else walk_plain
    elif o.device.type == "cuda":
        if moving:
            walk = kd_walk_motion_cuda if kd else bvh_walk_motion_cuda
        else:
            walk = kd_walk_cuda if kd else bvh_walk_cuda
    else:
        raise ValueError(f"walk_intersect has no implementation for device {o.device}")
    R = o.shape[0]
    t_arr = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device), (R,)).contiguous()
    o = o.contiguous()
    d = d.contiguous()
    tm = time.to(torch.float32).contiguous() if moving else None
    perm = None
    if sort and R >= SORT_MIN_RAYS:
        lo = sa.world_center - sa.world_radius
        inv_ext = 1.0 / torch.clamp(2.0 * sa.world_radius, min=1e-20)
        keys = torch.where(t_arr > 0, coherence_keys(o, d, lo, inv_ext), 0xFFFFFFFF)
        perm = torch.argsort(keys, stable=True)
        o, d, t_arr = o[perm], d[perm], t_arr[perm]
        if tm is not None:
            tm = tm[perm]
    t, prim, b1, b2 = walk(sa, static, o, d, t_arr, any_hit, **({"time": tm} if moving else {}))[:4]
    if perm is not None:
        res = [torch.empty_like(x) for x in (t, prim, b1, b2)]
        for dst, src in zip(res, (t, prim, b1, b2)):
            dst[perm] = src
        t, prim, b1, b2 = res
    prim = prim.to(torch.int64)
    hit = prim >= 0
    return torch.where(hit, t, math.inf), prim, hit, b1, b2
