"""Host-side kd-tree accelerator build (NumPy + Python recursion).

The port's copy of ``pbrt_tpu/scene/kdtree.py``: pbrt's SAH kd-tree
construction (src/accelerators/kdtreeaccel.rs:137-410): edge-sweep SAH
with empty-space bonus, axis retries, bad-refine tracking, and the
8 + 1.3*log2(N) depth bound. One change: the reference sends a node's
prims to its children by their bounds (lo < t below, hi > t above) and so
drops a prim lying flat in the split plane from both (ROADMAP C); here
such a prim goes by its edges' places in the sorted sweep, as pbrt assigns
every prim (its start before the split edge: below; its end after it:
above). Where no prim lies flat in a split plane, the two builds give the
same tree. The
flat node layout splits the rs union encoding into parallel arrays for the
device traversal:

- flags: 0/1/2 = interior split axis, 3 = leaf
- split: interior split position
- above:  interior -> index of the above child (below child is node+1);
          leaf -> offset into prim_ids
- nprims: leaf primitive count (0 for interior)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ISECT_COST = 80.0
TRAV_COST = 1.0
EMPTY_BONUS = 0.5


@dataclass
class FlatKdTree:
    flags: np.ndarray  # (N,) i32
    split: np.ndarray  # (N,) f32
    above: np.ndarray  # (N,) i32
    nprims: np.ndarray  # (N,) i32
    prim_ids: np.ndarray  # (M,) i32
    bounds_lo: np.ndarray  # (3,)
    bounds_hi: np.ndarray  # (3,)
    max_leaf: int  # longest leaf list (device scan bound)


def build_kdtree(lo: np.ndarray, hi: np.ndarray, max_prims: int = 1) -> FlatKdTree:
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    n = len(lo)
    if n == 0:
        return FlatKdTree(
            flags=np.full(1, 3, np.int32), split=np.zeros(1, np.float32),
            above=np.zeros(1, np.int32), nprims=np.zeros(1, np.int32),
            prim_ids=np.zeros(0, np.int32), bounds_lo=np.zeros(3),
            bounds_hi=np.ones(3), max_leaf=1,
        )
    max_depth = int(round(8.0 + 1.3 * np.log2(max(n, 2))))
    root_lo = lo.min(axis=0)
    root_hi = hi.max(axis=0)

    flags: list[int] = []
    split: list[float] = []
    above: list[int] = []
    nprims: list[int] = []
    prim_ids: list[int] = []
    max_leaf = [1]

    def emit(f, s, a, np_):
        flags.append(f)
        split.append(s)
        above.append(a)
        nprims.append(np_)
        return len(flags) - 1

    def make_leaf(idx):
        off = len(prim_ids)
        prim_ids.extend(int(i) for i in idx)
        max_leaf[0] = max(max_leaf[0], len(idx))
        return emit(3, 0.0, off, len(idx))

    def surface(b_lo, b_hi):
        d = np.maximum(b_hi - b_lo, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def rec(idx, b_lo, b_hi, depth, bad_refines):
        np_idx = len(idx)
        if np_idx <= max_prims or depth == 0:
            return make_leaf(idx)
        inv_total = 1.0 / max(surface(b_lo, b_hi), 1e-30)
        d = b_hi - b_lo
        best_axis, best_edge_t, best_cost = -1, 0.0, np.inf
        best_e, best_order = -1, None
        old_cost = ISECT_COST * np_idx
        axis = int(np.argmax(d))
        for retry in range(3):
            a = (axis + retry) % 3
            # edge sweep (kdtreeaccel.rs:246-320): starts then ends at ties
            starts = lo[idx, a]
            ends = hi[idx, a]
            ts = np.concatenate([starts, ends])
            kinds = np.concatenate([np.zeros(np_idx, np.int8), np.ones(np_idx, np.int8)])
            order = np.lexsort((kinds, ts))
            ts_s = ts[order]
            kinds_s = kinds[order]
            n_below = 0
            n_above = np_idx
            o1, o2 = (a + 1) % 3, (a + 2) % 3
            side = 2.0 * d[o1] * d[o2]
            edge_len = d[o1] + d[o2]
            for e in range(2 * np_idx):
                if kinds_s[e] == 1:
                    n_above -= 1
                t = ts_s[e]
                if b_lo[a] < t < b_hi[a]:
                    p_below = (side + 2.0 * edge_len * (t - b_lo[a])) * inv_total
                    p_above = (side + 2.0 * edge_len * (b_hi[a] - t)) * inv_total
                    eb = EMPTY_BONUS if (n_above == 0 or n_below == 0) else 0.0
                    cost = TRAV_COST + ISECT_COST * (1.0 - eb) * (p_below * n_below + p_above * n_above)
                    if cost < best_cost:
                        best_cost = cost
                        best_axis = a
                        best_edge_t = t
                        best_e, best_order = e, order
                if kinds_s[e] == 0:
                    n_below += 1
            if best_axis >= 0:
                break
        if best_cost > old_cost:
            bad_refines += 1
        if (best_cost > 4.0 * old_cost and np_idx < 16) or best_axis == -1 or bad_refines == 3:
            return make_leaf(idx)
        # below: lo < t, above: hi > t (the reference's rule); a prim lying
        # flat in the split plane (lo = hi = t) goes by its edges' places in
        # the sorted sweep, as kdtreeaccel.rs:360-366 assigns it (its start
        # before the split edge: below; its end after it: above)
        pos = np.empty(2 * np_idx, np.int64)
        pos[best_order] = np.arange(2 * np_idx)
        flat = (lo[idx, best_axis] == best_edge_t) & (hi[idx, best_axis] == best_edge_t)
        below_mask = (lo[idx, best_axis] < best_edge_t) | (flat & (pos[:np_idx] < best_e))
        above_mask = (hi[idx, best_axis] > best_edge_t) | (flat & (pos[np_idx:] > best_e))
        below_idx = idx[below_mask]
        above_idx = idx[above_mask]
        if len(below_idx) == np_idx and len(above_idx) == np_idx:
            return make_leaf(idx)
        node = emit(best_axis, best_edge_t, 0, 0)
        lo2 = b_hi.copy()
        lo2[best_axis] = best_edge_t
        rec(below_idx, b_lo, np.where(np.arange(3) == best_axis, best_edge_t, b_hi), depth - 1, bad_refines)
        above[node] = rec(above_idx, np.where(np.arange(3) == best_axis, best_edge_t, b_lo), b_hi, depth - 1, bad_refines)
        return node

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 64 * max_depth))
    try:
        rec(np.arange(n, dtype=np.int64), root_lo, root_hi, max_depth, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    return FlatKdTree(
        flags=np.asarray(flags, np.int32),
        split=np.asarray(split, np.float32),
        above=np.asarray(above, np.int32),
        nprims=np.asarray(nprims, np.int32),
        prim_ids=np.asarray(prim_ids, np.int32),
        bounds_lo=root_lo,
        bounds_hi=root_hi,
        max_leaf=max_leaf[0],
    )
