"""Host-side wide-BVH (branching factor 8) for the traversal kernel.

A copy of ``pbrt_tpu/scene/widebvh.py``: the port keeps the reference's
table layout (designed for the TPU's Pallas kernel, described below) so the
CUDA kernel in ``csrc/wide_traverse.cu`` and the reference traverse
bit-identical tables.

The binary SAH BVH (bvh.py; reference layout src/accelerators/bvh.rs:89-95)
is collapsed into 8-wide nodes and packed into two VMEM-resident tables laid
out for the TPU tiling constraints (last dim 128 lanes, f32 sublane 8):

- node table, 8 nodes per (8, 128) block: node ``nid`` occupies rows
  ``(nid // 8) * 8 .. +8`` and lanes ``(nid % 8) * 16 .. +16`` (Mosaic only
  allows 128-aligned dynamic lane offsets, so the kernel loads the aligned
  block and selects the 16-lane column group with a `lax.switch` over the 8
  static slices); sublane = child slot, lanes = [lo_x, lo_y, lo_z, hi_x,
  hi_y, hi_z, meta, axis, pad(8)].
  ``meta`` > 0: interior child (wide node id); < 0: leaf octet ``-(oct+1)``;
  0: empty slot. Child slots are pre-sorted by centroid along the node's
  dominant axis so the kernel can walk them forward/backward by ray
  direction sign (the TPU stand-in for bvh.rs:705-760 dir-sign ordering).
- prim table, 8 octets per (8, 128) block: octet ``o`` occupies rows
  ``(o // 8) * 8 .. +8`` and lanes ``(o % 8) * 16 .. +16``; sublane = prim,
  lanes = [p0(3), p1(3), p2(3), valid, prim_id, pad(5)]. Triangles only —
  the kernel runs the watertight shear test on raw vertices and returns the
  winning GLOBAL prim row + barycentrics directly (prim_id is exact in f32
  up to 2^24 rows). A leaf is a PAIR of consecutive octets (<= 16 prims,
  padded with valid=0 rows); the first octet id is even, so both octets
  sit in adjacent 16-lane groups of the same block rows.

``slot_prim`` maps kernel slot ids (oct * 8 + sublane) back to global
primitive rows for shading.

``hopper_layout`` derives a second layout of the same tree from those
tables, the one the CUDA walks and their plain twin read (the reference
layout stays what compile_scene builds and the table tests compare):

- node records, ``(n_nodes, 64)`` f32: record ``nid`` holds its 8 children
  one after another, 8 floats each, the reference row's lanes 0-7 [lo_x,
  lo_y, lo_z, hi_x, hi_y, hi_z, meta, axis]: 256 contiguous bytes, two
  128-byte lines, where the reference puts a node's children 512 bytes
  apart. Only the meta column changes, to the int32 bits (viewed as f32) of
  ``hopper_meta``: an interior child keeps its id | axis << 21, an empty
  slot 0, and a leaf child becomes ``~(leaf << 4 | n - 1)``, leaf = its
  first octet // 2 and n its count of valid rows, so a walk learns both
  from the record it already loaded. Record 0 (the sentinel node) holds the
  root's meta in child 0, as ``meta_tab[0]`` does.
- leaf rows, ``(n_octets * 8, 16)`` f32: row ``oct * 8 + k`` is the
  reference's 16-lane prim row of octet ``oct``, sublane ``k``, so row
  index = kernel slot, and leaf L's rows in the reference's order j (octet
  2L rows 0-7, then octet 2L+1 rows 0-7) are the 1,024 contiguous bytes
  from row 16L; its n valid rows are rows 16L .. 16L + n - 1.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bvh import build_bvh

WIDE = 8
# a leaf is a PAIR of consecutive octets (<= 16 prims): per-visit scalar
# overhead (pop + meta extract + mask transfer, ~250ns) dwarfs the vector
# cost of testing 8 more triangle rows, so doubling the leaf width halves
# the dominant leaf-visit count for ~free
WIDE_LEAF = 16


@dataclass
class WideBVH:
    node_tab: np.ndarray  # (ceil(Nw/16)*8, 128) f32
    prim_tab: np.ndarray  # (ceil(n_oct/8)*8, 128) f32
    slot_prim: np.ndarray  # (n_oct*8,) i32 global prim row or -1
    attr_tab: np.ndarray | None  # prim_tab-shaped per-prim attribute rows
    meta_tab: np.ndarray  # (n_nodes*8,) i32 child metas; row nid*8+slot.
    # meta_tab[0:8] seeds the root (sentinel parent 0, child 0 = root meta) —
    # lets the kernel keep child metas in SMEM and read them with scalar
    # loads instead of a ~90ns vector->scalar extract per pop
    n_nodes: int
    n_octets: int
    root: int  # packed root meta: node id | axis << 21 (id >= 1; 0 = empty)


def _subtree_ranges(bvh):
    """Per-binary-node contiguous prim range (start, count): prims are
    emitted depth-first, so every subtree's prims are contiguous."""
    n = len(bvh.n_prims)
    start = np.zeros(n, np.int64)
    count = np.zeros(n, np.int64)
    # iterative post-order (SAH trees can be deep)
    stack = [(0, False)]
    while stack:
        i, done = stack.pop()
        if bvh.n_prims[i] > 0:
            start[i] = bvh.offset[i]
            count[i] = bvh.n_prims[i]
            continue
        l, r = i + 1, int(bvh.offset[i])
        if done:
            start[i] = start[l]
            count[i] = count[l] + count[r]
        else:
            stack.append((i, True))
            stack.append((l, False))
            stack.append((r, False))
    return start, count


def _collapse(bvh):
    """Binary flat BVH -> wide nodes.

    SAH binary trees bottom out at ~1 prim per leaf; an octet per binary
    leaf would waste 7/8 of the prim table (and blow the VMEM budget), so
    any binary SUBTREE holding <= WIDE_LEAF prims is flattened into one
    octet (its prims are contiguous in leaf order).

    Returns (nodes, octets, root): nodes[wid] = {"axis", "slots"}, slot =
    (bmin, bmax, centroid, ('n', wide_id) | ('l', oct_id)); octets =
    list of (off, n) contiguous prim ranges.
    """
    start, count = _subtree_ranges(bvh)
    octets: list[tuple[int, int]] = []
    # wide ids start at 1 (0 = empty sentinel)
    nodes: list[dict] = [None]  # type: ignore[list-item]

    def leaf_oct(b):
        """Allocate the octet PAIR for a <=16-prim leaf; returns the first
        (even) octet id — the kernel tests octets o and o+1 per leaf visit."""
        off, n = int(start[b]), int(count[b])
        o0 = len(octets)
        octets.append((off, min(n, 8)))
        octets.append((off + 8, max(n - 8, 0)))
        return o0

    def build_wide(b):
        """Collapse the binary subtree at `b` (count > WIDE_LEAF) into one
        wide node; returns its wide id."""
        wid = len(nodes)
        nodes.append(None)  # reserve slot (parent-before-children ordering)
        # expand the frontier: greedily split the largest-area slot that
        # still holds more than an octet of prims
        slots = [b]
        while len(slots) < WIDE:
            best = -1
            best_area = -1.0
            for i, s in enumerate(slots):
                if count[s] > WIDE_LEAF:
                    d = np.maximum(bvh.bounds_max[s] - bvh.bounds_min[s], 0)
                    area = float(d[0] * d[1] + d[1] * d[2] + d[0] * d[2])
                    if area > best_area:
                        best_area = area
                        best = i
            if best < 0:
                break
            s = slots.pop(best)
            slots.append(s + 1)  # first child is next in depth-first order
            slots.append(int(bvh.offset[s]))
        ax = int(bvh.axis[b])
        ent = []
        for s in slots:
            bmin = bvh.bounds_min[s]
            bmax = bvh.bounds_max[s]
            if count[s] <= WIDE_LEAF:
                ent.append((bmin, bmax, 0.5 * (bmin[ax] + bmax[ax]), ("l", leaf_oct(s))))
            else:
                ent.append((bmin, bmax, 0.5 * (bmin[ax] + bmax[ax]), ("n", build_wide(s))))
        ent.sort(key=lambda e: e[2])
        nodes[wid] = {"axis": ax, "slots": ent}
        return wid

    if count[0] <= WIDE_LEAF:
        # tiny scene: one wide node with one leaf slot
        nodes.append({
            "axis": 0,
            "slots": [(bvh.bounds_min[0], bvh.bounds_max[0], 0.0, ("l", leaf_oct(0)))],
        })
        return nodes, octets, 1
    root = build_wide(0)
    return nodes, octets, root


def build_wide_bvh(lo: np.ndarray, hi: np.ndarray, tri_v0: np.ndarray,
                   tri_v1: np.ndarray, tri_v2: np.ndarray,
                   extra_cols: np.ndarray | None = None,
                   attr_cols: np.ndarray | None = None) -> WideBVH:
    """Build the packed wide BVH over triangle prims.

    lo/hi: (P, 3) world AABBs (in GLOBAL prim order); tri_v0/v1/v2: (P, 3)
    per-prim triangle vertices (world space). extra_cols: optional (P, K<=5)
    per-prim payload written into row columns 11:11+K (the wide megakernel
    rides material id / light id / flip flag here so shading attrs come out
    of the leaf-phase winner reductions with no second table).

    attr_cols: optional (P, K<=16) per-prim attribute payload packed into a
    SECOND prim_tab-shaped table with identical (octet, slot) indexing —
    lanes 0..K of each 16-lane prim group. The wide megakernel rides the
    three per-vertex shading normals here (9 floats) so smooth-shaded
    meshes stay in-kernel (triangle.rs:355-360 interpolation).
    """
    import sys

    p = len(lo)
    assert p < (1 << 24), "prim ids ride the f32 prim table (exact < 2^24)"
    bvh = build_bvh(lo, hi, WIDE_LEAF)
    order = np.asarray(bvh.prim_ids, dtype=np.int64)  # leaf-order -> global

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        nodes, octets, root = _collapse(bvh)
    finally:
        sys.setrecursionlimit(old)

    n_nodes = len(nodes)  # includes the id-0 sentinel
    n_oct = len(octets)

    node_blocks = (n_nodes + 7) // 8
    node_tab = np.zeros((node_blocks * 8, 128), np.float32)
    meta_tab = np.zeros(n_nodes * 8, np.int32)
    for nid in range(1, n_nodes):
        nd = nodes[nid]
        r0 = (nid // 8) * 8
        c0 = (nid % 8) * 16
        for ci, (bmin, bmax, _c, (kind, ref)) in enumerate(nd["slots"]):
            # interior meta packs the CHILD's split axis in bits 21-22 so the
            # kernel never reads the axis back out of vector memory:
            # meta = child_id | axis << 21 (exact in f32 below 2^24)
            if kind == "n":
                meta = float(ref + (nodes[ref]["axis"] << 21))
            else:
                meta = -float(ref + 1)
            meta_tab[nid * 8 + ci] = int(meta)
            node_tab[r0 + ci, c0:c0 + 8] = [
                bmin[0], bmin[1], bmin[2], bmax[0], bmax[1], bmax[2], meta, float(nd["axis"]),
            ]
        for ci in range(len(nd["slots"]), WIDE):
            # empty slot: NaN box (every slab comparison is false, so the
            # slot can never enter the hit mask; a +-inf "inverted" box
            # would pass the min/max slab test because lo > hi swaps the
            # interval), meta 0
            node_tab[r0 + ci, c0:c0 + 8] = [np.nan] * 6 + [0.0, float(nd["axis"])]

    prim_blocks = (n_oct + 7) // 8
    prim_tab = np.zeros((max(prim_blocks, 1) * 8, 128), np.float32)
    attr_tab = (np.zeros_like(prim_tab) if attr_cols is not None else None)
    slot_prim = np.full(max(n_oct, 1) * 8, -1, np.int32)
    for o, (off, n) in enumerate(octets):
        r0 = (o // 8) * 8
        c0 = (o % 8) * 16
        for k in range(min(n, 8)):
            g = int(order[off + k])
            row = np.zeros(16, np.float32)
            row[0:3] = tri_v0[g]
            row[3:6] = tri_v1[g]
            row[6:9] = tri_v2[g]
            row[9] = 1.0
            row[10] = float(g)  # global prim row (exact in f32 < 2^24)
            if extra_cols is not None:
                k_extra = extra_cols.shape[1]
                row[11:11 + k_extra] = extra_cols[g]
            prim_tab[r0 + k, c0:c0 + 16] = row
            if attr_tab is not None:
                attr_tab[r0 + k, c0:c0 + attr_cols.shape[1]] = attr_cols[g]
            slot_prim[o * 8 + k] = g

    packed_root = root + (nodes[root]["axis"] << 21)
    meta_tab[0] = packed_root  # sentinel parent 0, child slot 0 = the root
    return WideBVH(
        node_tab=node_tab,
        prim_tab=prim_tab,
        slot_prim=slot_prim,
        attr_tab=attr_tab,
        meta_tab=meta_tab,
        n_nodes=n_nodes,
        n_octets=n_oct,
        # root meta is packed like child metas: id | axis << 21 (the kernel
        # seeds its stack with this value directly)
        root=packed_root,
    )


# --- the Hopper layout (see the module docstring) ------------------------------

NODE_REC = 64  # floats per node record: 8 children x 8 floats
LEAF_ROWS = 2 * WIDE  # rows per leaf record (an octet pair)
ROW = 16  # floats per leaf row


def hopper_meta(meta: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """The node records' meta (int32) for reference metas and, for leaf
    children, their counts of valid rows (1..16): interior and empty metas
    unchanged, leaf ``-(oct + 1)`` -> ``~((oct // 2) << 4 | n - 1)``."""
    meta = np.asarray(meta, np.int64)
    oct_ = -meta - 1
    leaf = ~(((oct_ >> 1) << 4) | (np.asarray(n_valid, np.int64) - 1))
    return np.where(meta < 0, leaf, meta).astype(np.int32)


def node_child_offset(nid, c):
    """Float offset of child c of node nid in the node records."""
    return nid * NODE_REC + c * 8


def leaf_row_offset(slot):
    """Float offset of kernel slot ``oct * 8 + k`` (the reference's prim row
    of octet oct, sublane k) in the leaf rows."""
    return slot * ROW


def hopper_layout(node_tab: np.ndarray, prim_tab: np.ndarray, meta_tab: np.ndarray):
    """(node records (n_nodes, 64) f32, leaf rows (n_octets * 8, 16) f32)
    from the reference tables, n_nodes = len(meta_tab) // 8 and n_octets =
    every octet the prim table's blocks hold."""
    n_nodes = len(meta_tab) // WIDE
    nb, pb = node_tab.shape[0] // 8, prim_tab.shape[0] // 8
    # (block, child row, node in block, lane) -> (node, child, lane)
    nodes = node_tab.reshape(nb, 8, 8, 16).transpose(0, 2, 1, 3).reshape(nb * 8, 8, 16)[:n_nodes, :, :8]
    rows = np.ascontiguousarray(prim_tab.reshape(pb, 8, 8, 16).transpose(0, 2, 1, 3).reshape(pb * 64, ROW),
                                dtype=np.float32)
    valid = (rows[:, 9] > 0).reshape(-1, LEAF_ROWS)
    n_valid = valid.sum(axis=1)
    # a leaf's valid rows are its first n (build_wide_bvh fills octet o, then o + 1)
    assert (valid == (np.arange(LEAF_ROWS) < n_valid[:, None])).all()
    meta = np.asarray(meta_tab, np.int64).reshape(n_nodes, WIDE)
    leaf_of = np.where(meta < 0, (-meta - 1) >> 1, 0)
    n_child = np.where(meta < 0, n_valid[leaf_of], 1)
    assert (n_child >= 1).all()
    rec = np.array(nodes, dtype=np.float32)
    rec[:, :, 6] = hopper_meta(meta, n_child).view(np.float32)
    return rec.reshape(n_nodes, NODE_REC), rows
