"""Batched ray-scene queries, routed to the wide-BVH traversal.

The port's counterpart of ``pbrt_tpu/device/intersect.py intersect /
intersect_p`` on its wide-BVH route (``_wide_closest`` and the any-hit
branch of ``_intersect_p_once``). The port has no other route yet: scenes
without wide tables are refused at compile time.
"""
from __future__ import annotations

import math

import torch

from .wide_bvh import wide_intersect

# above this primitive count, sort rays by a direction-octant + origin-Morton
# key before traversal (intersect.SORT_MIN_PRIMS)
SORT_MIN_PRIMS = 4096


def _require_wide(static):
    if not static.has_wide:
        raise NotImplementedError("pbrt_tpu_torch traverses only scenes with wide-BVH tables")


def intersect(sa, static, o, d, t_max, sort_rays=False, joint=False):
    """Closest-hit query. Returns hit dict {t, prim, b1, b2}. joint: CUDA
    rays go through the joint traversal kernel."""
    _require_wide(static)
    sort = sort_rays and static.n_prims >= SORT_MIN_PRIMS
    t, prim, hitm, b1, b2 = wide_intersect(sa, o, d, t_max, sort=sort, joint=joint)
    return {
        "t": torch.where(hitm, t, math.inf),
        "prim": prim,
        "b1": torch.where(hitm, torch.clamp(b1, 0.0, 1.0), 0.0),
        "b2": torch.where(hitm, torch.clamp(b2, 0.0, 1.0), 0.0),
    }


def intersect_p(sa, static, o, d, t_max, sort_rays=False, joint=False):
    """Any-hit (shadow) query -> bool (R,). (scene.rs intersect_p)"""
    _require_wide(static)
    sort = sort_rays and static.n_prims >= SORT_MIN_PRIMS
    _t, _slot, hit_any = wide_intersect(sa, o, d, t_max, any_hit=True, sort=sort, joint=joint)
    return hit_any
