"""Batched ray-scene queries.

The port's counterpart of ``pbrt_tpu/device/intersect.py intersect /
intersect_p``, routed as the reference's ``_intersect_once`` (:815-870):

- the brute-force route for scenes of at most 64 prims without instances
  (no BVH tables): every ray against every triangle and quadric
  (device/prims.py) by (R, P) broadcasting, then the nearest column, ties
  to the lowest (``_brute_all``, ``_select_min``, ``intersect_brute``,
  ``intersect_p_brute``);
- then the kd-tree of a scene with ``Accelerator "kdtree"``, and
- the wide-BVH route of a scene with the wide tables, through
  device/wide_bvh.py; in a mixed scene (``static.has_wide_tri`` without
  ``has_wide``) whose quadrics are all spheres, the walk covers the
  triangle subset and its at most 8 spheres are tested beside it, t_max
  clamped to the walk's winner, merged by t with a strict ``<`` so that the
  triangle keeps a tie (``_mixed_spheres``);
- then the binary BVH: every other scene (instances, other quadrics beside
  more than 64 triangles), through device/bvh_walk.py, as the reference
  takes such scenes through its packet loop ``_traverse``.

Motion blur: every query takes the rays' shutter fractions ``time`` (None
for a static query, and ignored in a scene without moving prims, as the
reference's). A scene with moving prims has no wide tables (the builder
builds none), so it takes the brute route, moving every prim to each ray's
time by broadcasting (reference ``_brute_all`` :408-431), or the time-aware
BVH or kd-tree walk of device/bvh_walk.py; ``route_name`` is then "brute",
"bvh" or "kdtree".

A scene with alpha cutouts re-casts a ray past each cut hit, at most
ALPHA_PASSES times, over whichever route the scene takes
(``_intersect_alpha``, reference :1051-1098); its shadow query is the
closest-hit query, as in the reference. The hits are the reference's; only
the walks differ (per ray instead of per packet), so ties in t may pick
another prim.
"""
from __future__ import annotations

import functools
import math

import torch

from .bvh_walk import walk_intersect
from .motion import motion_matrices, motion_quad, xform_point
from .prims import SHADOW_EPS, SPHERE, ray_quadric, ray_sphere, ray_triangle  # noqa: F401 (the module's API)
from .wide_bvh import wide_intersect, wide_intersect_plain

# above this primitive count, sort rays by a direction-octant + origin-Morton
# key before traversal (intersect.SORT_MIN_PRIMS)
SORT_MIN_PRIMS = 4096
GEOM_TRI = 0  # scene.arrays.GEOM_TRI
# re-casts past cut hits in an alpha scene (intersect.ALPHA_PASSES)
ALPHA_PASSES = 4


def _brute_all(sa, static, o, d, t_max, time=None):
    """Every ray against every prim by broadcasting. Returns (t, b1, b2)
    each (R, P) in table order (triangle rows, then quadric rows), t = inf
    where missed, and pid (P,) the prim row of each column. A quadric
    column carries its object-space hit's x and y in b1 and b2, as the
    reference's does. With time (R,), every prim is moved to each ray's
    time first: the exact animated transform, or the keyframe rows."""
    o_b = o[:, None, :]
    d_b = d[:, None, :]
    tm = t_max[:, None]
    exact = time is not None and static.has_rot_motion
    keyed = time is not None and not exact
    parts_t, parts_b1, parts_b2, parts_pid = [], [], [], []
    if sa.tri_p.shape[0] > 0:
        tv = sa.tri_p[None]
        if exact:
            g = motion_matrices(sa, sa.tri_prim_ids.to(torch.int64)[None, :], time[:, None])
            tv = xform_point(g[:, :, None], tv)
        elif keyed:
            tv = motion_quad(tv, sa.tri_p_end[None], None if sa.tri_p_mid is None else sa.tri_p_mid[None],
                             time[:, None, None, None])
        h, t_t, _b0, b1, b2 = ray_triangle(o_b, d_b, tv[..., 0, :], tv[..., 1, :], tv[..., 2, :], tm)
        parts_t.append(torch.where(h, t_t, math.inf))
        parts_b1.append(b1)
        parts_b2.append(b2)
        parts_pid.append(sa.tri_prim_ids)
    if sa.sph_param.shape[0] > 0:
        w2o = sa.sph_w2o[None]
        if exact:
            w2o = motion_matrices(sa, sa.sph_prim_ids.to(torch.int64)[None, :], time[:, None], quadric=True)
        elif keyed:
            w2o = motion_quad(w2o, sa.sph_w2o_end[None], None if sa.sph_w2o_mid is None else sa.sph_w2o_mid[None],
                              time[:, None, None, None])
        h, t_s, p_obj = ray_quadric(o_b, d_b, w2o, sa.sph_param[None], sa.sph_kind[None].to(torch.int64),
                                    tm, kinds=frozenset(static.quadric_kinds))
        parts_t.append(torch.where(h, t_s, math.inf))
        parts_b1.append(p_obj[..., 0])
        parts_b2.append(p_obj[..., 1])
        parts_pid.append(sa.sph_prim_ids)
    return (torch.cat(parts_t, 1), torch.cat(parts_b1, 1), torch.cat(parts_b2, 1),
            torch.cat(parts_pid).to(torch.int64))


def _select_min(t, cols):
    """Row-wise nearest column of (R, K) t, ties to the lowest column
    (the reference's one-hot _select_min). Returns (tbest, column index,
    [each of cols (R, K) at that column])."""
    tbest, k = torch.min(t, dim=1)
    return tbest, k, [c.gather(1, k[:, None])[:, 0] for c in cols]


def intersect_brute(sa, static, o, d, t_max, time=None):
    t, b1, b2, pid = _brute_all(sa, static, o, d, t_max, time)
    tbest, k, (b1_s, b2_s) = _select_min(t, [b1, b2])
    return {"t": tbest, "prim": torch.where(torch.isfinite(tbest), pid[k], -1), "b1": b1_s, "b2": b2_s}


def intersect_p_brute(sa, static, o, d, t_max, time=None):
    t = _brute_all(sa, static, o, d, t_max, time)[0]
    return torch.isfinite(t).any(1)


def _t_max(o, t_max):
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device), (o.shape[0],))


def _mixed_spheres(sa, o, d, t_max):
    """A mixed scene's spheres against every ray, by broadcasting: (t (R, S)
    with inf where missed, p_obj (R, S, 3))."""
    h, t_s, p_obj = ray_sphere(o[:, None, :], d[:, None, :], sa.sph_w2o[None], sa.sph_param[None], t_max[:, None])
    return torch.where(h, t_s, math.inf), p_obj


def _wide_route(static) -> bool:
    """The wide tables serve the query: a triangle-only scene, or a mixed
    scene whose quadrics are all spheres (the mixed route)."""
    return static.has_wide_tri and (static.has_wide or set(static.quadric_kinds) <= {SPHERE})


def _walk(joint, plain):
    """The wide query: the kernels' (wide_intersect), or with plain their
    plain twin on any device."""
    return wide_intersect_plain if plain else functools.partial(wide_intersect, joint=joint)


def route_name(static, joint=False) -> str:
    """The query's route: "brute", "kdtree", "wide", "wide-joint" (either
    with "-mixed" for the spheres beside the walk) or "bvh"."""
    if static.use_brute_force:
        return "brute"
    if static.accel_kind == "kdtree":
        return "kdtree"
    if _wide_route(static):
        return ("wide-joint" if joint else "wide") + ("-mixed" if static.n_spheres else "")
    return "bvh"


def _intersect_once(sa, static, o, d, t_max, sort_rays=False, joint=False, plain=False, time=None):
    """One closest-hit pass (no alpha cutouts)."""
    R = o.shape[0]
    if not static.has_motion:
        time = None
    if static.n_prims == 0:
        return {"t": torch.full((R,), math.inf, device=o.device), "prim": torch.full((R,), -1, device=o.device),
                "b1": torch.zeros(R, device=o.device), "b2": torch.zeros(R, device=o.device)}
    if static.use_brute_force:
        return intersect_brute(sa, static, o, d, _t_max(o, t_max), time)
    sort = sort_rays and static.n_prims >= SORT_MIN_PRIMS
    if not _wide_route(static):
        t, prim, _hit, b1, b2 = walk_intersect(sa, static, o, d, t_max, sort=sort, plain=plain, time=time)
        return {"t": t, "prim": prim, "b1": b1, "b2": b2}
    t, prim, hitm, b1, b2 = _walk(joint, plain)(sa, o, d, t_max, sort=sort)
    b1 = torch.where(hitm, torch.clamp(b1, 0.0, 1.0), 0.0)
    b2 = torch.where(hitm, torch.clamp(b2, 0.0, 1.0), 0.0)
    if static.n_spheres:
        # the spheres beside the triangle walk, below its winner's t; a
        # sphere column carries its object-space hit's x and y in b1 and b2,
        # as the brute route's does
        t_s, p_obj = _mixed_spheres(sa, o, d, torch.minimum(_t_max(o, t_max), t))
        ts_best, k = torch.min(t_s, dim=1)
        better = ts_best < t
        t = torch.where(better, ts_best, t)
        prim = torch.where(better, sa.sph_prim_ids.to(torch.int64)[k], prim)
        p_k = p_obj.gather(1, k[:, None, None].expand(-1, 1, 3))[:, 0]
        b1 = torch.where(better, p_k[:, 0], b1)
        b2 = torch.where(better, p_k[:, 1], b2)
        hitm = hitm | better
    return {"t": torch.where(hitm, t, math.inf), "prim": prim, "b1": b1, "b2": b2}


def _intersect_p_once(sa, static, o, d, t_max, sort_rays=False, joint=False, plain=False, time=None):
    """One any-hit pass (no alpha cutouts)."""
    if not static.has_motion:
        time = None
    if static.n_prims == 0:
        return torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    if static.use_brute_force:
        return intersect_p_brute(sa, static, o, d, _t_max(o, t_max), time)
    sort = sort_rays and static.n_prims >= SORT_MIN_PRIMS
    if not _wide_route(static):
        return walk_intersect(sa, static, o, d, t_max, any_hit=True, sort=sort, plain=plain, time=time)[2]
    _t, _slot, hit_any = _walk(joint, plain)(sa, o, d, t_max, any_hit=True, sort=sort)
    if static.n_spheres:
        hit_any = hit_any | torch.isfinite(_mixed_spheres(sa, o, d, _t_max(o, t_max))[0]).any(1)
    return hit_any


def _alpha_cut_mask(sa, static, hit, o, d, shadow: bool):
    """True where the hit lands on a zero-alpha point of a cut-out
    triangle (triangle.rs:29-30 alpha_mask / shadow_alpha_mask; reference
    _alpha_cut_mask): the prim's alpha (or shadow-alpha) float texture at
    the hit's uv, without differentials."""
    from .texture import eval_textures, needed_programs

    prim = torch.clamp(hit["prim"], min=0)
    tex = (sa.prim_shadow_alpha_tex if shadow else sa.prim_alpha_tex)[prim]
    geom = sa.prim_geom[prim]
    is_tri = sa.prim_kind[prim] == GEOM_TRI
    uvv = sa.tri_uv[torch.where(is_tri, geom, 0)]
    b1 = hit["b1"][:, None]
    b2 = hit["b2"][:, None]
    uv = (1.0 - b1 - b2) * uvv[:, 0] + b1 * uvv[:, 1] + b2 * uvv[:, 2]
    p_hit = o + d * hit["t"][:, None]
    vals = eval_textures(sa, static.tex_programs, uv, p_hit, only=needed_programs(static.tex_programs,
                                                                                   static.alpha_programs))
    a = torch.ones(uv.shape[0], dtype=torch.float32, device=uv.device)
    for xi in static.alpha_programs:
        a = torch.where(tex == xi, vals[xi][:, 0], a)
    return (hit["prim"] >= 0) & is_tri & (tex >= 0) & (a == 0.0)


def _intersect_alpha(sa, static, o, d, t_max, sort_rays, joint, plain, shadow: bool, time=None):
    """The closest hit that is not cut out, t measured from o: each cut
    hit's ray is re-cast from just past it, at most ALPHA_PASSES times (the
    other rays ride along dead, t_max < 0); a hit still cut after them is
    dropped (reference _intersect_alpha)."""
    tm0 = _t_max(o, t_max)
    o_cur = o
    acc = torch.zeros(o.shape[0], dtype=torch.float32, device=o.device)
    hit = _intersect_once(sa, static, o_cur, d, tm0, sort_rays, joint, plain, time)
    for _ in range(ALPHA_PASSES):
        cut = _alpha_cut_mask(sa, static, hit, o_cur, d, shadow)
        adv = hit["t"] * (1.0 + 1e-4) + 1e-4
        o_cur = torch.where(cut[:, None], o_cur + d * adv[:, None], o_cur)
        acc = acc + torch.where(cut, adv, 0.0)
        tq = torch.where(cut, tm0 - acc, -1.0)
        h2 = _intersect_once(sa, static, o_cur, d, tq, sort_rays, joint, plain, time)
        hit = {k: torch.where(cut, h2[k], v) for k, v in hit.items()}
    cut = _alpha_cut_mask(sa, static, hit, o_cur, d, shadow)
    t_final = torch.where(cut, math.inf, hit["t"]) + acc
    prim = torch.where(cut | (hit["prim"] < 0), -1, hit["prim"])
    return {"t": torch.where(prim >= 0, t_final, math.inf), "prim": prim, "b1": hit["b1"], "b2": hit["b2"]}


def intersect(sa, static, o, d, t_max, sort_rays=False, joint=False, plain=False, time=None):
    """Closest-hit query. Returns hit dict {t, prim, b1, b2}. joint: CUDA
    rays of a wide scene go through the joint traversal kernel; plain: the
    walks' plain twins, on any device (no route sets it); time: the rays'
    shutter fractions (R,) in a scene with motion."""
    if static.has_alpha and static.n_prims > 0:
        return _intersect_alpha(sa, static, o, d, t_max, sort_rays, joint, plain, False, time)
    return _intersect_once(sa, static, o, d, t_max, sort_rays, joint, plain, time)


def intersect_p(sa, static, o, d, t_max, sort_rays=False, joint=False, plain=False, time=None):
    """Any-hit (shadow) query -> bool (R,). (scene.rs intersect_p)"""
    if static.has_alpha and static.n_prims > 0:
        return _intersect_alpha(sa, static, o, d, t_max, sort_rays, joint, plain, True, time)["prim"] >= 0
    return _intersect_p_once(sa, static, o, d, t_max, sort_rays, joint, plain, time)
