"""Batched ray-scene queries.

The port's counterpart of ``pbrt_tpu/device/intersect.py intersect /
intersect_p`` on its two routes:

- the brute-force route for scenes of at most 64 prims (no BVH tables):
  every ray against every triangle (``ray_triangle``, the watertight test of
  src/shapes/triangle.rs:136-399) and every sphere (``ray_sphere``,
  src/shapes/sphere.rs with EFloat root bounds and zmin/zmax/phimax
  clipping) by (R, P) broadcasting, then the nearest column, ties to the
  lowest (``_brute_all``, ``_select_min``, ``intersect_brute``,
  ``intersect_p_brute``);
- the wide-BVH route for larger scenes, through device/wide_bvh.py; in a
  mixed scene (``static.has_wide_tri`` without ``has_wide``) the walk covers
  the triangle subset and its at most 8 spheres are tested beside it with
  ``ray_sphere``, t_max clamped to the walk's winner, merged by t with a
  strict ``<`` so that the triangle keeps a tie (``_mixed_spheres``). The
  reference walks such scenes through its binary-BVH packet loop; the hits
  are the same, only the route differs.
"""
from __future__ import annotations

import functools
import math

import torch

from . import efloat as efl
from .affine import xf_point, xf_vector
from .wide_bvh import wide_intersect, wide_intersect_plain

# above this primitive count, sort rays by a direction-octant + origin-Morton
# key before traversal (intersect.SORT_MIN_PRIMS)
SORT_MIN_PRIMS = 4096
# hit epsilon of the triangle test (intersect.SHADOW_EPS)
SHADOW_EPS = 1e-4
TWO_PI = 2.0 * math.pi


def ray_triangle(o, d, p0, p1, p2, t_max):
    """Watertight ray-triangle intersection (broadcasting).

    o, d: (..., 3); p0/p1/p2: (..., 3); t_max: (...).
    Returns (hit, t, b0, b1, b2), barycentrics with respect to (p0, p1, p2)."""
    p0t = p0 - o
    p1t = p1 - o
    p2t = p2 - o
    # permute so |d_z| is the largest (triangle.rs max_dimension + permute)
    kz = torch.argmax(d.abs(), dim=-1)
    k0 = kz == 0
    k1 = kz == 1

    def _sel(v, i0, i1, i2):
        return torch.where(k0, v[..., i0], torch.where(k1, v[..., i1], v[..., i2]))

    def permute(v):
        # kx = kz + 1 mod 3, ky = kz + 2 mod 3
        return torch.stack([_sel(v, 1, 2, 0), _sel(v, 2, 0, 1), _sel(v, 0, 1, 2)], dim=-1)

    dp = permute(d)
    p0t = permute(p0t)
    p1t = permute(p1t)
    p2t = permute(p2t)
    # shear so the ray runs along +z
    inv_dz = 1.0 / dp[..., 2]
    sx = -dp[..., 0] * inv_dz
    sy = -dp[..., 1] * inv_dz
    sz = inv_dz
    x0 = p0t[..., 0] + sx * p0t[..., 2]
    y0 = p0t[..., 1] + sy * p0t[..., 2]
    x1 = p1t[..., 0] + sx * p1t[..., 2]
    y1 = p1t[..., 1] + sy * p1t[..., 2]
    x2 = p2t[..., 0] + sx * p2t[..., 2]
    y2 = p2t[..., 1] + sy * p2t[..., 2]
    # edge functions
    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1
    same_sign = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    det = e0 + e1 + e2
    z0 = sz * p0t[..., 2]
    z1 = sz * p1t[..., 2]
    z2 = sz * p2t[..., 2]
    t_scaled = e0 * z0 + e1 * z1 + e2 * z2
    det_nonzero = det != 0
    inv_det = torch.where(det_nonzero, 1.0 / torch.where(det_nonzero, det, 1.0), 0.0)
    t = t_scaled * inv_det
    hit = same_sign & det_nonzero & (t > SHADOW_EPS) & (t < t_max)
    return hit, t, e0 * inv_det, e1 * inv_det, e2 * inv_det


def ray_sphere(o, d, w2o, params, t_max):
    """Sphere intersection in object space: the sphere case of the
    reference's ray_quadric (sphere.rs), broadcasting.

    w2o: (..., 3, 4); params (..., 12): radius, zmin, zmax, phimax, ...
    A root is taken iff its EFloat interval is strictly positive and below
    t_max and its re-projected point passes the z and phi clips
    (sphere.rs:91-102). Returns (hit, t, p_obj), p_obj the re-projected
    object-space hit."""
    oo = xf_point(w2o, o)
    od = xf_vector(w2o, d)
    radius = params[..., 0]
    zmin = params[..., 1]
    zmax = params[..., 2]
    phimax = params[..., 3]
    o_err, d_err = efl.transform_ray_error(w2o, o, d)
    e_ox, e_oy, e_oz = (efl.ef(oo[..., i], o_err[..., i]) for i in range(3))
    e_dx, e_dy, e_dz = (efl.ef(od[..., i], d_err[..., i]) for i in range(3))
    e_a = efl.add(efl.add(efl.sqr(e_dx), efl.sqr(e_dy)), efl.sqr(e_dz))
    e_oxyd = efl.add(efl.mul(e_dx, e_ox), efl.mul(e_dy, e_oy))
    e_b = efl.scale(efl.add(e_oxyd, efl.mul(e_oz, e_dz)), 2.0)
    e_c = efl.sub(efl.add(efl.add(efl.sqr(e_ox), efl.sqr(e_oy)), efl.sqr(e_oz)), efl.sqr(efl.ef(radius)))
    has, (tn, tn_lo, tn_hi), (tf, tf_lo, tf_hi) = efl.quadratic(e_a, e_b, e_c)
    full = (zmin <= -radius + 1e-7 * radius) & (zmax >= radius - 1e-7 * radius) & (phimax >= TWO_PI - 1e-6)

    def clip_ok(t):
        p = oo + od * t[..., None]
        # refine onto the surface (sphere.rs re-projects the hit)
        s = radius / torch.clamp(torch.sqrt((p * p).sum(-1)), min=1e-30)
        pn = p * s[..., None]
        phi = torch.atan2(pn[..., 1], pn[..., 0])
        phi = torch.where(phi < 0, phi + TWO_PI, phi)
        z = pn[..., 2]
        return full | ((z >= zmin) & (z <= zmax) & (phi <= phimax)), pn

    okn, pn_near = clip_ok(tn)
    okf, pn_far = clip_ok(tf)
    near_valid = has & (tn_lo > 0) & (tn_hi < t_max) & okn
    far_valid = has & (tf_lo > 0) & (tf_hi < t_max) & okf
    t = torch.where(near_valid, tn, tf)
    p_obj = torch.where(near_valid[..., None], pn_near, pn_far)
    return near_valid | far_valid, t, p_obj


def _brute_all(sa, o, d, t_max):
    """Every ray against every prim by broadcasting. Returns (t, b1, b2)
    each (R, P) in table order (triangle rows, then sphere rows), t = inf
    where missed, and pid (P,) the prim row of each column. A sphere column
    carries its object-space hit's x and y in b1 and b2, as the reference's
    does."""
    o_b = o[:, None, :]
    d_b = d[:, None, :]
    tm = t_max[:, None]
    parts_t, parts_b1, parts_b2, parts_pid = [], [], [], []
    if sa.tri_p.shape[0] > 0:
        tv = sa.tri_p[None]
        h, t_t, _b0, b1, b2 = ray_triangle(o_b, d_b, tv[..., 0, :], tv[..., 1, :], tv[..., 2, :], tm)
        parts_t.append(torch.where(h, t_t, math.inf))
        parts_b1.append(b1)
        parts_b2.append(b2)
        parts_pid.append(sa.tri_prim_ids)
    if sa.sph_param.shape[0] > 0:
        h, t_s, p_obj = ray_sphere(o_b, d_b, sa.sph_w2o[None], sa.sph_param[None], tm)
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


def intersect_brute(sa, static, o, d, t_max):
    t, b1, b2, pid = _brute_all(sa, o, d, t_max)
    tbest, k, (b1_s, b2_s) = _select_min(t, [b1, b2])
    return {"t": tbest, "prim": torch.where(torch.isfinite(tbest), pid[k], -1), "b1": b1_s, "b2": b2_s}


def intersect_p_brute(sa, static, o, d, t_max):
    t = _brute_all(sa, o, d, t_max)[0]
    return torch.isfinite(t).any(1)


def _t_max(o, t_max):
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device), (o.shape[0],))


def _mixed_spheres(sa, o, d, t_max):
    """A mixed scene's spheres against every ray, by broadcasting: (t (R, S)
    with inf where missed, p_obj (R, S, 3))."""
    h, t_s, p_obj = ray_sphere(o[:, None, :], d[:, None, :], sa.sph_w2o[None], sa.sph_param[None], t_max[:, None])
    return torch.where(h, t_s, math.inf), p_obj


def _walk(joint, plain):
    """The wide query: the kernels' (wide_intersect), or with plain their
    plain twin on any device."""
    return wide_intersect_plain if plain else functools.partial(wide_intersect, joint=joint)


def intersect(sa, static, o, d, t_max, sort_rays=False, joint=False, plain=False):
    """Closest-hit query. Returns hit dict {t, prim, b1, b2}. joint: CUDA
    rays of a wide scene go through the joint traversal kernel; plain: the
    walk's plain twin, on any device (no route sets it)."""
    R = o.shape[0]
    if static.n_prims == 0:
        return {"t": torch.full((R,), math.inf, device=o.device), "prim": torch.full((R,), -1, device=o.device),
                "b1": torch.zeros(R, device=o.device), "b2": torch.zeros(R, device=o.device)}
    if static.use_brute_force:
        return intersect_brute(sa, static, o, d, _t_max(o, t_max))
    sort = sort_rays and static.n_prims >= SORT_MIN_PRIMS
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


def intersect_p(sa, static, o, d, t_max, sort_rays=False, joint=False, plain=False):
    """Any-hit (shadow) query -> bool (R,). (scene.rs intersect_p)"""
    if static.n_prims == 0:
        return torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    if static.use_brute_force:
        return intersect_p_brute(sa, static, o, d, _t_max(o, t_max))
    sort = sort_rays and static.n_prims >= SORT_MIN_PRIMS
    _t, _slot, hit_any = _walk(joint, plain)(sa, o, d, t_max, any_hit=True, sort=sort)
    if static.n_spheres:
        hit_any = hit_any | torch.isfinite(_mixed_spheres(sa, o, d, _t_max(o, t_max))[0]).any(1)
    return hit_any
