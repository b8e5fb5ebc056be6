"""Ray tests against one primitive: the watertight triangle and the six
quadrics, batched by broadcasting.

The port's counterpart of ``pbrt_tpu/device/intersect.py ray_triangle``
(src/shapes/triangle.rs:136-399) and ``ray_quadric`` (:124-268: sphere.rs,
cylinder.rs, disk.rs, cone.rs, paraboloid.rs, hyperboloid.rs), in the
reference's order of operations, so hits and t agree with it. The quadric
roots are EFloat intervals (device/efloat.py) and a root counts only when
its interval is strictly positive and below t_max; the cone uses the
corrected k = (radius / height)^2 (the reference's own fix of cone.rs:73-75);
a hyperboloid with its p1, p2 (params of 12 columns) measures phi against
the twisted frame of its revolved segment (hyperboloid.rs:96-105). The
brute route, the mixed route's quadrics beside the wide walk and the plain
walks of device/bvh_walk.py all test through these; csrc/quadric.cuh is
their CUDA transcription.
"""
from __future__ import annotations

import math

import torch

from . import efloat as efl
from .affine import xf_point, xf_vector

# hit epsilon of the triangle test (intersect.SHADOW_EPS)
SHADOW_EPS = 1e-4
TWO_PI = 2.0 * math.pi

# quadric sub-kinds (scene.arrays.QUADRIC_*)
SPHERE, CYLINDER, DISK, CONE, PARABOLOID, HYPERBOLOID = range(6)
ALL_KINDS = frozenset(range(6))


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


def _w3(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def ray_quadric(o, d, w2o, params, qkind, t_max, kinds=ALL_KINDS):
    """Quadric intersection in object space (broadcasting).

    w2o: (..., 3, 4); params: (..., 6) or (..., 12), as the reference lays
    them out per kind (scene/builder._quadric_row): sphere, cylinder and
    paraboloid radius, zmin, zmax, phimax; disk radius, height, inner
    radius, phimax; cone radius, height, _, phimax; hyperboloid rmax, zmin,
    zmax, phimax, ah, ch (and p1, p2 in 6:12). qkind: (...) int. kinds: the
    kinds that can occur (a static set; the others' branches are skipped).
    Returns (hit, t, p_obj), p_obj the object-space hit (re-projected onto
    a sphere or cylinder, on the plane for a disk)."""
    oo = xf_point(w2o, o)
    od = xf_vector(w2o, d)
    radius = params[..., 0]
    p1 = params[..., 1]  # zmin | zmin | height | height | zmin
    p2 = params[..., 2]  # zmax | zmax | inner radius | _ | zmax
    phimax = params[..., 3]
    is_cyl = qkind == CYLINDER
    is_disk = qkind == DISK
    is_cone = qkind == CONE
    is_para = qkind == PARABOLOID
    is_hyp = qkind == HYPERBOLOID
    o_err, d_err = efl.transform_ray_error(w2o, o, d)
    e_ox, e_oy, e_oz = (efl.ef(oo[..., i], o_err[..., i]) for i in range(3))
    e_dx, e_dy, e_dz = (efl.ef(od[..., i], d_err[..., i]) for i in range(3))
    e_dxy2 = efl.add(efl.sqr(e_dx), efl.sqr(e_dy))
    e_oxyd = efl.add(efl.mul(e_dx, e_ox), efl.mul(e_dy, e_oy))
    e_oxy2 = efl.add(efl.sqr(e_ox), efl.sqr(e_oy))
    e_dzz = efl.sqr(e_dz)
    e_ozz = efl.sqr(e_oz)
    e_ozdz = efl.mul(e_oz, e_dz)
    # the sphere's (and the default) coefficients
    e_a = efl.add(e_dxy2, e_dzz)
    e_b = efl.scale(efl.add(e_oxyd, e_ozdz), 2.0)
    e_c = efl.sub(efl.add(e_oxy2, e_ozz), efl.sqr(efl.ef(radius)))
    if CYLINDER in kinds:
        e_a = _w3(is_cyl, e_dxy2, e_a)
        e_b = _w3(is_cyl, efl.scale(e_oxyd, 2.0), e_b)
        e_c = _w3(is_cyl, efl.sub(e_oxy2, efl.sqr(efl.ef(radius))), e_c)
    if CONE in kinds:
        # k = (r / h)^2, apex at z = h (cone.rs with the k fix)
        kr = radius / torch.clamp(p1.abs(), min=1e-12)
        k_cone = kr * kr
        e_oz_h = efl.sub(e_oz, efl.ef(p1))
        e_a = _w3(is_cone, efl.sub(e_dxy2, efl.scale(e_dzz, k_cone)), e_a)
        e_b = _w3(is_cone, efl.scale(efl.sub(e_oxyd, efl.scale(efl.mul(e_dz, e_oz_h), k_cone)), 2.0), e_b)
        e_c = _w3(is_cone, efl.sub(e_oxy2, efl.scale(efl.sqr(e_oz_h), k_cone)), e_c)
    if PARABOLOID in kinds:
        # z = k (x^2 + y^2), k = zmax / r^2 (paraboloid.rs:75-78)
        k_para = p2 / torch.clamp(radius * radius, min=1e-20)
        e_a = _w3(is_para, efl.scale(e_dxy2, k_para), e_a)
        e_b = _w3(is_para, efl.sub(efl.scale(e_oxyd, 2.0 * k_para), e_dz), e_b)
        e_c = _w3(is_para, efl.sub(efl.scale(e_oxy2, k_para), e_oz), e_c)
    if HYPERBOLOID in kinds:
        ah = params[..., 4]
        ch = params[..., 5]
        e_a = _w3(is_hyp, efl.sub(efl.scale(e_dxy2, ah), efl.scale(e_dzz, ch)), e_a)
        e_b = _w3(is_hyp, efl.scale(efl.sub(efl.scale(e_oxyd, ah), efl.scale(e_ozdz, ch)), 2.0), e_b)
        e_c = _w3(is_hyp, efl.sub(efl.sub(efl.scale(e_oxy2, ah), efl.scale(e_ozz, ch)), efl.ef(torch.ones_like(ah))),
                  e_c)
    has, (tn, tn_lo, tn_hi), (tf, tf_lo, tf_hi) = efl.quadratic(e_a, e_b, e_c)
    if DISK in kinds:
        has = has & ~is_disk
    raw = is_cone | is_para | is_hyp  # cone, paraboloid, hyperboloid keep the raw point

    def clip_ok(t):
        p = oo + od * t[..., None]
        # the sphere re-projects the hit onto its surface, the cylinder onto
        # its radius (sphere.rs, cylinder.rs); |p|^2 summed left to right, as
        # csrc/quadric.cuh does (a library reduction's order is its own)
        s = radius / torch.clamp(torch.sqrt(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]),
                                 min=1e-30)
        zs = p[..., 2] * s
        if CYLINDER in kinds:
            r_c = radius / torch.clamp(torch.sqrt(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]), min=1e-30)
            s = torch.where(is_cyl, r_c, s)
            zs = torch.where(is_cyl, p[..., 2], zs)
        if kinds & {CONE, PARABOLOID, HYPERBOLOID}:
            s = torch.where(raw, 1.0, s)
            zs = torch.where(raw, p[..., 2], zs)
        pn = torch.stack([p[..., 0] * s, p[..., 1] * s, zs], dim=-1)
        z = pn[..., 2]
        phi = torch.atan2(pn[..., 1], pn[..., 0])
        if HYPERBOLOID in kinds and params.shape[-1] >= 12:
            # phi against the twisted frame: the p1 -> p2 segment point at
            # the hit's v, rotated with the surface (pr = lerp(v, p1, p2))
            hp1 = params[..., 6:9]
            hp2 = params[..., 9:12]
            dz_h = hp2[..., 2] - hp1[..., 2]
            v_h = (z - hp1[..., 2]) / torch.where(dz_h.abs() > 1e-12, dz_h, 1.0)
            pr = hp1 + v_h[..., None] * (hp2 - hp1)
            phi_h = torch.atan2(pr[..., 0] * pn[..., 1] - pn[..., 0] * pr[..., 1],
                                pn[..., 0] * pr[..., 0] + pn[..., 1] * pr[..., 1])
            phi = torch.where(is_hyp, phi_h, phi)
        phi = torch.where(phi < 0, phi + TWO_PI, phi)
        full = (p1 <= -radius + 1e-7 * radius) & (p2 >= radius - 1e-7 * radius) & (phimax >= TWO_PI - 1e-6)
        if kinds - {SPHERE}:
            full = full & (qkind == SPHERE)
        zlo, zhi = p1, p2
        if CONE in kinds:
            zlo = torch.where(is_cone, 0.0, p1)
            zhi = torch.where(is_cone, p1, p2)
        return full | ((z >= zlo) & (z <= zhi) & (phi <= phimax)), pn

    okn, pn_near = clip_ok(tn)
    okf, pn_far = clip_ok(tf)
    # a root counts iff its error interval is strictly positive and below
    # t_max (sphere.rs:91-102)
    near_valid = has & (tn_lo > 0) & (tn_hi < t_max) & okn
    far_valid = has & (tf_lo > 0) & (tf_hi < t_max) & okf
    t = torch.where(near_valid, tn, tf)
    p_obj = torch.where(near_valid[..., None], pn_near, pn_far)
    hit = near_valid | far_valid
    if DISK in kinds:
        # the plane z = height, clipped to the annulus; any t in (0, t_max)
        # (disk.rs: self-hits are kept off by the error-bounded origin offset)
        dz = od[..., 2]
        dz_ok = dz.abs() > 1e-12
        td = (p1 - oo[..., 2]) / torch.where(dz_ok, dz, 1.0)
        pd = oo + od * td[..., None]
        d2 = pd[..., 0] * pd[..., 0] + pd[..., 1] * pd[..., 1]
        phi_d = torch.atan2(pd[..., 1], pd[..., 0])
        phi_d = torch.where(phi_d < 0, phi_d + TWO_PI, phi_d)
        disk_hit = dz_ok & (td > 0) & (td < t_max) & (d2 <= radius * radius) & (d2 >= p2 * p2) & (phi_d <= phimax)
        pd = torch.stack([pd[..., 0], pd[..., 1], torch.broadcast_to(p1, pd[..., 2].shape)], dim=-1)
        hit = torch.where(is_disk, disk_hit, hit)
        t = torch.where(is_disk, td, t)
        p_obj = torch.where(is_disk[..., None], pd, p_obj)
    return hit, t, p_obj


def ray_sphere(o, d, w2o, params, t_max):
    """The sphere case of ray_quadric (full or partial spheres only)."""
    return ray_quadric(o, d, w2o, params, torch.zeros(params.shape[:-1], dtype=torch.int64, device=params.device),
                       t_max, kinds=frozenset({SPHERE}))
