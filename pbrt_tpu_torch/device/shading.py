"""Surface interaction reconstruction from hit records.

The port's counterpart of ``pbrt_tpu/device/shading.py surface_interaction``
on its triangle branch (src/shapes/triangle.rs:300-399) and its sphere
branch (sphere.rs: the hit re-projected onto the surface, the analytic
normal, uv and dpdu/dpdv, and the gamma(5) |p_obj| error bound carried to
world space), without motion or instancing, which the port's scenes do not
have; and ``apply_bump``, the reference's bump mapping of the shading frame.
"""
from __future__ import annotations

import math

import torch

from .affine import xf_point, xf_vector, xf_vector_t

FLAG_FLIP_GEOM_N = 1
FLAG_HAS_SHADING_N = 2
GEOM_TRI = 0  # scene.arrays.GEOM_TRI

# gamma(n) = n*eps/(1 - n*eps), eps = 2^-24 (pbrt.rs gamma; efloat.rs)
_EPS32 = float(2.0 ** -24)


def _gamma(n: int) -> float:
    return n * _EPS32 / (1.0 - n * _EPS32)


def dot(a, b):
    return (a * b).sum(-1)


def _norm(v):
    return torch.sqrt(dot(v, v))


def normalize(v):
    return v / torch.clamp(_norm(v)[..., None], min=1e-30)


def cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def coordinate_system(n):
    """Build an orthonormal basis around n (src/core/geometry/geometry.rs)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def _shading_frame(ns, dpdu):
    """(ss, ts) tangent frame: dpdu orthogonalized against ns, arbitrary
    fallback for degenerate parameterizations."""
    ss_fb, ts_fb = coordinate_system(ns)
    ss_p = dpdu - ns * dot(ns, dpdu)[:, None]
    ss_len = _norm(ss_p)
    ok_t = (ss_len > 1e-9)[:, None]
    ss = torch.where(ok_t, ss_p / torch.clamp(ss_len, min=1e-20)[:, None], ss_fb)
    ts = torch.where(ok_t, cross(ns, ss), ts_fb)
    return ss, ts


def _triangle_fields(sa, geom, flags, b1, b2):
    """Hit point, error bound, normals, uv and dpdu/dpdv on triangle rows
    `geom` at barycentrics (b1, b2)."""
    tv = sa.tri_p[geom]  # (R, 3, 3)
    tn = sa.tri_n[geom]
    tuv = sa.tri_uv[geom]
    b0 = 1.0 - b1 - b2
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    ng = normalize(cross(e1, e2))
    flip = ((flags & FLAG_FLIP_GEOM_N) != 0)[:, None]
    ng = torch.where(flip, -ng, ng)
    ns = normalize(b0[:, None] * tn[:, 0] + b1[:, None] * tn[:, 1] + b2[:, None] * tn[:, 2])
    # geometric normal flipped toward shading normal (triangle.rs:355-360)
    has_sn = ((flags & FLAG_HAS_SHADING_N) != 0)[:, None]
    align = (dot(ng, ns) < 0)[:, None]
    ng = torch.where(has_sn & align, -ng, ng)
    ns = torch.where(has_sn, ns, ng)
    uv = b0[:, None] * tuv[:, 0] + b1[:, None] * tuv[:, 1] + b2[:, None] * tuv[:, 2]
    # dpdu/dpdv from the uv parameterization (triangle.rs:300-340)
    duv1 = tuv[:, 1] - tuv[:, 0]
    duv2 = tuv[:, 2] - tuv[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    nondeg = det.abs() > 1e-12
    inv_det = torch.where(nondeg, 1.0 / torch.where(nondeg, det, 1.0), 0.0)
    dpdu = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * inv_det[:, None]
    dpdv = (-duv2[:, 0:1] * e1 + duv1[:, 0:1] * e2) * inv_det[:, None]
    dpdu = torch.where(nondeg[:, None], dpdu, e1)
    dpdv = torch.where(nondeg[:, None], dpdv, e2)
    # hit point by barycentric interpolation (triangle.rs:300), with the
    # gamma(7) * sum |b_i v_i| error bound
    p = b0[:, None] * tv[:, 0] + b1[:, None] * tv[:, 1] + b2[:, None] * tv[:, 2]
    p_err = _gamma(7) * (
        b0.abs()[:, None] * tv[:, 0].abs()
        + b1.abs()[:, None] * tv[:, 1].abs()
        + b2.abs()[:, None] * tv[:, 2].abs()
    )
    return {"p": p, "p_err": p_err, "ng": ng, "ns": ns, "uv": uv, "dpdu": dpdu, "dpdv": dpdv}


def _sphere_fields(sa, geom, flags, p):
    """The same fields on (full or partial) sphere rows `geom` for world
    hit points p = o + t d (sphere.rs)."""
    o2w = sa.sph_o2w[geom]
    w2o = sa.sph_w2o[geom]
    par = sa.sph_param[geom]
    radius = par[:, 0]
    p_obj = xf_point(w2o, p)
    # re-project onto the surface
    r_sph = radius / torch.clamp(torch.sqrt((p_obj * p_obj).sum(-1)), min=1e-30)
    p_obj = torch.stack([p_obj[:, 0] * r_sph, p_obj[:, 1] * r_sph, p_obj[:, 2] * r_sph], dim=-1)
    ng = normalize(xf_vector_t(w2o[:, :, :3], p_obj / radius[:, None]))
    ng = torch.where(((flags & FLAG_FLIP_GEOM_N) != 0)[:, None], -ng, ng)
    x, y, z = p_obj[:, 0], p_obj[:, 1], p_obj[:, 2]
    phi = torch.atan2(y, x)
    phi = torch.where(phi < 0, phi + 2.0 * math.pi, phi)
    theta = torch.arccos(torch.clamp(z / radius, -1.0, 1.0))
    phimax = par[:, 3]
    tmin = par[:, 4]
    tmax = par[:, 5]
    uv = torch.stack([phi / torch.clamp(phimax, min=1e-9), (theta - tmin) / torch.clamp(tmax - tmin, min=1e-9)], dim=-1)
    zr = torch.sqrt(torch.clamp(x * x + y * y, min=1e-20))
    dpdu = torch.stack([-phimax * y, phimax * x, torch.zeros_like(zr)], dim=-1)
    dpdv = torch.stack([z * x / zr, z * y / zr, -radius * torch.sin(theta)], dim=-1) * (tmax - tmin)[:, None]
    # gamma(5) |p_obj| in object space, through the affine o2w with the
    # transform_point_error bound (transform.rs:433)
    p_err = (_gamma(5) + _gamma(3)) * xf_vector(o2w[:, :, :3].abs(), p_obj.abs()) + _gamma(3) * o2w[:, :, 3].abs()
    return {"p": xf_point(o2w, p_obj), "p_err": p_err, "ng": ng, "ns": ng, "uv": uv,
            "dpdu": xf_vector(o2w[:, :, :3], dpdu), "dpdv": xf_vector(o2w[:, :, :3], dpdv)}


def surface_interaction(sa, hit, o, d):
    """Build the shading record for each ray.

    hit: dict from intersect(); o, d: (R, 3) ray. Returns dict with p,
    p_err, ng (geometric normal), ns (shading normal), uv, tangent frame
    (ss, ts), dpdu, dpdv, mat (material row), light (area light row or -1),
    prim, wo and the valid (R,) mask."""
    prim = torch.clamp(hit["prim"], min=0)
    valid = hit["prim"] >= 0
    geom = sa.prim_geom[prim]
    flags = sa.prim_flags[prim]
    if sa.sph_param.shape[0] == 0:
        f = _triangle_fields(sa, geom, flags, hit["b1"], hit["b2"])
    else:
        t = torch.where(valid, hit["t"], 1.0)
        p = o + d * t[:, None]
        is_tri = sa.prim_kind[prim] == GEOM_TRI
        f = _sphere_fields(sa, torch.where(is_tri, 0, geom), flags, p)
        if sa.tri_p.shape[0] > 0:
            ft = _triangle_fields(sa, torch.where(is_tri, geom, 0), flags, hit["b1"], hit["b2"])
            f = {k: torch.where(is_tri[:, None], ft[k], v) for k, v in f.items()}
    ss, ts = _shading_frame(f["ns"], f["dpdu"])
    return dict(f, valid=valid, ss=ss, ts=ts, mat=torch.where(valid, sa.prim_mat[prim], 0),
                light=torch.where(valid, sa.prim_light[prim], -1), prim=hit["prim"], wo=-d)


def apply_bump(sa, static, si, atlases=None):
    """Bump-map the shading frame (material.rs:46-87 bump(); the reference's
    shading.apply_bump :62-117): the material's float bump texture at uv,
    uv + (du, 0) and uv + (0, dv), with du = dv = 0.0005 (the reference's
    fallback for rays without differentials) and the hit point moved along
    dpdu, dpdv, displaces dpdu and dpdv along ns; ns, ss and ts are rebuilt
    from the displaced tangents, ns kept on the side of the original. Lanes
    whose material has no bump map keep their frame. Only the bump
    textures and their children are evaluated (the reference evaluates
    every program; the values are the same, ROADMAP C)."""
    from .texture import eval_textures, needed_programs

    tid = sa.mat_bump[torch.clamp(si["mat"], min=0)]
    has = tid >= 0
    du = dv = 0.0005
    only = needed_programs(static.tex_programs, sa.mat_bump.tolist())

    def disp_at(uv, p):
        vals = eval_textures(sa, static.tex_programs, uv, p, atlases=atlases, only=only)
        out = torch.zeros(uv.shape[0], dtype=torch.float32, device=uv.device)
        for x, val in enumerate(vals):
            if val is not None:
                out = torch.where(tid == x, val[:, 0], out)
        return out

    uv, p, ns = si["uv"], si["p"], si["ns"]
    d0 = disp_at(uv, p)
    d_u = disp_at(uv + torch.tensor([du, 0.0], device=uv.device), p + du * si["dpdu"])
    d_v = disp_at(uv + torch.tensor([0.0, dv], device=uv.device), p + dv * si["dpdv"])
    dpdu_b = si["dpdu"] + ((d_u - d0) / du)[:, None] * ns
    dpdv_b = si["dpdv"] + ((d_v - d0) / dv)[:, None] * ns
    ns_b = cross(dpdu_b, dpdv_b)
    nlen = _norm(ns_b)
    ns_b = ns_b / torch.clamp(nlen, min=1e-20)[:, None]
    # keep the displaced normal on the original shading side
    ns_b = torch.where((dot(ns_b, ns) < 0)[:, None], -ns_b, ns_b)
    ok = (has & (nlen > 1e-12))[:, None]
    ns_n = torch.where(ok, ns_b, ns)
    ss_b, ts_b = _shading_frame(ns_n, torch.where(ok, dpdu_b, si["dpdu"]))
    return dict(si, ns=ns_n, ss=torch.where(ok, ss_b, si["ss"]), ts=torch.where(ok, ts_b, si["ts"]))
