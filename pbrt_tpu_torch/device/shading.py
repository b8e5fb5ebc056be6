"""Surface interaction reconstruction from hit records.

The port's counterpart of ``pbrt_tpu/device/shading.py surface_interaction``
on its triangle branch (src/shapes/triangle.rs:300-399; an instanced
triangle's vertices and normals brought to world space through its
instance transform, reference :190-205) and its quadric branch (sphere.rs,
cylinder.rs, disk.rs, cone.rs, paraboloid.rs, hyperboloid.rs, reference
:250-394: the hit re-projected onto the surface, the analytic normal, uv
and dpdu/dpdv per kind, and the gamma(5) |p_obj| error bound carried to
world space), at the ray's shutter time in a scene with moving prims
(reference :119-184, :254-268: the exact animated transform of the prim's
group, its normals through the inverse's transpose, or the keyframe rows
lerped, so that p and ng agree with the time-aware query's hit); and
``apply_bump``, the reference's bump mapping of the shading frame.
"""
from __future__ import annotations

import math

import torch

from .affine import xf_point, xf_vector, xf_vector_t
from .motion import _affine_inverse, motion_matrices, motion_quad

FLAG_FLIP_GEOM_N = 1
FLAG_HAS_SHADING_N = 2
GEOM_TRI = 0  # scene.arrays.GEOM_TRI
# quadric sub-kinds (scene.arrays.QUADRIC_*)
_CYLINDER, _DISK, _CONE, _PARABOLOID, _HYPERBOLOID = 1, 2, 3, 4, 5

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


def _triangle_fields(sa, geom, flags, b1, b2, prim=None, motion=None):
    """Hit point, error bound, normals, uv and dpdu/dpdv on triangle rows
    `geom` at barycentrics (b1, b2); with `prim`, in an instanced scene,
    each prim's vertices go through its instance's i2w and its normals
    through the transpose of its w2i (the rows are instance-space).
    motion: (the prims, their rays' times) of a scene with moving prims."""
    tv = sa.tri_p[geom]  # (R, 3, 3)
    tn = sa.tri_n[geom]
    tuv = sa.tri_uv[geom]
    if motion is not None:
        mprim, time = motion
        if sa.anim:
            g = motion_matrices(sa, mprim, time)  # (R, 3, 4)
            tv = xf_point(g[:, None], tv)
            # normals move by the inverse transpose of g's linear part
            tn = xf_vector_t(_affine_inverse(g)[:, None, :, :3], tn)
        else:
            tv = motion_quad(tv, sa.tri_p_end[geom], None if sa.tri_p_mid is None else sa.tri_p_mid[geom],
                             time[:, None, None])
    if prim is not None:
        iid = sa.prim_inst[prim].to(torch.int64)
        i2w = sa.inst_i2w[iid][:, None]
        w2i = sa.inst_w2i[iid][:, None]
        tv = xf_point(i2w, tv)
        tn = xf_vector_t(w2i[..., :3], tn)
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


def _normalize_eps(v, eps):
    return v / torch.clamp(_norm(v)[..., None], min=eps)


def _quadric_fields(sa, geom, flags, p, kinds, motion=None):
    """The same fields on quadric rows `geom` for world hit points
    p = o + t d, per kind (kinds: the kinds present, a static set): the
    hit re-projected (a sphere onto its surface, a cylinder onto its
    radius, a disk onto its plane; the others keep the raw point), the
    object-space normal (each surface's implicit gradient), uv and
    dpdu/dpdv of each shape's parameterization (the reference's; its
    hyperboloid dpdv is pbrt-v3's rotation derivative). motion: as
    _triangle_fields's."""
    o2w = sa.sph_o2w[geom]
    w2o = sa.sph_w2o[geom]
    if motion is not None:
        mprim, time = motion
        if sa.anim:
            w2o = motion_matrices(sa, mprim, time, quadric=True)
            o2w = _affine_inverse(w2o)
        else:
            tb = time[:, None, None]
            mid = sa.sph_w2o_mid is not None
            w2o = motion_quad(w2o, sa.sph_w2o_end[geom], sa.sph_w2o_mid[geom] if mid else None, tb)
            o2w = motion_quad(o2w, sa.sph_o2w_end[geom], sa.sph_o2w_mid[geom] if mid else None, tb)
    par = sa.sph_param[geom]
    qk = sa.sph_kind[geom]
    radius = par[:, 0]
    p_obj = xf_point(w2o, p)
    x0, y0, z0 = p_obj[:, 0], p_obj[:, 1], p_obj[:, 2]
    r_sph = radius / torch.clamp(torch.sqrt((p_obj * p_obj).sum(-1)), min=1e-30)
    scale = r_sph
    z_new = z0 * r_sph
    is_ = {k: qk == k for k in kinds}
    if _CYLINDER in kinds:
        r_cyl = radius / torch.clamp(torch.sqrt(x0 * x0 + y0 * y0), min=1e-30)
        scale = torch.where(is_[_CYLINDER], r_cyl, scale)
        z_new = torch.where(is_[_CYLINDER], z0, z_new)
    for k in kinds & {_DISK, _CONE, _PARABOLOID, _HYPERBOLOID}:
        scale = torch.where(is_[k], 1.0, scale)
        z_new = torch.where(is_[k], par[:, 1] if k == _DISK else z0, z_new)
    p_obj = torch.stack([x0 * scale, y0 * scale, z_new], dim=-1)
    x, y, z = p_obj[:, 0], p_obj[:, 1], p_obj[:, 2]
    zero = torch.zeros_like(radius)
    one = torch.ones_like(radius)
    phimax = par[:, 3]
    tmin = par[:, 4]
    tmax = par[:, 5]
    n_obj = p_obj / radius[:, None]
    phi = torch.atan2(y, x)
    phi = torch.where(phi < 0, phi + 2.0 * math.pi, phi)
    theta = torch.arccos(torch.clamp(z / radius, -1.0, 1.0))
    u = phi / torch.clamp(phimax, min=1e-9)
    v = (theta - tmin) / torch.clamp(tmax - tmin, min=1e-9)
    zr = torch.sqrt(torch.clamp(x * x + y * y, min=1e-20))
    dpdu = torch.stack([-phimax * y, phimax * x, torch.zeros_like(zr)], dim=-1)
    dpdv = torch.stack([z * x / zr, z * y / zr, -radius * torch.sin(theta)], dim=-1) * (tmax - tmin)[:, None]

    def put(k, n_k, u_k, v_k, dpdv_k):
        nonlocal n_obj, u, v, dpdv
        m = is_[k]
        n_obj = torch.where(m[:, None], n_k, n_obj)
        if u_k is not None:
            u = torch.where(m, u_k, u)
        v = torch.where(m, v_k, v)
        dpdv = torch.where(m[:, None], dpdv_k, dpdv)

    if _CYLINDER in kinds:
        put(_CYLINDER, torch.stack([x / radius, y / radius, zero], dim=-1), None,
            (z - par[:, 1]) / torch.clamp(par[:, 2] - par[:, 1], min=1e-9),
            torch.stack([zero, zero, par[:, 2] - par[:, 1]], dim=-1))
    if _DISK in kinds:
        r_hit = torch.sqrt(torch.clamp(x * x + y * y, min=1e-20))
        put(_DISK, torch.stack([zero, zero, one], dim=-1), None,
            1.0 - (r_hit - par[:, 2]) / torch.clamp(radius - par[:, 2], min=1e-9),
            torch.stack([x, y, zero], dim=-1) * ((par[:, 2] - radius) / r_hit)[:, None])
    if _CONE in kinds:
        # grad(x^2 + y^2 - k (z - h)^2), k = (r / h)^2: (x, y, k (h - z))
        kr = radius / torch.clamp(par[:, 1].abs(), min=1e-12)
        v_cone = z / torch.clamp(par[:, 1].abs(), min=1e-9)
        omv = torch.clamp(1.0 - v_cone, min=1e-6)  # cone.rs:115
        put(_CONE, _normalize_eps(torch.stack([x, y, kr * kr * (par[:, 1] - z)], dim=-1), 1e-20), None, v_cone,
            torch.stack([-x / omv, -y / omv, par[:, 1].abs() + zero], dim=-1))
    if _PARABOLOID in kinds:
        k_para = par[:, 2] / torch.clamp(radius * radius, min=1e-20)
        z2 = torch.clamp(2.0 * z.abs(), min=1e-9) * torch.sign(z + 1e-30)  # paraboloid.rs:116
        put(_PARABOLOID, _normalize_eps(torch.stack([2.0 * k_para * x, 2.0 * k_para * y, -one], dim=-1), 1e-20),
            None, (z - par[:, 1]) / torch.clamp(par[:, 2] - par[:, 1], min=1e-9),
            torch.stack([x / z2, y / z2, one], dim=-1) * (par[:, 2] - par[:, 1])[:, None])
    if _HYPERBOLOID in kinds:
        # hyperboloid.rs:134-151: v along the p1 -> p2 segment, phi against
        # the twisted frame (the lerped segment point pr)
        ah, ch = par[:, 4], par[:, 5]
        hp1, hp2 = par[:, 6:9], par[:, 9:12]
        v_hyp = (z - hp1[:, 2]) / torch.where((hp2[:, 2] - hp1[:, 2]).abs() > 1e-12, hp2[:, 2] - hp1[:, 2], 1.0)
        pr = hp1 + v_hyp[:, None] * (hp2 - hp1)
        phi_h = torch.atan2(pr[:, 0] * y - x * pr[:, 1], x * pr[:, 0] + y * pr[:, 1])
        phi_h = torch.where(phi_h < 0, phi_h + 2.0 * math.pi, phi_h)
        cph, sph = torch.cos(phi_h), torch.sin(phi_h)
        ex = hp2[:, 0] - hp1[:, 0]
        ey = hp2[:, 1] - hp1[:, 1]
        put(_HYPERBOLOID, _normalize_eps(torch.stack([ah * x, ah * y, -ch * z], dim=-1), 1e-20),
            phi_h / torch.clamp(phimax, min=1e-9), v_hyp,
            torch.stack([ex * cph - ey * sph, ex * sph + ey * cph, hp2[:, 2] - hp1[:, 2]], dim=-1))
    ng = normalize(xf_vector_t(w2o[:, :, :3], n_obj))
    ng = torch.where(((flags & FLAG_FLIP_GEOM_N) != 0)[:, None], -ng, ng)
    # gamma(5) |p_obj| in object space, through the affine o2w with the
    # transform_point_error bound (transform.rs:433)
    p_err = (_gamma(5) + _gamma(3)) * xf_vector(o2w[:, :, :3].abs(), p_obj.abs()) + _gamma(3) * o2w[:, :, 3].abs()
    return {"p": xf_point(o2w, p_obj), "p_err": p_err, "ng": ng, "ns": ng, "uv": torch.stack([u, v], dim=-1),
            "dpdu": xf_vector(o2w[:, :, :3], dpdu), "dpdv": xf_vector(o2w[:, :, :3], dpdv)}


def surface_interaction(sa, hit, o, d, quadric_kinds=None, time=None):
    """Build the shading record for each ray.

    hit: dict from intersect(); o, d: (R, 3) ray; quadric_kinds: the
    scene's (static.quadric_kinds; read from sa.sph_kind when None); time:
    the rays' shutter fractions (R,), which move the hit prims in a scene
    with moving prims (its tables have tri_p_end). Returns dict with p,
    p_err, ng (geometric normal), ns (shading normal), uv, tangent frame
    (ss, ts), dpdu, dpdv, mat (material row), light (area light row or -1),
    prim, wo and the valid (R,) mask."""
    prim = torch.clamp(hit["prim"], min=0)
    valid = hit["prim"] >= 0
    geom = sa.prim_geom[prim]
    flags = sa.prim_flags[prim]
    instanced = prim if sa.inst_i2w.shape[0] > 1 else None
    motion = (prim, time) if time is not None and sa.tri_p_end is not None else None
    if sa.sph_param.shape[0] == 0:
        f = _triangle_fields(sa, geom, flags, hit["b1"], hit["b2"], instanced, motion)
    else:
        t = torch.where(valid, hit["t"], 1.0)
        p = o + d * t[:, None]
        is_tri = sa.prim_kind[prim] == GEOM_TRI
        if quadric_kinds is None:
            quadric_kinds = torch.unique(sa.sph_kind).tolist()
        kinds = frozenset(int(k) for k in quadric_kinds)
        f = _quadric_fields(sa, torch.where(is_tri, 0, geom), flags, p, kinds, motion)
        if sa.tri_p.shape[0] > 0:
            ft = _triangle_fields(sa, torch.where(is_tri, geom, 0), flags, hit["b1"], hit["b2"], instanced, motion)
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
