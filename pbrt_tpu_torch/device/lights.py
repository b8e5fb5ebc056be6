"""Light sampling and light power.

The port's counterpart of ``pbrt_tpu/device/lights.py`` for the light kinds
the port compiles: point, spot, distant, goniometric and projection lights
(src/lights/point.rs, spot.rs, distant.rs, goniometric.rs, projection.rs:
the last two scale the point light's intensity by their image,
``_image_light_scale``), the infinite light, constant or image-mapped
(src/lights/infinite.rs), and diffuse area lights on triangles and on
quadrics of the six kinds (src/lights/diffuse.rs; ``_sample_prim_point``
as the reference samples each kind), one light row per emitting triangle or
quadric. sample_li evaluates only the branches of the kinds the
scene has; area_light_emission, pdf_li_area_hit, env_le, env_pdf_li and
compute_power complete the set. A sphere lamp is sampled uniformly over its
area, or, with ``cone_spheres`` (the integrators pass
``static.has_cone_sphere_lights``), over the cone it subtends from outside
when it is a full, outward-facing sphere (sphere.rs sample_interaction;
``_sphere_cone_info``). ``sample_le`` and ``area_light_pdf_dir`` are the
lights as BDPT's light-subpath endpoints (Light::sample_le, pdf_le).
"""
from __future__ import annotations

import functools
import math
import operator

import torch

from ..scene.arrays import (
    GEOM_SPHERE, GEOM_TRI, LIGHT_AREA, LIGHT_DISTANT, LIGHT_GONIO, LIGHT_INFINITE, LIGHT_POINT, LIGHT_PROJECTION,
    LIGHT_SPOT, QUADRIC_CONE, QUADRIC_CYLINDER, QUADRIC_DISK, QUADRIC_HYPERBOLOID, QUADRIC_PARABOLOID, QUADRIC_SPHERE,
)
from .affine import xf_point, xf_vector, xf_vector_t
from .camera import concentric_sample_disk
from .mipmap import image_bilinear
from .shading import FLAG_FLIP_GEOM_N, coordinate_system, cross, dot, normalize

FLAG_REVERSE_ORIENTATION = 4  # scene.builder.FLAG_REVERSE_ORIENTATION
POINT_FAMILY = (LIGHT_POINT, LIGHT_SPOT, LIGHT_GONIO, LIGHT_PROJECTION)
TWO_PI = 2.0 * math.pi
INV_4PI = 1.0 / (4.0 * math.pi)


def uniform_sample_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


# ---------------------------------------------------------------------------
# The environment map (src/lights/infinite.rs + sampling.rs Distribution2D)
# ---------------------------------------------------------------------------


def _env_dir_to_uv(sa, d):
    """World direction -> env map (u, v) in [0, 1)^2, and theta."""
    dl = normalize(xf_vector(sa.env_w2l[:3, :3], d))
    theta = torch.acos(torch.clamp(dl[..., 2], -1.0, 1.0))
    phi = torch.atan2(dl[..., 1], dl[..., 0])
    phi = torch.where(phi < 0, phi + TWO_PI, phi)
    return phi / TWO_PI, theta / math.pi, theta


def _env_texel(img, u, v):
    h, w, _ = img.shape
    x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return img[y, x]


def env_le(sa, static, d):
    """Escaped-ray radiance from the infinite light (infinite.rs le :120)."""
    if not static.has_infinite:
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32, device=d.device)
    li = sa.light_param[static.infinite_light_index]
    if not static.has_env_map:
        return torch.broadcast_to(li[3:6], d.shape[:-1] + (3,))
    u, v, _ = _env_dir_to_uv(sa, d)
    return _env_texel(sa.env_image, u, v)


def _searchsorted_rows(cdf_rows, u):
    """Per-row searchsorted: cdf_rows (R, N), u (R,) -> (R,) index."""
    return (cdf_rows <= u[:, None]).sum(-1)


def _env_pdf(pdf_u, pdf_v, sin_t):
    return torch.where(sin_t > 1e-7, pdf_u * pdf_v / (2.0 * math.pi * math.pi * torch.clamp(sin_t, min=1e-7)), 0.0)


def _env_sample(sa, u1, u2):
    """A direction from the env map's importance distribution: (d_world,
    li, pdf in solid angle)."""
    marg = sa.env_marg_cdf  # (H + 1,)
    cond = sa.env_cond_cdf  # (H, W + 1)
    h = cond.shape[0]
    w = cond.shape[1] - 1
    # the row from the marginal
    row = torch.clamp(torch.searchsorted(marg, u1.contiguous(), right=True) - 1, 0, h - 1)
    m0 = marg[row]
    m1 = marg[row + 1]
    dv = torch.where(m1 > m0, (u1 - m0) / torch.clamp(m1 - m0, min=1e-30), 0.5)
    v = (row.to(torch.float32) + dv) / h
    pdf_v = (m1 - m0) * h
    # the column from the row's conditional
    crow = cond[row]  # (R, W + 1)
    col = torch.clamp(_searchsorted_rows(crow, u2) - 1, 0, w - 1)
    c0 = crow.gather(1, col[:, None])[:, 0]
    c1 = crow.gather(1, col[:, None] + 1)[:, 0]
    du = torch.where(c1 > c0, (u2 - c0) / torch.clamp(c1 - c0, min=1e-30), 0.5)
    u = (col.to(torch.float32) + du) / w
    pdf_u = (c1 - c0) * w
    theta = v * math.pi
    phi = u * TWO_PI
    sin_t = torch.sin(theta)
    dl = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), torch.cos(theta)], dim=-1)
    # light -> world is the transpose of the rotation part of w2l
    dw = xf_vector_t(sa.env_w2l[:3, :3], dl)
    return dw, _env_texel(sa.env_image, u, v), _env_pdf(pdf_u, pdf_v, sin_t)


def env_pdf_li(sa, static, d):
    """The solid-angle pdf with which the infinite light samples direction d."""
    if not static.has_env_map:
        return torch.full(d.shape[:-1], INV_4PI, dtype=torch.float32, device=d.device)
    u, v, theta = _env_dir_to_uv(sa, d)
    marg = sa.env_marg_cdf
    cond = sa.env_cond_cdf
    h = cond.shape[0]
    w = cond.shape[1] - 1
    row = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    col = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    pdf_v = (marg[row + 1] - marg[row]) * h
    pdf_u = (cond[row, col + 1] - cond[row, col]) * w
    return _env_pdf(pdf_u, pdf_v, torch.sin(theta))


def uniform_sample_triangle(u1, u2):
    su0 = torch.sqrt(torch.clamp(u1, min=0.0))
    return 1.0 - su0, u2 * su0


def _quadric_point(par, qk, u1, u2, kinds):
    """A point on each quadric in object space and its object-space
    normal, as the reference samples each kind (lights._sample_prim_point
    :226-299): a sphere by a uniform direction (partial ones as full), a
    cylinder by (z, phi) uniform, a disk by the concentric map over the
    full disk, a cone uniformly in area, a paraboloid with density ~ r(z)
    (the slant factor neglected), a hyperboloid uniformly in (v, phi)."""
    radius = par[:, 0]
    phimax = par[:, 3]
    d = uniform_sample_sphere(u1, u2)
    p_obj = d * radius[:, None]
    n_obj = d
    if not kinds - {QUADRIC_SPHERE}:
        return p_obj, n_obj
    phi = u2 * phimax
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cases = []
    if QUADRIC_CYLINDER in kinds:
        z_c = par[:, 1] + u1 * (par[:, 2] - par[:, 1])
        cases.append((QUADRIC_CYLINDER, torch.stack([radius * cphi, radius * sphi, z_c], dim=-1),
                      torch.stack([cphi, sphi, torch.zeros_like(cphi)], dim=-1)))
    if QUADRIC_DISK in kinds:
        dx, dy = concentric_sample_disk(u1, u2)
        cases.append((QUADRIC_DISK, torch.stack([dx * radius, dy * radius, par[:, 1]], dim=-1),
                      torch.stack([torch.zeros_like(dx), torch.zeros_like(dx), torch.ones_like(dx)], dim=-1)))
    if QUADRIC_CONE in kinds:
        h = par[:, 1].abs()
        v = 1.0 - torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
        r = radius * (1.0 - v)
        p_cn = torch.stack([r * cphi, r * sphi, v * h], dim=-1)
        kr = radius / torch.clamp(h, min=1e-9)
        cases.append((QUADRIC_CONE, p_cn, normalize(torch.stack([p_cn[:, 0], p_cn[:, 1],
                                                                      kr * kr * (h - p_cn[:, 2])], dim=-1))))
    if QUADRIC_PARABOLOID in kinds:
        zlo = torch.clamp(par[:, 1], min=0.0)
        zhi = torch.clamp(par[:, 2], min=1e-9)
        z15 = zlo ** 1.5 + u1 * (zhi ** 1.5 - zlo ** 1.5)
        z_p = torch.clamp(z15, min=0.0) ** (2.0 / 3.0)
        r_p = radius * torch.sqrt(z_p / zhi)
        p_pa = torch.stack([r_p * cphi, r_p * sphi, z_p], dim=-1)
        k = zhi / torch.clamp(radius * radius, min=1e-20)
        cases.append((QUADRIC_PARABOLOID, p_pa, normalize(torch.stack([2.0 * k * p_pa[:, 0], 2.0 * k * p_pa[:, 1],
                                                                            -torch.ones_like(z_p)], dim=-1))))
    if QUADRIC_HYPERBOLOID in kinds:
        hp1, hp2 = par[:, 6:9], par[:, 9:12]
        seg = hp1 + u1[:, None] * (hp2 - hp1)
        p_hy = torch.stack([seg[:, 0] * cphi - seg[:, 1] * sphi, seg[:, 0] * sphi + seg[:, 1] * cphi, seg[:, 2]],
                           dim=-1)
        ah, ch = par[:, 4], par[:, 5]
        cases.append((QUADRIC_HYPERBOLOID, p_hy, normalize(torch.stack([ah * p_hy[:, 0], ah * p_hy[:, 1],
                                                                             -ch * p_hy[:, 2]], dim=-1))))
    for k, p_k, n_k in cases:
        m = (qk == k)[:, None]
        p_obj = torch.where(m, p_k, p_obj)
        n_obj = torch.where(m, n_k, n_obj)
    return p_obj, n_obj


def _sample_prim_point(sa, prim_ids, u1, u2, kinds=frozenset({QUADRIC_SPHERE})):
    """Sample a point on the prims' surfaces: triangles by uniform
    barycentrics (sampling.rs:147), quadrics by _quadric_point (kinds: the
    quadric kinds the scene has). Returns (p, n, area)."""
    prim = torch.clamp(prim_ids, min=0)
    geom = sa.prim_geom[prim]
    flags = sa.prim_flags[prim]
    area = sa.prim_area[prim]
    flip = ((flags & FLAG_FLIP_GEOM_N) != 0)[:, None]
    n_tri, n_sph = sa.tri_p.shape[0], sa.sph_param.shape[0]
    if n_tri:
        is_tri = sa.prim_kind[prim] == GEOM_TRI if n_sph else None
        tv = sa.tri_p[torch.where(is_tri, geom, 0) if n_sph else geom]
        b0, b1 = uniform_sample_triangle(u1, u2)
        p = b0[:, None] * tv[:, 0] + b1[:, None] * tv[:, 1] + (1.0 - b0 - b1)[:, None] * tv[:, 2]
        n = normalize(cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))
        n = torch.where(flip, -n, n)
        if not n_sph:
            return p, n, area
    si = torch.where(sa.prim_kind[prim] == GEOM_SPHERE, geom, 0)
    p_obj, n_obj = _quadric_point(sa.sph_param[si], sa.sph_kind[si], u1, u2, kinds)
    ps = xf_point(sa.sph_o2w[si], p_obj)
    ns = normalize(xf_vector_t(sa.sph_w2o[si][:, :, :3], n_obj))
    ns = torch.where(flip, -ns, ns)
    if not n_tri:
        return ps, ns, area
    return torch.where(is_tri[:, None], p, ps), torch.where(is_tri[:, None], n, ns), area


def _image_light_scale(sa, static, lid, w_from_light, par, fall):
    """The goniometric and projection lights' direction-dependent scale of
    their intensity (goniometric.rs: the map over (phi, theta) of the
    direction in the light's frame; projection.rs: the image over the
    perspective screen, zero outside it), for the lanes whose light has an
    image (reference lights._image_light_scale :161-195)."""
    for i, key in enumerate(static.light_image_keys):
        if key is None:
            continue
        img = sa.light_images[key]
        wl = normalize(xf_vector(sa.light_w2l[i, :, :3], w_from_light))
        is_this = (lid == i)[:, None]
        if static.light_kinds[i] == LIGHT_GONIO:
            theta = torch.arccos(torch.clamp(wl[:, 2], -1.0, 1.0))
            phi = torch.atan2(wl[:, 1], wl[:, 0])
            phi = torch.where(phi < 0, phi + TWO_PI, phi)
            fall = torch.where(is_this, image_bilinear(img, phi / TWO_PI, 1.0 - theta / math.pi), fall)
        else:
            tan_half = par[:, 9]
            aspect = par[:, 10]
            behind = wl[:, 2] < 1e-3
            zc = torch.clamp(wl[:, 2], min=1e-6)
            sx = wl[:, 0] / zc / torch.clamp(tan_half * torch.clamp(aspect, min=1.0), min=1e-6)
            sy = wl[:, 1] / zc / torch.clamp(tan_half / torch.clamp(torch.clamp(aspect, min=1e-6), max=1.0), min=1e-6)
            inside = ~behind & (sx.abs() <= 1.0) & (sy.abs() <= 1.0)
            val = image_bilinear(img, 0.5 * (sx + 1.0), 0.5 * (sy + 1.0))
            fall = torch.where(is_this, torch.where(inside[:, None], val, 0.0), fall)
    return fall


def _sphere_cone_info(sa, prim_ids):
    """(is_cone_sphere, world center, world radius) of light prims: a full,
    outward-facing sphere is sampled by its visible cone (sphere.rs
    sample_interaction); its world radius takes column 0 of o2w as the
    scale (reference lights._sphere_cone_info :461)."""
    prim = torch.clamp(prim_ids, min=0)
    kind = sa.prim_kind[prim]
    gi = torch.where(kind == GEOM_SPHERE, sa.prim_geom[prim], 0)
    par = sa.sph_param[gi]
    o2w = sa.sph_o2w[gi]
    r_o = par[:, 0]
    full = (par[:, 1] <= -r_o + 1e-6 * r_o) & (par[:, 2] >= r_o - 1e-6 * r_o) & (par[:, 3] >= 2.0 * math.pi - 1e-6)
    # reverse-oriented spheres emit inward; they keep uniform-area sampling
    not_rev = (sa.prim_flags[prim] & FLAG_REVERSE_ORIENTATION) == 0
    is_sph = (kind == GEOM_SPHERE) & (sa.sph_kind[gi] == QUADRIC_SPHERE) & full & not_rev
    return is_sph, o2w[:, :, 3], r_o * torch.linalg.vector_norm(o2w[:, :, 0], dim=-1)


def _cone_cos_max(c_w, r_w, p_ref):
    """(dc2, cos theta_max) of the cone a sphere of center c_w and radius
    r_w subtends from p_ref, and the pdf of a direction drawn in it."""
    to_c = c_w - p_ref
    dc2 = torch.clamp(dot(to_c, to_c), min=1e-12)
    sin2_t_max = torch.clamp(r_w * r_w / dc2, 0.0, 1.0)
    cos_t_max = torch.sqrt(torch.clamp(1.0 - sin2_t_max, min=0.0))
    pdf = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_t_max), min=1e-12)
    return to_c, dc2, cos_t_max, pdf


def area_light_emission(sa, light_ids, n_light, w):
    """L emitted from an area light toward direction w (diffuse.rs l())."""
    par = sa.light_param[torch.clamp(light_ids, min=0)]
    two_sided = par[:, 3] > 0
    emits = two_sided | (dot(n_light, w) > 0)
    return torch.where((emits & (light_ids >= 0))[:, None], par[:, 0:3], 0.0)


def sample_li(sa, static, light_ids, p_ref, u1, u2, cone_spheres=False):
    """Sample an incident direction from light `light_ids` toward p_ref.

    Returns dict {wi, li, pdf, dist, delta, n, area}: pdf in solid angle
    (1 for the delta lights), dist the distance to the light sample (the
    shadow ray's t_max; twice the world radius for a distant light), n and
    area the area light's sample normal and area (zero and one elsewhere).
    cone_spheres: a full, outward-facing sphere lamp seen from outside is
    sampled over its visible cone, with the cone's pdf (pdf_li_area_hit
    takes the same flag); the spatial distribution's build samples
    without it, as the reference's does."""
    kinds = set(static.light_kinds)
    lid = torch.clamp(light_ids, min=0)
    par = sa.light_param[lid]
    # one branch per light family the scene has; every lane's light is of
    # one of them, so the first branch needs no mask
    branches = []
    if kinds & set(POINT_FAMILY):
        to_l = par[:, 0:3] - p_ref
        d2 = torch.clamp(dot(to_l, to_l), min=1e-12)
        dl = torch.sqrt(d2)
        wi = to_l / dl[:, None]
        power = par[:, 3:6]
        if LIGHT_SPOT in kinds:
            # spot falloff ((cos - cosTotalWidth) / (cosFalloffStart -
            # cosTotalWidth))^4 (spot.rs falloff)
            cos_t = dot(par[:, 6:9], -wi)
            ctw = par[:, 9]
            cfs = par[:, 10]
            dfall = torch.clamp((cos_t - ctw) / torch.clamp(cfs - ctw, min=1e-9), 0.0, 1.0)
            dfall2 = dfall * dfall
            fall = torch.where(cos_t < ctw, 0.0, torch.where(cos_t > cfs, 1.0, dfall2 * dfall2))
            fall = torch.where(sa.light_kind[lid] == LIGHT_SPOT, fall, 1.0)
            power = power * fall[:, None]
        if any(k is not None for k in static.light_image_keys):
            fall3 = (torch.ones_like(power) if LIGHT_SPOT not in kinds
                     else torch.broadcast_to(fall[:, None], power.shape))
            power = par[:, 3:6] * _image_light_scale(sa, static, lid, -wi, par, fall3)
        one = torch.ones_like(dl)
        branches.append((POINT_FAMILY, {
            "wi": wi, "li": power / d2[:, None], "pdf": one, "dist": dl,
            "delta": torch.ones_like(dl, dtype=torch.bool), "n": torch.zeros_like(wi), "area": one}))
    if LIGHT_DISTANT in kinds:
        one = torch.ones(lid.shape, dtype=torch.float32, device=lid.device)
        branches.append(((LIGHT_DISTANT,), {
            "wi": par[:, 0:3], "li": par[:, 3:6], "pdf": one,
            "dist": torch.broadcast_to(2.0 * sa.world_radius, one.shape),
            "delta": torch.ones_like(one, dtype=torch.bool), "n": torch.zeros_like(par[:, 0:3]), "area": one}))
    if LIGHT_INFINITE in kinds:
        # the environment, image-mapped or constant (uniform sphere, pdf 1/4pi)
        if static.has_env_map:
            wi, li, pdf = _env_sample(sa, u1, u2)
        else:
            wi = uniform_sample_sphere(u1, u2)
            li = par[:, 3:6]
            pdf = torch.full(lid.shape, INV_4PI, dtype=torch.float32, device=lid.device)
        branches.append(((LIGHT_INFINITE,), {
            "wi": wi, "li": li, "pdf": pdf, "dist": torch.broadcast_to(2.0 * sa.world_radius, pdf.shape),
            "delta": torch.zeros_like(pdf, dtype=torch.bool), "n": torch.zeros_like(wi),
            "area": torch.ones_like(pdf)}))
    if LIGHT_AREA in kinds:
        ps, ns, area = _sample_prim_point(sa, sa.light_prim[lid], u1, u2, frozenset(static.quadric_kinds))
        to_s = ps - p_ref
        d2 = torch.clamp(dot(to_s, to_s), min=1e-12)
        dist = torch.sqrt(d2)
        wi = to_s / dist[:, None]
        cos_l = dot(ns, -wi)
        emits = (par[:, 3] > 0) | (cos_l > 0)
        # area pdf -> solid angle (shape.rs pdf_interaction)
        pdf = d2 / torch.clamp(cos_l.abs() * area, min=1e-12)
        area_br = {"wi": wi, "li": torch.where(emits[:, None], par[:, 0:3], 0.0),
                   "pdf": torch.where(cos_l.abs() > 1e-7, pdf, 0.0), "dist": dist,
                   "delta": torch.zeros_like(pdf, dtype=torch.bool), "n": ns, "area": area}
        if cone_spheres and sa.sph_param.shape[0] > 0:
            area_br = _sample_cone(sa, sa.light_prim[lid], par, p_ref, u1, u2, area_br)
        branches.append(((LIGHT_AREA,), area_br))
    out = branches[0][1]
    if len(branches) > 1:
        kind = sa.light_kind[lid]
        for fam, br in branches[1:]:
            m = functools.reduce(operator.or_, (kind == k for k in fam))
            out = {k: torch.where(m[:, None] if v.dim() == 2 else m, v, out[k]) for k, v in br.items()}
    return out


def _sample_cone(sa, lprim, par, p_ref, u1, u2, area_br):
    """sample_li's area branch with the lanes whose lamp is a cone sphere
    seen from outside sampled over the visible cone (reference
    lights.sample_li :419-460): the point on the sphere whose outward
    normal makes the sampled angle with the direction back to p_ref."""
    is_sph, c_w, r_w = _sphere_cone_info(sa, lprim)
    to_c, dc2, cos_t_max, pdf_c = _cone_cos_max(c_w, r_w, p_ref)
    dc = torch.sqrt(dc2)
    use_cone = is_sph & (dc2 > r_w * r_w * 1.0001)
    wc = to_c / dc[:, None]
    vx, vy = coordinate_system(wc)
    cos_t = (1.0 - u1) + u1 * cos_t_max
    sin2_t = torch.clamp(1.0 - cos_t * cos_t, min=0.0)
    ds = dc * cos_t - torch.sqrt(torch.clamp(r_w * r_w - dc2 * sin2_t, min=0.0))
    cos_a = torch.clamp((dc2 + r_w * r_w - ds * ds) / torch.clamp(2.0 * dc * r_w, min=1e-12), -1.0, 1.0)
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    phi_c = 2.0 * math.pi * u2
    # SphericalDirection with -wc as +z: the normal at the sampled point
    n_w = ((sin_a * torch.cos(phi_c))[:, None] * (-vx) + (sin_a * torch.sin(phi_c))[:, None] * (-vy)
           + cos_a[:, None] * (-wc))
    p_s = c_w + r_w[:, None] * n_w
    to_sc = p_s - p_ref
    dac = torch.sqrt(torch.clamp(dot(to_sc, to_sc), min=1e-12))
    wi_c = to_sc / dac[:, None]
    # the sampled point faces p_ref: it emits, one-sided or not
    m = use_cone[:, None]
    return dict(area_br, wi=torch.where(m, wi_c, area_br["wi"]), li=torch.where(m, par[:, 0:3], area_br["li"]),
                pdf=torch.where(use_cone, pdf_c, area_br["pdf"]), dist=torch.where(use_cone, dac, area_br["dist"]),
                n=torch.where(m, n_w, area_br["n"]))


def pdf_li_area_hit(sa, p_ref, hit_p, hit_ng, hit_light, prim_area_of_hit, cone_spheres=False):
    """pdf_li for a BSDF-sampled ray that hit area light `hit_light` at
    hit_p with normal hit_ng: the MIS weight's light-side density. With
    cone_spheres, a cone sphere seen from outside gives the cone's pdf, as
    sample_li draws it (sphere.rs pdf_interaction)."""
    to_s = hit_p - p_ref
    d2 = torch.clamp(dot(to_s, to_s), min=1e-12)
    wi = to_s / torch.sqrt(d2)[:, None]
    cos_l = dot(hit_ng, -wi).abs()
    pdf = d2 / torch.clamp(cos_l * prim_area_of_hit, min=1e-12)
    pdf = torch.where(cos_l > 1e-7, pdf, 0.0)
    if cone_spheres and sa.sph_param.shape[0] > 0:
        is_sph, c_w, r_w = _sphere_cone_info(sa, sa.light_prim[torch.clamp(hit_light, min=0)])
        _to_c, dc2, _cos, pdf_cone = _cone_cos_max(c_w, r_w, p_ref)
        pdf = torch.where(is_sph & (dc2 > r_w * r_w * 1.0001), pdf_cone, pdf)
    return pdf


def compute_power(sa, static):
    """Emitted power per light (Light::power) for power-proportional light
    selection (integrator.rs:239-246): point 4 pi sum(I), spot
    2 pi (1 - (cosTotalWidth + cosFalloffStart) / 2) sum(I), distant
    and infinite pi r_world^2 sum(L), area two-sidedness x area x pi x sum(L)."""
    if static.n_lights == 0:
        return torch.ones(1, dtype=torch.float32, device=sa.light_param.device)
    kind = sa.light_kind
    par = sa.light_param
    wr = sa.world_radius
    lum = par[:, 3:6].sum(-1)  # point/spot/distant/infinite store I or L at 3:6
    power = torch.where(kind == LIGHT_POINT, 4.0 * math.pi * lum, 0.0)
    power = torch.where(kind == LIGHT_SPOT, 2.0 * math.pi * (1.0 - 0.5 * (par[:, 9] + par[:, 10])) * lum, power)
    power = torch.where(kind == LIGHT_DISTANT, math.pi * wr * wr * lum, power)
    power = torch.where(kind == LIGHT_INFINITE, math.pi * wr * wr * lum, power)
    if any(k in (LIGHT_GONIO, LIGHT_PROJECTION) for k in static.light_kinds):
        # goniometric: 4 pi sum(I x the image's mean) (goniometric.rs
        # power); projection: the screen cone's solid angle 2 pi (1 -
        # cosTotalWidth) times the same (projection.rs power); a light
        # without an image counts its mean as 1
        avg = torch.stack([sa.light_images[key].mean(dim=(0, 1)) if key is not None
                           else torch.ones(3, dtype=torch.float32, device=par.device)
                           for key in static.light_image_keys])
        ilum = (par[:, 3:6] * avg).sum(-1)
        power = torch.where(kind == LIGHT_GONIO, 4.0 * math.pi * ilum, power)
        power = torch.where(kind == LIGHT_PROJECTION, 2.0 * math.pi * (1.0 - _projection_cos_total(par)) * ilum, power)
    if static.has_area_lights:
        area = sa.prim_area[torch.clamp(sa.light_prim, min=0)]
        two = 1.0 + (par[:, 3] > 0).to(torch.float32)
        power = torch.where(kind == LIGHT_AREA, two * area * math.pi * par[:, 0:3].sum(-1), power)
    return torch.clamp(power, min=0.0)


def _projection_cos_total(par):
    """cos of the cone around a projection light's screen window
    (projection.rs:75-79; reference lights._projection_cos_total :522):
    the screen corner (xm tan, ym tan, 1), (xm, ym) = (aspect, 1) for a
    wide image, (1, 1 / aspect) for a tall one."""
    tan_half = par[:, 9]
    aspect = torch.clamp(par[:, 10], min=1e-6)
    xm = torch.clamp(aspect, min=1.0)
    ym = torch.clamp(1.0 / aspect, min=1.0)
    return 1.0 / torch.sqrt(1.0 + tan_half * tan_half * (xm * xm + ym * ym))


# ---------------------------------------------------------------------------
# Emission sampling: the light endpoint of BDPT's light subpaths
# (Light::sample_le; reference lights.sample_le :573, area_light_pdf_dir :723)
# ---------------------------------------------------------------------------


def sample_le(sa, static, light_ids, u1a, u1b, u2a, u2b):
    """An emitted ray from each lane's light: {o, d, le_over_pdf (R, 3), n}
    with the radiance already divided by the position and direction pdfs
    (the light choice is the caller's), n the area light's surface normal
    at o (zeros for the other kinds). Point and goniometric lights emit
    uniformly over the sphere, spot and projection lights uniformly in
    their cone (the projection light's image, or its screen's inside test,
    scales Le), distant and infinite lights from a disk of the world's
    radius (the infinite light's direction from its map's distribution),
    area lights cosine-weighted from a uniform point (a two-sided one from
    the back half the time, u2a remapped to keep both halves stratified)."""
    R = light_ids.shape[0]
    dev = light_ids.device
    lid = torch.clamp(light_ids, min=0)
    kind = sa.light_kind[lid]
    par = sa.light_param[lid]
    wc = sa.world_center
    wr = sa.world_radius
    o = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    d = torch.zeros_like(o)
    w = torch.zeros_like(o)

    def put(m, o_k, d_k, w_k):
        nonlocal o, d, w
        mc = m[:, None]
        o = torch.where(mc, o_k, o)
        d = torch.where(mc, d_k, d)
        w = torch.where(mc, w_k, w)

    # point: the uniform sphere, pdf 1 / 4 pi
    put(kind == LIGHT_POINT, par[:, 0:3], uniform_sample_sphere(u2a, u2b), par[:, 3:6] * (4.0 * math.pi))
    # spot: the uniform cone about its axis, pdf 1 / (2 pi (1 - cosTotal))
    ctw = par[:, 9]
    cos_t = (1.0 - u2a) + u2a * ctw
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * u2b
    axis = par[:, 6:9]
    t1, t2 = coordinate_system(axis)
    d_sp = normalize(sin_t[:, None] * (torch.cos(phi)[:, None] * t1 + torch.sin(phi)[:, None] * t2)
                     + cos_t[:, None] * axis)
    cfs = par[:, 10]
    dfall = torch.clamp((cos_t - ctw) / torch.clamp(cfs - ctw, min=1e-9), 0.0, 1.0)
    fall = torch.where(cos_t < ctw, 0.0, torch.where(cos_t > cfs, 1.0, dfall ** 4))
    pdf_cone = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - ctw), min=1e-9)
    put(kind == LIGHT_SPOT, par[:, 0:3], d_sp, par[:, 3:6] * (fall / pdf_cone)[:, None])
    if any(k in (LIGHT_GONIO, LIGHT_PROJECTION) for k in static.light_kinds):
        # goniometric: the point light's sphere, Le scaled by its map;
        # projection: the cone about the screen's +z in light space, Le its
        # image there (0 outside the screen)
        m_g = kind == LIGHT_GONIO
        m_pj = kind == LIGHT_PROJECTION
        d_g = uniform_sample_sphere(u2a, u2b)
        cos_total = _projection_cos_total(par)
        cos_p = (1.0 - u2a) + u2a * cos_total
        sin_p = torch.sqrt(torch.clamp(1.0 - cos_p * cos_p, min=0.0))
        phi_p = TWO_PI * u2b
        v_l = torch.stack([sin_p * torch.cos(phi_p), sin_p * torch.sin(phi_p), cos_p], dim=-1)
        l2w_rot = torch.linalg.inv(sa.light_w2l[:, :3, :3])[lid]
        d_pj = normalize(xf_vector(l2w_rot, v_l))
        d_gp = torch.where(m_pj[:, None], d_pj, d_g)
        scale = torch.ones((R, 3), dtype=torch.float32, device=dev)
        if any(k is not None for k in static.light_image_keys):
            scale = _image_light_scale(sa, static, lid, d_gp, par, scale)
        tan_half = par[:, 9]
        aspect = torch.clamp(par[:, 10], min=1e-6)
        zc = torch.clamp(v_l[:, 2], min=1e-6)
        sx = v_l[:, 0] / zc / torch.clamp(tan_half * torch.clamp(aspect, min=1.0), min=1e-6)
        sy = v_l[:, 1] / zc / torch.clamp(tan_half * torch.clamp(1.0 / aspect, min=1.0), min=1e-6)
        inside = (v_l[:, 2] >= 1e-3) & (sx.abs() <= 1.0) & (sy.abs() <= 1.0)
        has_img = torch.zeros(R, dtype=torch.bool, device=dev)
        for i, key in enumerate(static.light_image_keys):
            if key is not None:
                has_img = has_img | (lid == i)
        scale = torch.where((m_pj & ~has_img)[:, None], torch.where(inside[:, None], 1.0, 0.0), scale)
        pdf_pj = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_total), min=1e-9)
        put(m_g, par[:, 0:3], d_gp, par[:, 3:6] * scale * (4.0 * math.pi))
        put(m_pj, par[:, 0:3], d_gp, par[:, 3:6] * scale / pdf_pj[:, None])
    # distant: a point of the world's disk, along -(the direction to it)
    wl = par[:, 0:3]
    dx, dy = concentric_sample_disk(u1a, u1b)
    v1, v2 = coordinate_system(wl)
    p_disk = wc + wr * (dx[:, None] * v1 + dy[:, None] * v2) + wl * wr
    put(kind == LIGHT_DISTANT, p_disk, -wl, par[:, 3:6] * (math.pi * wr * wr))
    if static.has_infinite:
        if static.has_env_map:
            d_env, li_env, pdf_env = _env_sample(sa, u2a, u2b)
            le = li_env / torch.clamp(pdf_env, min=1e-12)[:, None]
        else:
            d_env = uniform_sample_sphere(u2a, u2b)
            le = par[:, 3:6] * (4.0 * math.pi)
        d_in = -d_env
        v1, v2 = coordinate_system(d_in)
        p_disk = wc + wr * (dx[:, None] * v1 + dy[:, None] * v2) - d_in * wr
        put(kind == LIGHT_INFINITE, p_disk, d_in, le * (math.pi * wr * wr))
    n_out = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    if static.has_area_lights:
        from .bsdf import cosine_sample_hemisphere

        m = kind == LIGHT_AREA
        ps, ns, area = _sample_prim_point(sa, sa.light_prim[lid], u1a, u1b, frozenset(static.quadric_kinds))
        two_sided = par[:, 3] > 0
        flip = two_sided & (u2a < 0.5)
        u2a_r = torch.where(two_sided, torch.where(u2a < 0.5, 2.0 * u2a, 2.0 * (u2a - 0.5)), u2a)
        w_l = cosine_sample_hemisphere(u2a_r, u2b)
        ns_e = torch.where(flip[:, None], -ns, ns)
        t1a, t2a = coordinate_system(ns_e)
        d_ar = normalize(w_l[:, 0:1] * t1a + w_l[:, 1:2] * t2a + w_l[:, 2:3] * ns_e)
        # pdf_pos 1 / area, pdf_dir cos / pi (half that when two-sided)
        w_area = par[:, 0:3] * (area * math.pi * torch.where(two_sided, 2.0, 1.0))[:, None]
        put(m, ps + ns_e * 1e-3, d_ar, w_area)
        n_out = torch.where(m[:, None], ns, n_out)
    return {"o": o, "d": d, "le_over_pdf": w, "n": n_out}


def area_light_pdf_dir(sa, light_ids, n, w):
    """A diffuse area light's emission-direction pdf (diffuse.rs pdf_le):
    cos / pi one-sided, half that two-sided, cos clamped at 1e-6."""
    par = sa.light_param[torch.clamp(light_ids, min=0)]
    return torch.where(par[:, 3] > 0, 0.5, 1.0) * torch.clamp(dot(n, w).abs(), min=1e-6) / math.pi
