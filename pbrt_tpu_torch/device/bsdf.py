"""Batched BSDF layer: fixed-slot lobe sets in the shading frame.

The port's counterpart of ``pbrt_tpu/device/bsdf.py`` (the reference's
redesign of src/core/reflection.rs:1496-1712, a BSDF of at most 8 BxDFs)
for every lobe kind the surface materials build: LOBE_LAMBERT_R and
LOBE_LAMBERT_T, LOBE_OREN_NAYAR, LOBE_MICRO_R and LOBE_MICRO_T
(Trowbridge-Reitz or Beckmann; dielectric, conductor or Schlick Fresnel),
LOBE_SPEC_R, LOBE_SPEC_T, LOBE_FRESNEL_SPEC, LOBE_FRESNEL_BLEND (substrate),
LOBE_DISNEY_DIFF and LOBE_CLEARCOAT (disney), LOBE_FOURIER (device/fourier.py)
LOBE_HAIR (device/hair.py) and LOBE_SSS_ADAPTER (the tabulated BSSRDF's
exit-point lobe, device/bssrdf.py), in radiance transport or, with
``mode="importance"`` (BDPT's light subpaths), in importance transport:
the specular and microfacet transmissions, the Fourier lobe and the
adapter then leave out their eta factors (reflection.rs:703, :777, :1087,
:1308; bssrdf.rs:593-600), and ``correct_shading_normal`` is the adjoint
shading-normal factor the callers apply.

A lobe set is {"kind": (R, S) int, "data": (R, S, 14) float32, "possible":
S frozensets, "has_beckmann" and "has_schlick": bool (some lobe may use
Beckmann's distribution, Schlick's Fresnel), and "fourier": the scene's
stacked Fourier tables where it has them}. "possible" is static: per slot, the
lobe kinds the scene's material table holds there (materials.lobe_table
drops the slots that hold none). Every formula below is evaluated only for
kinds that can occur, and where a slot can hold one kind only, the test of
that kind is left out: the lanes it would mask are lanes without a lobe,
which the callers mask already. The results equal the reference's 8-slot
evaluation of the same lobes. Data columns: color 0:3 (Rd of the Fresnel
blend, sigma_a of hair), eta 3 (or conductor eta, or Schlick's F0, 3:6),
conductor k, Kt, the blend's Rs or Disney's sheen 6:9, alpha_x 9, alpha_y
10, Fresnel kind 11, Oren-Nayar (A, B), the micro lobes' Beckmann flag,
Disney's roughness, the Fourier table id or hair's (alpha, h) in 12:14.

Local frame convention: z = shading normal; cos_theta(w) = w.z.
"""
from __future__ import annotations

import functools
import math
import operator

import torch

from .camera import concentric_sample_disk
from .shading import cross, dot, normalize

N_SLOTS = 8
LOBE_NONE = 0
LOBE_LAMBERT_R = 1
LOBE_LAMBERT_T = 2
LOBE_OREN_NAYAR = 3
LOBE_MICRO_R = 4
LOBE_MICRO_T = 5
LOBE_SPEC_R = 6
LOBE_SPEC_T = 7
LOBE_FRESNEL_SPEC = 8
LOBE_FRESNEL_BLEND = 9
LOBE_DISNEY_DIFF = 10  # Burley diffuse + sheen (disney.rs DisneyDiffuse, DisneySheen)
LOBE_CLEARCOAT = 11  # GTR1 clearcoat (disney.rs DisneyClearcoat)
LOBE_FOURIER = 12  # tabulated BSDF (reflection.rs FourierBSDF); table id in data[12]
LOBE_HAIR = 13  # Marschner fiber model (materials/hair.rs); slots in device/hair.py
LOBE_SSS_ADAPTER = 14  # the BSSRDF's exit-point lobe: f = Sw(wi) eta^2, eta in data[3]
PORTED_KINDS = frozenset({LOBE_LAMBERT_R, LOBE_LAMBERT_T, LOBE_OREN_NAYAR, LOBE_MICRO_R, LOBE_MICRO_T, LOBE_SPEC_R,
                          LOBE_SPEC_T, LOBE_FRESNEL_SPEC, LOBE_FRESNEL_BLEND, LOBE_DISNEY_DIFF, LOBE_CLEARCOAT,
                          LOBE_FOURIER, LOBE_HAIR, LOBE_SSS_ADAPTER})
SPECULAR_KINDS = frozenset({LOBE_SPEC_R, LOBE_SPEC_T, LOBE_FRESNEL_SPEC})
# cosine-sampled on the wo side
_DIFFUSE = frozenset({LOBE_LAMBERT_R, LOBE_OREN_NAYAR, LOBE_DISNEY_DIFF, LOBE_SSS_ADAPTER})
_TRANS = frozenset({LOBE_LAMBERT_T, LOBE_MICRO_T, LOBE_SPEC_T})
_BOTH = frozenset({LOBE_FRESNEL_SPEC, LOBE_FOURIER, LOBE_HAIR})
INV_PI = 1.0 / math.pi
_ETA_MIN = 1.0 + 1e-6


# ---------------------------------------------------------------------------
# masks over the static kind sets
# ---------------------------------------------------------------------------


def _of(kind, ks, possible):
    """Lanes whose lobe kind is in ks, for kinds drawn from `possible` (or
    none): None when every possible kind is in ks (the caller keeps its
    value on every lane), else a bool tensor."""
    if possible <= ks:
        return None
    return functools.reduce(operator.or_, [kind == k for k in sorted(ks & possible)])


def _and(m, c):
    """m & c, either of which may be None (every lane)."""
    if m is None or c is None:
        return c if m is None else m
    return m & c


# ---------------------------------------------------------------------------
# local-frame helpers
# ---------------------------------------------------------------------------


def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return w[..., 2].abs()


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0


def reflect_dir(wo, n):
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract_dir(wi, n, eta_ratio):
    """Refract wi about n with eta_ratio = eta_i / eta_t. Returns (ok, wt)."""
    cos_i = dot(n, wi)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta_ratio * eta_ratio * sin2_i
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = eta_ratio[..., None] * -wi + (eta_ratio * cos_i - cos_t)[..., None] * n
    return sin2_t < 1.0, wt


def cosine_sample_hemisphere(u1, u2):
    dx, dy = concentric_sample_disk(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=0.0))
    return torch.stack([dx, dy, z], dim=-1)


# ---------------------------------------------------------------------------
# Fresnel (reflection.rs:521-609)
# ---------------------------------------------------------------------------


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel; either side by the sign of cos_i."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = cos_i.abs()
    sin_t = ei / et * torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_parl = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-30)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-30)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(sin_t >= 1.0, 1.0, f)


def fresnel_conductor(cos_i, eta, k):
    """Conductor Fresnel, rgb eta and k (reflection.rs fr_conductor)."""
    ci = torch.clamp(cos_i.abs(), 0.0, 1.0)[..., None]
    cos2 = ci * ci
    sin2 = 1.0 - cos2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - sin2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * k2, min=0.0))
    t1 = a2b2 + cos2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-30)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-30)
    return 0.5 * (rp + rs)


def ipow(x, n: int):
    """x ** n for an integer n > 0 as XLA lowers it (lax.integer_pow's
    binary exponentiation), so the products round as the reference's."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _pow5(x):
    """x*x*x*x*x, left to right, as the reference's Disney and Fresnel
    blend terms write it."""
    return x * x * x * x * x


def fresnel_schlick(cos_i, f0):
    """Schlick's approximation with rgb F0 (disney.rs specular Fresnel)."""
    c = torch.clamp(cos_i.abs(), 0.0, 1.0)
    return f0 + ipow(1.0 - c, 5)[..., None] * (1.0 - f0)


def lobe_fresnel(data, cos_i, schlick=False):
    """Per-lobe Fresnel by data[..., 11]: 0 none, 1 dielectric, 2 conductor,
    3 Schlick (evaluated only when `schlick`: a disney row is present)."""
    fk = data[..., 11]
    f_d = fresnel_dielectric(cos_i, 1.0, torch.clamp(data[..., 3], min=_ETA_MIN))[..., None]
    out = torch.where((fk == 1)[..., None], f_d, 1.0)
    f_c = fresnel_conductor(cos_i, data[..., 3:6], data[..., 6:9])
    out = torch.where((fk == 2)[..., None], f_c, out)
    if schlick:
        out = torch.where((fk == 3)[..., None], fresnel_schlick(cos_i, data[..., 3:6]), out)
    return out


# ---------------------------------------------------------------------------
# Trowbridge-Reitz (GGX) and Beckmann microfacets (microfacet.rs:150-337)
# ---------------------------------------------------------------------------


def tr_roughness_to_alpha(rough):
    """TrowbridgeReitz::roughness_to_alpha (microfacet.rs), float32 in the
    reference's operation order."""
    r = torch.clamp(rough, min=1e-3)
    x = torch.log(r)
    x2 = x * x
    return 1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * (x2 * x) + 0.000640711 * (x2 * x2)


def _slope2(wh, ax, ay, c2, fill):
    """(wh.x^2 / ax^2 + wh.y^2 / ay^2) / cos^2, or `fill` at grazing wh."""
    e = (wh[..., 0] * wh[..., 0] / torch.clamp(ax * ax, min=1e-12)
         + wh[..., 1] * wh[..., 1] / torch.clamp(ay * ay, min=1e-12)) / torch.clamp(c2, min=1e-12)
    return torch.where(c2 > 1e-12, e, fill)


def ggx_d(wh, ax, ay):
    c2 = wh[..., 2] * wh[..., 2]
    e1 = 1.0 + _slope2(wh, ax, ay, c2, 0.0)
    denom = math.pi * ax * ay * c2 * c2 * (e1 * e1)
    return torch.where(c2 > 1e-12, 1.0 / torch.clamp(denom, min=1e-20), 0.0)


def ggx_lambda(w, ax, ay):
    c = w[..., 2]
    c2 = c * c
    a2 = w[..., 0] * w[..., 0] * ax * ax + w[..., 1] * w[..., 1] * ay * ay
    alpha2_tan2 = torch.where(c2 > 1e-12, a2 / torch.clamp(c2, min=1e-12), 1e12)
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + alpha2_tan2))
    return torch.where(c.abs() > 1e-6, lam, 1e6)


def ggx_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + ggx_lambda(wo, ax, ay) + ggx_lambda(wi, ax, ay))


def ggx_g1(w, ax, ay):
    return 1.0 / (1.0 + ggx_lambda(w, ax, ay))


def _axis(like, i: int):
    """The unit vector along axis i, shaped like `like` (..., 3), made on
    its device (no host-to-device copy, so a captured or sync-free step may
    call it)."""
    e = torch.zeros_like(like)
    e[..., i] = 1.0
    return e


def ggx_sample_wh(wo, u1, u2, ax, ay):
    """Visible-normal sampling (microfacet.rs trowbridge_reitz_sample)."""
    flip = (wo[..., 2] < 0)[..., None]
    wo_f = torch.where(flip, -wo, wo)
    wi_s = normalize(torch.stack([ax * wo_f[..., 0], ay * wo_f[..., 1], wo_f[..., 2]], dim=-1))
    z_axis = _axis(wi_s, 2)
    x_axis = _axis(wi_s, 0)
    t1 = torch.where((wi_s[..., 2] < 0.9999)[..., None], normalize(cross(z_axis, wi_s)), x_axis)
    t2 = cross(wi_s, t1)
    a = 1.0 / (1.0 + wi_s[..., 2])
    r = torch.sqrt(torch.clamp(u1, min=0.0))
    lower = u2 < a
    phi = torch.where(lower, u2 / torch.clamp(a, min=1e-12) * math.pi,
                      math.pi + (u2 - a) / torch.clamp(1.0 - a, min=1e-12) * math.pi)
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi) * torch.where(lower, 1.0, wi_s[..., 2])
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * wi_s
    wh = normalize(torch.stack([ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=1e-6)], dim=-1))
    return torch.where(flip, -wh, wh)


def ggx_pdf(wo, wh, ax, ay):
    """Visible-normal pdf: D(wh) G1(wo) |wo.wh| / |cos wo|."""
    return ggx_d(wh, ax, ay) * ggx_g1(wo, ax, ay) * dot(wo, wh).abs() / torch.clamp(abs_cos_theta(wo), min=1e-9)


def beckmann_d(wh, ax, ay):
    c2 = wh[..., 2] * wh[..., 2]
    d = torch.exp(-_slope2(wh, ax, ay, c2, 1e12)) / torch.clamp(math.pi * ax * ay * c2 * c2, min=1e-20)
    return torch.where(c2 > 1e-12, d, 0.0)


def beckmann_lambda(w, ax, ay):
    """BeckmannDistribution::lambda, the rational approximation."""
    c = w[..., 2].abs()
    sin2 = torch.clamp(1.0 - c * c, min=0.0)
    denom = torch.clamp(sin2, min=1e-12)
    cos2p = torch.where(sin2 > 1e-12, w[..., 0] * w[..., 0] / denom, 1.0)
    sin2p = torch.where(sin2 > 1e-12, w[..., 1] * w[..., 1] / denom, 0.0)
    alpha = torch.sqrt(torch.clamp(cos2p * ax * ax + sin2p * ay * ay, min=1e-12))
    abs_tan = torch.sqrt(sin2) / torch.clamp(c, min=1e-9)
    a = 1.0 / torch.clamp(alpha * abs_tan, min=1e-12)
    lam = torch.where(a >= 1.6, 0.0, (1.0 - 1.259 * a + 0.396 * a * a) / torch.clamp(3.535 * a + 2.181 * a * a,
                                                                                      min=1e-12))
    return torch.where(w[..., 2].abs() > 1e-6, lam, 1e6)


def beckmann_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + beckmann_lambda(wo, ax, ay) + beckmann_lambda(wi, ax, ay))


def beckmann_sample_wh(wo, u1, u2, ax, ay):
    """Full-distribution sampling (beckmann_sample with
    sample_visible_area = false), anisotropic."""
    log_s = torch.log(torch.clamp(1.0 - u1, min=1e-12))
    iso = (ax - ay).abs() < 1e-7
    phi_a = torch.atan(ay / torch.clamp(ax, min=1e-9) * torch.tan(2.0 * math.pi * u2 + 0.5 * math.pi))
    phi_a = torch.where(u2 > 0.5, phi_a + math.pi, phi_a)
    phi = torch.where(iso, 2.0 * math.pi * u2, phi_a)
    cp = torch.cos(phi)
    sp = torch.sin(phi)
    tan2 = torch.where(iso, -log_s * ax * ax,
                       -log_s / torch.clamp(cp * cp / torch.clamp(ax * ax, min=1e-12)
                                            + sp * sp / torch.clamp(ay * ay, min=1e-12), min=1e-12))
    c = 1.0 / torch.sqrt(1.0 + tan2)
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    wh = torch.stack([s * cp, s * sp, c], dim=-1)
    return torch.where(same_hemisphere(wo, wh)[..., None], wh, -wh)


def beckmann_pdf(wo, wh, ax, ay):
    return beckmann_d(wh, ax, ay) * wh[..., 2].abs()


def _is_beck(kind, data):
    """Per-lobe Beckmann flag (micro lobes keep it in data[..., 12])."""
    return ((kind == LOBE_MICRO_R) | (kind == LOBE_MICRO_T)) & (data[..., 12] > 0)


def micro_d(kind, data, wh, ax, ay, beck: bool):
    if not beck:
        return ggx_d(wh, ax, ay)
    return torch.where(_is_beck(kind, data), beckmann_d(wh, ax, ay), ggx_d(wh, ax, ay))


def micro_g(kind, data, wo, wi, ax, ay, beck: bool):
    if not beck:
        return ggx_g(wo, wi, ax, ay)
    return torch.where(_is_beck(kind, data), beckmann_g(wo, wi, ax, ay), ggx_g(wo, wi, ax, ay))


def micro_sample_wh(kind, data, wo, u1, u2, ax, ay, beck: bool):
    if not beck:
        return ggx_sample_wh(wo, u1, u2, ax, ay)
    return torch.where(_is_beck(kind, data)[..., None], beckmann_sample_wh(wo, u1, u2, ax, ay),
                       ggx_sample_wh(wo, u1, u2, ax, ay))


def micro_pdf_wh(kind, data, wo, wh, ax, ay, beck: bool):
    if not beck:
        return ggx_pdf(wo, wh, ax, ay)
    return torch.where(_is_beck(kind, data), beckmann_pdf(wo, wh, ax, ay), ggx_pdf(wo, wh, ax, ay))


# ---------------------------------------------------------------------------
# one lobe slot
# ---------------------------------------------------------------------------


def _lobe_f(kind, data, wo, wi, possible, beck, schlick=False, fourier=None, mode: str = "radiance"):
    """f of one slot's non-specular lobe (0 for the specular kinds); lanes
    without a lobe are the caller's to mask. schlick: a disney row is
    present (Fresnel kind 3); fourier: the scene's stacked tables; mode:
    the transport mode, "radiance" or "importance" (reference :355-430):
    radiance transport carries the non-symmetric eta factors of the
    microfacet transmission, the Fourier lobe and the BSSRDF adapter,
    importance (adjoint) transport omits them."""
    color = data[..., 0:3]
    out = 0.0

    def put(ks, cond, value):
        nonlocal out
        m = _and(_of(kind, ks, possible), cond)
        out = value if m is None else torch.where(m[:, None], value, out)

    if possible & {LOBE_OREN_NAYAR, LOBE_MICRO_R, LOBE_MICRO_T, LOBE_DISNEY_DIFF, LOBE_CLEARCOAT,
                   LOBE_FRESNEL_BLEND}:
        refl_hemi = same_hemisphere(wo, wi)
        abs_ci = abs_cos_theta(wi)
        abs_co = abs_cos_theta(wo)
    if possible & {LOBE_LAMBERT_R, LOBE_LAMBERT_T}:
        put({LOBE_LAMBERT_R, LOBE_LAMBERT_T}, None, color * INV_PI)
    if LOBE_SSS_ADAPTER in possible:
        # the BSSRDF's directional term at the exit point, times eta^2 in
        # radiance transport (bssrdf.rs:593-600)
        from .bssrdf import sw_factor

        eta_a = torch.clamp(data[..., 3], min=_ETA_MIN)
        f_sw = sw_factor(eta_a, cos_theta(wi))
        if mode == "radiance":
            f_sw = f_sw * eta_a * eta_a
        put({LOBE_SSS_ADAPTER}, same_hemisphere(wo, wi), f_sw[..., None] * torch.ones_like(color))
    if LOBE_OREN_NAYAR in possible:
        si = torch.sqrt(torch.clamp(1.0 - wi[..., 2] * wi[..., 2], min=0.0))
        so = torch.sqrt(torch.clamp(1.0 - wo[..., 2] * wo[..., 2], min=0.0))
        cos_phi_i = torch.where(si > 1e-4, wi[..., 0] / torch.clamp(si, min=1e-12), 1.0)
        sin_phi_i = torch.where(si > 1e-4, wi[..., 1] / torch.clamp(si, min=1e-12), 0.0)
        cos_phi_o = torch.where(so > 1e-4, wo[..., 0] / torch.clamp(so, min=1e-12), 1.0)
        sin_phi_o = torch.where(so > 1e-4, wo[..., 1] / torch.clamp(so, min=1e-12), 0.0)
        max_cos = torch.clamp(cos_phi_i * cos_phi_o + sin_phi_i * sin_phi_o, min=0.0)
        i_steeper = abs_ci > abs_co
        sin_alpha = torch.where(i_steeper, so, si)
        tan_beta = torch.where(i_steeper, si / torch.clamp(abs_ci, min=1e-9), so / torch.clamp(abs_co, min=1e-9))
        put({LOBE_OREN_NAYAR}, None,
            color * INV_PI * (data[..., 12] + data[..., 13] * max_cos * sin_alpha * tan_beta)[..., None])
    if possible & {LOBE_MICRO_R, LOBE_MICRO_T, LOBE_FRESNEL_BLEND}:
        ax = data[..., 9]
        ay = data[..., 10]
    if possible & {LOBE_MICRO_R, LOBE_FRESNEL_BLEND}:
        wh = wi + wo
        wh_len = torch.sqrt(dot(wh, wh))
        wh_n = wh / torch.clamp(wh_len, min=1e-30)[..., None]
        d_val = micro_d(kind, data, wh_n, ax, ay, beck)
    if LOBE_MICRO_R in possible:
        fr = lobe_fresnel(data, dot(wi, torch.where((wh_n[..., 2] < 0)[..., None], -wh_n, wh_n)), schlick)
        g_val = micro_g(kind, data, wo, wi, ax, ay, beck)
        f_mr = color * fr * (d_val * g_val / torch.clamp(4.0 * abs_co * abs_ci, min=1e-12))[..., None]
        put({LOBE_MICRO_R}, refl_hemi & (wh_len > 1e-12) & (abs_ci > 0) & (abs_co > 0), f_mr)
    if LOBE_MICRO_T in possible:
        eta = torch.clamp(data[..., 3], min=_ETA_MIN)
        eta_t = torch.where(cos_theta(wo) > 0, eta, 1.0 / eta)
        wh_t = normalize(wo + wi * eta_t[..., None])
        wh_t = torch.where((wh_t[..., 2] < 0)[..., None], -wh_t, wh_t)
        o_h = dot(wo, wh_t)
        i_h = dot(wi, wh_t)
        sqrt_denom = o_h + eta_t * i_h
        fr_t = fresnel_dielectric(o_h, 1.0, eta)
        d_t = micro_d(kind, data, wh_t, ax, ay, beck)
        g_t = micro_g(kind, data, wo, wi, ax, ay, beck)
        # radiance transport: (1/eta_t)^2 against the eta_t^2 Jacobian term
        # (reflection.rs:1086-1089); importance transport keeps the bare eta_t^2
        factor2 = 1.0 / (eta_t * eta_t) if mode == "radiance" else torch.ones_like(eta_t)
        f_mt = (1.0 - fr_t) * (d_t * g_t * eta_t * eta_t * factor2 * i_h.abs() * o_h.abs()
                               / torch.clamp(abs_ci * abs_co * sqrt_denom * sqrt_denom, min=1e-12)).abs()
        put({LOBE_MICRO_T}, ~refl_hemi & ~(o_h * i_h > 0) & (abs_ci > 0) & (abs_co > 0), color * f_mt[..., None])
    if LOBE_DISNEY_DIFF in possible:
        # Burley diffuse + sheen (disney.rs DisneyDiffuse :60-90, DisneySheen):
        # color = baseColor (1 - metallic)(1 - spectrans), roughness in 12,
        # the sheen color in 6:9
        fo = _pow5(1.0 - abs_co)
        fi = _pow5(1.0 - abs_ci)
        cos_d = dot(wi, normalize(wi + wo))
        fd90 = 0.5 + 2.0 * data[..., 12] * cos_d * cos_d
        fd = (1.0 + (fd90 - 1.0) * fo) * (1.0 + (fd90 - 1.0) * fi)
        sheen = data[..., 6:9] * _pow5(1.0 - cos_d.abs())[..., None]
        put({LOBE_DISNEY_DIFF}, refl_hemi, color * INV_PI * fd[..., None] + sheen)
    if LOBE_CLEARCOAT in possible:
        # GTR1 with Fresnel 0.04 and Smith G of alpha 0.25 (disney.rs
        # DisneyClearcoat); the gloss alpha in 9, the weight in color
        alpha_c = data[..., 9]
        wh_c = wi + wo
        whl = torch.sqrt(dot(wh_c, wh_c))
        wh_c = wh_c / torch.clamp(whl, min=1e-30)[..., None]
        d_c = _gtr1(alpha_c, wh_c)
        fr_c = 0.04 + 0.96 * ipow(1.0 - dot(wi, wh_c).abs(), 5)
        quarter = torch.full_like(alpha_c, 0.25)
        g_c = ggx_g(wo, wi, quarter, quarter)
        f_cc = color * (d_c * fr_c * g_c / torch.clamp(4.0 * abs_co * abs_ci, min=1e-12))[..., None]
        put({LOBE_CLEARCOAT}, refl_hemi & (whl > 1e-12), f_cc)
    if LOBE_FOURIER in possible:
        from .fourier import fourier_f

        put({LOBE_FOURIER}, None, _on_fourier_lanes(kind, torch.zeros_like(wo), lambda i: fourier_f(
            fourier, data[i, 12].to(torch.int64), wo[i], wi[i], mode)))
    if LOBE_HAIR in possible:
        from .hair import hair_f

        put({LOBE_HAIR}, None, hair_f(data, wo, wi))
    if LOBE_FRESNEL_BLEND in possible:
        # substrate (reflection.rs FresnelBlend :1115-1170): Rd in color, Rs in 6:9
        rs = data[..., 6:9]
        diffuse = ((28.0 / (23.0 * math.pi)) * color * (1.0 - _pow5(1.0 - 0.5 * abs_ci))[..., None]
                   * (1.0 - _pow5(1.0 - 0.5 * abs_co))[..., None]) * (1.0 - rs)
        i_h = dot(wi, wh_n).abs()
        schlick_fb = rs + _pow5(1.0 - i_h)[..., None] * (1.0 - rs)
        spec = (d_val / torch.clamp(4.0 * i_h * torch.maximum(abs_ci, abs_co), min=1e-12))[..., None] * schlick_fb
        put({LOBE_FRESNEL_BLEND}, refl_hemi, diffuse + torch.where((wh_len > 1e-12)[..., None], spec, 0.0))
    return out


def _on_fourier_lanes(kind, out, fn):
    """out with fn(lanes) written at the lanes whose lobe is LOBE_FOURIER.
    A tabulated lobe reads 16 coefficient rows of 3 MCAP floats per lane,
    so it is evaluated on those lanes only (a compaction: each lane's value
    is the same function of its own inputs)."""
    lanes = (kind == LOBE_FOURIER).nonzero()[:, 0]
    out[lanes] = fn(lanes)
    return out


def _gtr1(alpha_c, wh_c):
    """GTR1 D of the clearcoat (disney.rs), with the reference's clamps."""
    a2 = torch.clamp(alpha_c * alpha_c, 1e-6, 1.0 - 1e-4)
    c2h = torch.clamp(wh_c[..., 2] * wh_c[..., 2], 0.0, 1.0)
    return torch.clamp((a2 - 1.0) / (math.pi * torch.log(a2) * (1.0 + (a2 - 1.0) * c2h)), 0.0, 1e6)


def _any_of(kind, ks):
    return functools.reduce(operator.or_, [kind == k for k in sorted(ks)])


def _lobe_matches(kind, refl, possible):
    """Does this slot's lobe take part for the geometric reflect/transmit
    bit? Transmission kinds on transmission, FRESNEL_SPEC, FOURIER and HAIR
    on both, the rest on reflection; never a lane without a lobe."""
    has = kind != LOBE_NONE
    trans = possible & _TRANS
    both = possible & _BOTH
    if not trans and not both:
        return refl & has
    if possible <= _TRANS:
        return ~refl & has
    if possible <= _BOTH:
        return has
    is_trans = _any_of(kind, trans) if trans else torch.zeros_like(has)
    is_refl = has & ~is_trans
    if both:
        is_both = _any_of(kind, both)
        return torch.where(refl, is_refl & ~is_both, is_trans) | is_both
    return torch.where(refl, is_refl, is_trans)


def _lobe_pdf(kind, data, wo, wi, possible, beck, fourier=None):
    """Solid-angle pdf of one slot's lobe (0 for the specular kinds); lanes
    without a lobe are the caller's to mask."""
    refl_hemi = same_hemisphere(wo, wi)
    pdf = 0.0

    def put(ks, cond, value):
        nonlocal pdf
        m = _and(_of(kind, ks, possible), cond)
        pdf = value if m is None else torch.where(m, value, pdf)

    if possible & (_DIFFUSE | {LOBE_LAMBERT_T, LOBE_FRESNEL_BLEND}):
        cos_pdf = abs_cos_theta(wi) * INV_PI
    if possible & _DIFFUSE:
        put(_DIFFUSE, refl_hemi, cos_pdf)
    if LOBE_LAMBERT_T in possible:
        put({LOBE_LAMBERT_T}, ~refl_hemi, cos_pdf)
    if LOBE_CLEARCOAT in possible:
        wh_c = normalize(wo + wi)
        p_cc = _gtr1(data[..., 9], wh_c) * wh_c[..., 2].abs() / torch.clamp(4.0 * dot(wo, wh_c).abs(), min=1e-12)
        put({LOBE_CLEARCOAT}, refl_hemi, p_cc)
    if possible & {LOBE_MICRO_R, LOBE_MICRO_T, LOBE_FRESNEL_BLEND}:
        ax = data[..., 9]
        ay = data[..., 10]
    if possible & {LOBE_MICRO_R, LOBE_FRESNEL_BLEND}:
        wh = normalize(wo + wi)
        p_mr = micro_pdf_wh(kind, data, wo, wh, ax, ay, beck) / torch.clamp(4.0 * dot(wo, wh).abs(), min=1e-12)
    if LOBE_MICRO_R in possible:
        put({LOBE_MICRO_R}, refl_hemi, p_mr)
    if LOBE_FRESNEL_BLEND in possible:
        put({LOBE_FRESNEL_BLEND}, refl_hemi, 0.5 * (cos_pdf + p_mr))
    if LOBE_MICRO_T in possible:
        eta = torch.clamp(data[..., 3], min=_ETA_MIN)
        eta_t = torch.where(cos_theta(wo) > 0, eta, 1.0 / eta)
        wh_t = normalize(wo + wi * eta_t[..., None])
        o_h = dot(wo, wh_t)
        i_h = dot(wi, wh_t)
        sqrt_denom = o_h + eta_t * i_h
        dwh_dwi = (eta_t * eta_t * i_h / torch.clamp(sqrt_denom * sqrt_denom, min=1e-12)).abs()
        p_mt = micro_pdf_wh(kind, data, wo, wh_t, ax, ay, beck) * dwh_dwi
        put({LOBE_MICRO_T}, ~refl_hemi & ~(o_h * i_h > 0), p_mt)
    if LOBE_FOURIER in possible:
        from .fourier import fourier_pdf

        put({LOBE_FOURIER}, None, _on_fourier_lanes(kind, torch.zeros_like(wo[:, 0]), lambda i: fourier_pdf(
            fourier, data[i, 12].to(torch.int64), wo[i], wi[i])))
    if LOBE_HAIR in possible:
        from .hair import hair_pdf

        put({LOBE_HAIR}, None, hair_pdf(data, wo, wi))
    if not torch.is_tensor(pdf):  # only specular kinds: pdf 0
        pdf = torch.zeros_like(refl_hemi, dtype=torch.float32)
    return pdf


def _check(lobes):
    for p in lobes["possible"]:
        if p - PORTED_KINDS:
            raise NotImplementedError(f"pbrt_tpu_torch does not evaluate lobe kinds {sorted(p - PORTED_KINDS)} yet")


# ---------------------------------------------------------------------------
# the BSDF
# ---------------------------------------------------------------------------


def correct_shading_normal(ns, ng, wo, wi):
    """The adjoint BSDF's shading-normal correction of importance transport,
    |wo.ns| |wi.ng| / (|wo.ng| |wi.ns|), 0 where the denominator vanishes
    (bdpt.rs:45-57; reference :54). All vectors in world space."""
    num = dot(wo, ns).abs() * dot(wi, ng).abs()
    denom = dot(wo, ng).abs() * dot(wi, ns).abs()
    return torch.where(denom > 1e-12, num / torch.clamp(denom, min=1e-12), 0.0)


def _is_specular(kind):
    return (kind == LOBE_SPEC_R) | (kind == LOBE_SPEC_T) | (kind == LOBE_FRESNEL_SPEC)


def bsdf_f(lobes, wo, wi, refl, mode: str = "radiance"):
    """Sum of the non-specular lobes' f that match the reflect/transmit
    geometry bit, in transport mode `mode` (_lobe_f)."""
    _check(lobes)
    kinds = lobes["kind"]
    beck = bool(lobes.get("has_beckmann", False))
    schlick = bool(lobes.get("has_schlick", False))
    total = None
    for s, poss in enumerate(lobes["possible"]):
        if not poss - SPECULAR_KINDS:
            continue
        k = kinds[:, s]
        match = _lobe_matches(k, refl, poss)
        if poss & SPECULAR_KINDS:
            match = match & ~_is_specular(k)
        term = torch.where(match[:, None], _lobe_f(k, lobes["data"][:, s], wo, wi, poss, beck, schlick,
                                                   lobes.get("fourier"), mode), 0.0)
        total = term if total is None else total + term
    return torch.zeros_like(wo) if total is None else total


def bsdf_pdf(lobes, wo, wi):
    """Average pdf over the active lobes (reflection.rs BSDF::pdf)."""
    _check(lobes)
    kinds = lobes["kind"]
    beck = bool(lobes.get("has_beckmann", False))
    slots = [(s, p) for s, p in enumerate(lobes["possible"]) if p]
    if len(slots) == 1:  # one slot: the average is that slot's pdf where it has a lobe
        s, poss = slots[0]
        if not poss - SPECULAR_KINDS:
            return torch.zeros_like(wo[:, 0])
        k = kinds[:, s]
        return torch.where(k != LOBE_NONE, _lobe_pdf(k, lobes["data"][:, s], wo, wi, poss, beck,
                                                     lobes.get("fourier")), 0.0)
    total = torch.zeros_like(wo[:, 0])
    n = torch.zeros_like(wo[:, 0])
    for s, poss in slots:
        k = kinds[:, s]
        active = k != LOBE_NONE
        if poss - SPECULAR_KINDS:
            total = total + torch.where(active, _lobe_pdf(k, lobes["data"][:, s], wo, wi, poss, beck,
                                                          lobes.get("fourier")), 0.0)
        n = n + active
    return torch.where(n > 0, total / torch.clamp(n, min=1.0), 0.0)


def num_lobes(lobes):
    return (lobes["kind"] != LOBE_NONE).sum(1)


def all_possible(lobes) -> frozenset:
    return frozenset().union(*lobes["possible"])


def bsdf_sample(lobes, wo, u_lobe, u1, u2, mode: str = "radiance"):
    """Sample the BSDF: choose an active lobe uniformly, sample it, combine
    (reflection.rs BSDF::sample_f :1583-1669). For a non-specular chosen
    lobe, f and pdf are recomputed over every lobe. mode: the transport
    mode; importance transport omits the (eta_i / eta_t)^2 of the specular
    transmissions (reflection.rs:703,777) and _lobe_f's eta factors, and
    its callers apply correct_shading_normal themselves.

    Returns dict {wi, f, pdf, specular, valid, eta_scale, abs_cos}."""
    _check(lobes)
    kinds = lobes["kind"]
    data = lobes["data"]
    union = all_possible(lobes)
    beck = bool(lobes.get("has_beckmann", False))
    if not union:  # no material row has a lobe
        zero = torch.zeros_like(wo[:, 0])
        return {"wi": torch.zeros_like(wo), "f": torch.zeros_like(wo), "pdf": zero, "specular": zero > 0,
                "valid": zero > 0, "eta_scale": torch.ones_like(zero), "abs_cos": zero}
    active = kinds != LOBE_NONE
    if kinds.shape[1] == 1:
        # the one slot is the pick; a lane without a lobe holds kind 0 and
        # zero data, and a lane with one has n_act = 1
        valid = active[:, 0]
        k = kinds[:, 0]
        dat = data[:, 0]
        n_act_f = None
    else:
        n_act = active.sum(1)
        valid = n_act > 0
        pick = torch.minimum((u_lobe * n_act).to(torch.int64), torch.clamp(n_act - 1, min=0))
        sel = active & (torch.cumsum(active, 1) - 1 == pick[:, None])
        k = torch.where(sel, kinds, 0).sum(1)
        dat = torch.where(sel[:, :, None], data, 0.0).sum(1)
        n_act_f = torch.clamp(n_act.to(torch.float32), min=1.0)
    color = dat[:, 0:3]
    entering = cos_theta(wo) > 0
    if union & (_TRANS | _BOTH):
        eta = torch.clamp(dat[:, 3], min=_ETA_MIN)
        eta_ratio = torch.where(entering, 1.0 / eta, eta)
    wi = 0.0

    def take(ks, value):
        """wi = value on the lanes whose lobe kind is in ks; returns them."""
        nonlocal wi
        m = _of(k, ks, union)
        if m is None:  # every lane with a lobe: mask the lanes without one
            m = k != LOBE_NONE
        wi = torch.where(m[:, None], value, wi)
        return m

    if union & (_DIFFUSE | {LOBE_LAMBERT_T, LOBE_FRESNEL_BLEND}):
        flip_z = 1.0 - 2.0 * _axis(wo, 2)  # (1, 1, -1)
    if union & (_DIFFUSE | {LOBE_LAMBERT_T}):
        wi_cos = cosine_sample_hemisphere(u1, u2)
        if union & _DIFFUSE:
            take(_DIFFUSE, torch.where(entering[:, None], wi_cos, wi_cos * flip_z))
        if LOBE_LAMBERT_T in union:
            take({LOBE_LAMBERT_T}, torch.where(entering[:, None], wi_cos * flip_z, wi_cos))
    if union & {LOBE_MICRO_R, LOBE_MICRO_T}:
        wh = micro_sample_wh(k, dat, wo, u1, u2, dat[:, 9], dat[:, 10], beck)
        if LOBE_MICRO_R in union:
            wi_mr = reflect_dir(wo, wh)
            m = take({LOBE_MICRO_R}, wi_mr)
            valid = valid & (~m | same_hemisphere(wo, wi_mr))
        if LOBE_MICRO_T in union:
            wh_facing = torch.where((dot(wo, wh) < 0)[:, None], -wh, wh)
            ok_mt, wi_mt = refract_dir(wo, wh_facing, eta_ratio)
            m = take({LOBE_MICRO_T}, wi_mt)
            valid = valid & (~m | (ok_mt & ~same_hemisphere(wo, wi_mt)))
    if union & {LOBE_SPEC_R, LOBE_FRESNEL_SPEC}:
        wi_sr = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], dim=-1)
        if LOBE_SPEC_R in union:
            take({LOBE_SPEC_R}, wi_sr)
    if union & {LOBE_SPEC_T, LOBE_FRESNEL_SPEC}:
        n_local = _axis(wo, 2)
        ok_st, wi_st = refract_dir(wo, torch.where(entering[:, None], n_local, -n_local), eta_ratio)
        if LOBE_SPEC_T in union:
            m = take({LOBE_SPEC_T}, wi_st)
            valid = valid & (~m | ok_st)
    if LOBE_FRESNEL_SPEC in union:
        fr_s = fresnel_dielectric(cos_theta(wo), 1.0, eta)
        choose_r = u1 < fr_s
        m = take({LOBE_FRESNEL_SPEC}, torch.where(choose_r[:, None], wi_sr, wi_st))
        valid = valid & ~(m & ~choose_r & ~ok_st)
    if LOBE_CLEARCOAT in union:
        # GTR1 half-vector sampling (disney.rs DisneyClearcoat sample_f)
        a2c = torch.clamp(dat[:, 9], min=1e-3)
        a2c = a2c * a2c
        c2 = torch.where((a2c - 1.0).abs() > 1e-6, (1.0 - torch.pow(a2c, 1.0 - u1)) / (1.0 - a2c), u1)
        cos_h = torch.sqrt(torch.clamp(c2, 0.0, 1.0))
        sin_h = torch.sqrt(torch.clamp(1.0 - c2, min=0.0))
        phi_h = 2.0 * math.pi * u2
        wh_cc = torch.stack([sin_h * torch.cos(phi_h), sin_h * torch.sin(phi_h), cos_h], dim=-1)
        wh_cc = torch.where((wo[:, 2] < 0)[:, None], -wh_cc, wh_cc)
        wi_cc = reflect_dir(wo, wh_cc)
        m = take({LOBE_CLEARCOAT}, wi_cc)
        valid = valid & (~m | same_hemisphere(wo, wi_cc))
    if LOBE_FOURIER in union:
        from .fourier import fourier_sample

        fs_valid = torch.zeros_like(valid)

        def sample(i):
            fs = fourier_sample(lobes["fourier"], dat[i, 12].to(torch.int64), wo[i], u1[i], u2[i], mode)
            fs_valid[i] = fs["valid"]
            return fs["wi"]

        m = take({LOBE_FOURIER}, _on_fourier_lanes(k, torch.zeros_like(wo), sample))
        valid = valid & (~m | fs_valid)
    if LOBE_HAIR in union:
        from .hair import hair_sample

        take({LOBE_HAIR}, hair_sample(dat, wo, u1, u2)["wi"])  # every hair sample is valid
    if LOBE_FRESNEL_BLEND in union:
        # half the samples cosine-weighted, half from the GGX half vector
        fb_diffuse = u1 < 0.5
        u1_fb = torch.where(fb_diffuse, torch.clamp(2.0 * u1, max=1.0 - 1e-6),
                            torch.clamp(2.0 * (u1 - 0.5), max=1.0 - 1e-6))
        wi_cos_fb = cosine_sample_hemisphere(u1_fb, u2)
        wi_cos_fb = torch.where(entering[:, None], wi_cos_fb, wi_cos_fb * flip_z)
        wh_fb = ggx_sample_wh(wo, u1_fb, u2, dat[:, 9], dat[:, 10])
        take({LOBE_FRESNEL_BLEND}, torch.where(fb_diffuse[:, None], wi_cos_fb, reflect_dir(wo, wh_fb)))
    wi = normalize(wi)
    abs_ci = abs_cos_theta(wi)

    # the specular lobes: f and pdf of the delta direction
    if union & SPECULAR_KINDS:
        f_spec = torch.zeros_like(wo)
        pdf_spec = torch.zeros_like(abs_ci)
        ci = torch.clamp(abs_ci, min=1e-9)
        if LOBE_SPEC_R in union:
            m = k == LOBE_SPEC_R
            f_spec = torch.where(m[:, None], color * lobe_fresnel(dat, cos_theta(wo)) / ci[:, None], f_spec)
            pdf_spec = torch.where(m, 1.0, pdf_spec)
        if union & {LOBE_SPEC_T, LOBE_FRESNEL_SPEC}:
            # (eta_i / eta_t)^2, radiance transport only (reflection.rs:703,777)
            st_scale = eta_ratio * eta_ratio if mode == "radiance" else torch.ones_like(eta_ratio)
        if LOBE_SPEC_T in union:
            m = k == LOBE_SPEC_T
            fr_d = fresnel_dielectric(cos_theta(wo), 1.0, eta)
            f_spec = torch.where(m[:, None], color * ((1.0 - fr_d) * st_scale / ci)[:, None], f_spec)
            pdf_spec = torch.where(m, 1.0, pdf_spec)
        if LOBE_FRESNEL_SPEC in union:
            m = k == LOBE_FRESNEL_SPEC
            f_fs_r = color * (fr_s / ci)[:, None]
            f_fs_t = dat[:, 6:9] * ((1.0 - fr_s) * st_scale / ci)[:, None]
            f_spec = torch.where(m[:, None], torch.where(choose_r[:, None], f_fs_r, f_fs_t), f_spec)
            pdf_spec = torch.where(m, torch.where(choose_r, fr_s, 1.0 - fr_s), pdf_spec)
        if n_act_f is not None:
            pdf_spec = pdf_spec / n_act_f
        specular = _of(k, SPECULAR_KINDS, union)
        if specular is None:  # only specular kinds: a lane without a lobe has f = pdf = 0
            specular = k != LOBE_NONE
            f, pdf = f_spec, pdf_spec
    else:
        specular = torch.zeros_like(valid)
    # the non-specular lobes: f and pdf over every lobe
    if union - SPECULAR_KINDS:
        f = bsdf_f(lobes, wo, wi, same_hemisphere(wo, wi), mode)
        pdf = bsdf_pdf(lobes, wo, wi)
        if union & SPECULAR_KINDS:
            f = torch.where(specular[:, None], f_spec, f)
            pdf = torch.where(specular, pdf_spec, pdf)
    # eta scale for Russian roulette (path.rs:166-175)
    if union & (_TRANS | _BOTH):
        transmissive = torch.zeros_like(valid)
        if LOBE_SPEC_T in union:
            transmissive = transmissive | (k == LOBE_SPEC_T)
        if LOBE_FRESNEL_SPEC in union:
            transmissive = transmissive | ((k == LOBE_FRESNEL_SPEC) & ~choose_r)
        if LOBE_MICRO_T in union:
            transmissive = transmissive | ((k == LOBE_MICRO_T) & ~same_hemisphere(wo, wi))
        eta_sc = torch.where(transmissive, torch.where(entering, eta * eta, 1.0 / (eta * eta)), 1.0)
    else:
        eta_sc = torch.ones_like(abs_ci)
    return {
        "wi": wi,
        "f": f,
        "pdf": torch.clamp(pdf, min=0.0),
        "specular": specular,
        "valid": valid & (pdf > 0),
        "eta_scale": eta_sc,
        "abs_cos": abs_ci,
    }
