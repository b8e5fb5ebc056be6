"""Hair fiber BSDF: the Marschner / d'Eon four-lobe model.

The port's counterpart of ``pbrt_tpu/device/hair.py`` (src/materials/
hair.rs HairBSDF): longitudinal Mp terms in the modified-Bessel form,
azimuthal trimmed-logistic Np terms, Fresnel and absorption attenuation Ap
for p = R, TT, TRT and the residual lobe, and the scales' tilt by the
2^k alpha double angles. Every formula is straight-line over the batch:
the per-p loop is unrolled (PMAX = 3), the angle wrap is a modulo, Bessel
I0 is a 10-term series. Integer powers are products in the order XLA
forms them (bsdf.ipow), so the float32 results follow the reference's.

Frame: z = shading normal, x = dpdu = the fiber tangent, so sin_theta =
w.x and the azimuth lives in (y, z), as in the reference.

Data slots of a LOBE_HAIR lobe (materials._lobes):
  0:3 sigma_a   3 eta   9 beta_m   10 beta_n   12 alpha (degrees)   13 h

As in the reference, every lobe's Mp takes its own v[p] in f, pdf and
sample alike (hair.rs's pdf() uses v[PMAX] for all of them, :478-533).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .bsdf import fresnel_dielectric, ipow

PMAX = 3
SQRT_PI_OVER8 = 0.626657069
_LUM = (0.2126, 0.7152, 0.0722)
# log(2 pi) as the reference forms it: the log of the float32 constant
_LOG_2PI = float(np.log(np.float32(2.0 * math.pi)))
_DEG = float(np.float32(math.pi / 180.0))


def _sqr(x):
    return x * x


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def _safe_asin(x):
    return torch.arcsin(torch.clamp(x, -1.0, 1.0))


def _i0(x):
    """Modified Bessel I0, 10-term power series (hair.rs:37-52)."""
    x2 = x * x
    val = torch.ones_like(x)
    term = torch.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(1, 10):
        ifact *= i
        i4 *= 4.0
        term = term * x2
        val = val + term / (i4 * ifact * ifact)
    return val


def _log_i0(x):
    big = x + 0.5 * (-_LOG_2PI + torch.log(1.0 / torch.clamp(x, min=1e-6)) + 1.0 / (8.0 * torch.clamp(x, min=1e-6)))
    return torch.where(x > 12.0, big, torch.log(torch.clamp(_i0(torch.clamp(x, max=12.0)), min=1e-30)))


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering (hair.rs:20-34); v per lane."""
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small = v <= 0.1
    # small v: the exp/log form keeps sinh(1/v) from overflowing
    m_small = torch.exp(_log_i0(a) - b - 1.0 / v + 0.6931 + torch.log(1.0 / (2.0 * v)))
    v_big = torch.clamp(v, min=0.1)
    m_big = torch.exp(-b) * _i0(torch.where(small, 0.0, a)) / (torch.sinh(1.0 / v_big) * 2.0 * v_big)
    return torch.where(small, m_small, m_big)


def _logistic(x, s):
    x = x.abs()
    e = torch.exp(-x / s)
    return e / (s * _sqr(1.0 + e))


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * torch.log(torch.clamp(1.0 / torch.clamp(u * k + _logistic_cdf(a, s), min=1e-9) - 1.0, min=1e-9))
    return torch.clamp(x, a, b)


def _phi_p(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * math.pi


def _mod(x, y):
    """jnp.mod: the remainder with the divisor's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _np(phi, p, s, gamma_o, gamma_t):
    dphi = phi - _phi_p(p, gamma_o, gamma_t)
    dphi = _mod(dphi + math.pi, 2.0 * math.pi) - math.pi
    return _trimmed_logistic(dphi, s, -math.pi, math.pi)


def _unpack(data):
    sigma_a = torch.clamp(data[..., 0:3], min=0.0)
    eta = torch.clamp(data[..., 3], min=1.0 + 1e-4)
    beta_m = torch.clamp(data[..., 9], 0.0, 1.0)
    beta_n = torch.clamp(data[..., 10], 1e-3, 1.0)
    alpha = data[..., 12]
    h = torch.clamp(data[..., 13], -1.0 + 1e-5, 1.0 - 1e-5)
    # the lobes' longitudinal variances (hair.rs:220-227)
    v0 = torch.clamp(_sqr(0.726 * beta_m + 0.812 * _sqr(beta_m) + 3.7 * ipow(beta_m, 20)), min=1e-5)
    v = (v0, 0.25 * v0, 4.0 * v0, 4.0 * v0)
    # the azimuthal logistic scale (hair.rs:230)
    s = torch.clamp(SQRT_PI_OVER8 * (0.265 * beta_n + 1.194 * _sqr(beta_n) + 5.372 * ipow(beta_n, 22)), min=1e-4)
    # the 2^k alpha double angles (hair.rs:233-239)
    a_rad = alpha * _DEG
    s0, c0 = torch.sin(a_rad), torch.cos(a_rad)
    s1, c1 = 2.0 * c0 * s0, _sqr(c0) - _sqr(s0)
    s2, c2 = 2.0 * c1 * s1, _sqr(c1) - _sqr(s1)
    return sigma_a, eta, h, v, s, ((s0, c0), (s1, c1), (s2, c2))


def _geo(eta, h, sigma_a, wo):
    """The refraction geometry and one pass's transmittance."""
    sin_to = torch.clamp(wo[..., 0], -1.0, 1.0)
    cos_to = _safe_sqrt(1.0 - _sqr(sin_to))
    phi_o = torch.atan2(wo[..., 2], wo[..., 1])
    sin_tt = sin_to / eta
    cos_tt = _safe_sqrt(1.0 - _sqr(sin_tt))
    etap = _safe_sqrt(_sqr(eta) - _sqr(sin_to)) / torch.clamp(cos_to, min=1e-6)
    sin_gt = h / torch.clamp(etap, min=1e-6)
    cos_gt = _safe_sqrt(1.0 - _sqr(sin_gt))
    gamma_t = _safe_asin(sin_gt)
    gamma_o = _safe_asin(h)
    t_span = torch.exp(-sigma_a * (2.0 * cos_gt / torch.clamp(cos_tt, min=1e-6))[..., None])
    return sin_to, cos_to, phi_o, gamma_o, gamma_t, t_span


def _ap(cos_to, eta, h, t_span):
    """Attenuation of the lobes R, TT, TRT and the residual, each (R, 3)
    (hair.rs:63-84)."""
    cos_go = _safe_sqrt(1.0 - _sqr(h))
    f = fresnel_dielectric(cos_to * cos_go, 1.0, eta)[..., None]
    a0 = f.expand(t_span.shape)
    a1 = t_span * _sqr(1.0 - f)
    a2 = a1 * t_span * f
    a3 = a2 * t_span * f / torch.clamp(1.0 - t_span * f, min=1e-4)
    return a0, a1, a2, a3


def _tilted(p, sin_to, cos_to, sc):
    """wo's inclination tilted by the scales for lobe p (hair.rs:344-360)."""
    (s0, c0), (s1, c1), (s2, c2) = sc
    if p == 0:
        return sin_to * c1 - cos_to * s1, (cos_to * c1 + sin_to * s1).abs()
    if p == 1:
        return sin_to * c0 + cos_to * s0, (cos_to * c0 - sin_to * s0).abs()
    if p == 2:
        return sin_to * c2 + cos_to * s2, (cos_to * c2 - sin_to * s2).abs()
    return sin_to, cos_to


def _incident(wi):
    sin_ti = torch.clamp(wi[..., 0], -1.0, 1.0)
    return sin_ti, _safe_sqrt(1.0 - _sqr(sin_ti)), torch.atan2(wi[..., 2], wi[..., 1])


def hair_f(data, wo, wi):
    """The BSDF's value (R, 3) (hair.rs f() :310-376)."""
    sigma_a, eta, h, v, s, sc = _unpack(data)
    sin_to, cos_to, phi_o, gamma_o, gamma_t, t_span = _geo(eta, h, sigma_a, wo)
    sin_ti, cos_ti, phi_i = _incident(wi)
    phi = phi_i - phi_o
    ap = _ap(cos_to, eta, h, t_span)
    fsum = torch.zeros_like(t_span)
    for p in range(PMAX):
        sin_op, cos_op = _tilted(p, sin_to, cos_to, sc)
        m = _mp(cos_ti, cos_op, sin_ti, sin_op, v[p])
        n = _np(phi, float(p), s, gamma_o, gamma_t)
        fsum = fsum + ap[p] * (m * n)[..., None]
    m_last = _mp(cos_ti, cos_to, sin_ti, sin_to, v[PMAX])
    fsum = fsum + ap[PMAX] * (m_last / (2.0 * math.pi))[..., None]
    abs_cos = wi[..., 2].abs()
    return torch.where((abs_cos > 1e-6)[..., None], fsum / torch.clamp(abs_cos, min=1e-6)[..., None], fsum)


def _ap_pdf(cos_to, eta, h, t_span):
    ys = [torch.clamp(a[..., 0] * _LUM[0] + a[..., 1] * _LUM[1] + a[..., 2] * _LUM[2], min=0.0)
          for a in _ap(cos_to, eta, h, t_span)]
    total = torch.clamp(ys[0] + ys[1] + ys[2] + ys[3], min=1e-9)
    return [y / total for y in ys]


def hair_pdf(data, wo, wi):
    """Solid-angle pdf of hair_sample (hair.rs pdf() :478-533, v[p])."""
    sigma_a, eta, h, v, s, sc = _unpack(data)
    sin_to, cos_to, phi_o, gamma_o, gamma_t, t_span = _geo(eta, h, sigma_a, wo)
    sin_ti, cos_ti, phi_i = _incident(wi)
    phi = phi_i - phi_o
    apf = _ap_pdf(cos_to, eta, h, t_span)
    pdf = torch.zeros_like(cos_to)
    for p in range(PMAX):
        sin_op, cos_op = _tilted(p, sin_to, cos_to, sc)
        pdf = pdf + _mp(cos_ti, cos_op, sin_ti, sin_op, v[p]) * apf[p] * _np(phi, float(p), s, gamma_o, gamma_t)
    return pdf + _mp(cos_ti, cos_to, sin_ti, sin_to, v[PMAX]) * apf[PMAX] / (2.0 * math.pi)


def _demux(u):
    """Two uniforms from one: its high and low 12 bits (in place of
    hair.rs's Morton demux_float :591-601, as the reference)."""
    x = u * 4096.0
    hi = torch.floor(x)
    return hi / 4096.0, torch.clamp(x - hi, 0.0, 1.0 - 1e-6)


def hair_sample(data, wo, u1, u2):
    """Sample the hair BSDF (hair.rs sample_f() :378-476). Returns {wi,
    valid}; bsdf.bsdf_sample evaluates f and pdf with hair_f and hair_pdf,
    which match this sampler."""
    sigma_a, eta, h, v, s, sc = _unpack(data)
    sin_to, cos_to, phi_o, gamma_o, gamma_t, t_span = _geo(eta, h, sigma_a, wo)
    u00, u01 = _demux(u1)
    u10, u11 = _demux(u2)
    apf = _ap_pdf(cos_to, eta, h, t_span)
    # the lobe, chosen by its attenuation weight
    c0 = apf[0]
    c1 = c0 + apf[1]
    c2 = c1 + apf[2]
    p_idx = (u00 >= c0).to(torch.int64) + (u00 >= c1).to(torch.int64) + (u00 >= c2).to(torch.int64)
    sin_op = torch.zeros_like(sin_to)
    cos_op = torch.zeros_like(cos_to)
    vp = torch.zeros_like(sin_to)
    for p in range(PMAX + 1):
        so, co = _tilted(p, sin_to, cos_to, sc)
        m = p_idx == p
        sin_op = torch.where(m, so, sin_op)
        cos_op = torch.where(m, co, cos_op)
        vp = torch.where(m, v[p], vp)
    # longitudinal (hair.rs:421-428)
    u10 = torch.clamp(u10, min=1e-5)
    cos_theta = 1.0 + vp * torch.log(torch.clamp(u10 + (1.0 - u10) * torch.exp(-2.0 / vp), min=1e-30))
    sin_theta = _safe_sqrt(1.0 - _sqr(cos_theta))
    cos_phi_l = torch.cos(2.0 * math.pi * u11)
    sin_ti = -cos_theta * sin_op + sin_theta * cos_phi_l * cos_op
    cos_ti = _safe_sqrt(1.0 - _sqr(sin_ti))
    # azimuthal (hair.rs:431-439)
    dphi_smooth = _phi_p(p_idx.to(torch.float32), gamma_o, gamma_t) + _sample_trimmed_logistic(
        u01, s, -math.pi, math.pi)
    phi_i = phi_o + torch.where(p_idx < PMAX, dphi_smooth, 2.0 * math.pi * u01)
    wi = torch.stack([sin_ti, cos_ti * torch.cos(phi_i), cos_ti * torch.sin(phi_i)], dim=-1)
    return {"wi": wi, "valid": torch.ones_like(u1, dtype=torch.bool)}
