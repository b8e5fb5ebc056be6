"""Tabulated BSSRDF host machinery: photon-beam-diffusion tables.

The port's own copy of ``pbrt_tpu/core/bssrdf.py`` (the port imports nothing
of the reference package), the same float64 NumPy arithmetic in the same
order, so its tables are the reference's bit for bit
(tests/test_torch_bssrdf.py). NumPy re-implementation (vectorized over
the whole table at once) of pbrt's beam-diffusion precompute and
Catmull-Rom spline machinery:
  - fresnel_moment1/2                 (bssrdf.rs:22-56, published fits)
  - beam_diffusion_ms / _ss           (bssrdf.rs:57-135, Habel et al. 2013)
  - compute_beam_diffusion_table      (bssrdf.rs:137-187)
  - subsurface_from_diffuse           (bssrdf.rs:190-201)
  - catmull_rom_weights / integrate_catmull_rom / invert_catmull_rom /
    sample_catmull_rom_2d             (interpolation.rs)

The table layout matches the reference exactly (100 albedo x 64 optical-radius
samples; profile stores 2*pi*r_optical*Sr so the radial CDF integrates it
directly), so the device sampler (device/bssrdf.py) can keep the same
pdf/sample identities.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Fresnel moments (bssrdf.rs:22-56) — polynomial fits from d'Eon & Irving
# ---------------------------------------------------------------------------


def fresnel_moment1(eta: float) -> float:
    e = np.asarray(eta, np.float64)
    lo = 0.45966 - 1.73965 * e + 3.37668 * e**2 - 3.904945 * e**3 + 2.49277 * e**4 - 0.68441 * e**5
    hi = -4.61686 + 11.1136 * e - 10.4646 * e**2 + 5.11455 * e**3 - 1.27198 * e**4 + 0.12746 * e**5
    return float(np.where(e < 1.0, lo, hi))


def fresnel_moment2(eta: float) -> float:
    e = np.asarray(eta, np.float64)
    lo = 0.27614 - 0.87350 * e + 1.12077 * e**2 - 0.65095 * e**3 + 0.07883 * e**4 + 0.04860 * e**5
    r = 1.0 / np.maximum(e, 1e-9)
    hi = (-547.033 + 45.3087 * r**3 - 218.725 * r**2 + 458.843 * r
          + 404.557 * e - 189.519 * e**2 + 54.9327 * e**3 - 9.00603 * e**4 + 0.63942 * e**5)
    return float(np.where(e < 1.0, lo, hi))


def _fr_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel reflectance (reflection.rs fr_dielectric)."""
    cos_i = np.clip(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = np.where(entering, eta_i, eta_t)
    et = np.where(entering, eta_t, eta_i)
    cos_i = np.abs(cos_i)
    sin_t = ei / et * np.sqrt(np.maximum(1.0 - cos_i * cos_i, 0.0))
    tir = sin_t >= 1.0
    cos_t = np.sqrt(np.maximum(1.0 - sin_t * sin_t, 0.0))
    r_par = (et * cos_i - ei * cos_t) / np.maximum(et * cos_i + ei * cos_t, 1e-12)
    r_perp = (ei * cos_i - et * cos_t) / np.maximum(ei * cos_i + et * cos_t, 1e-12)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return np.where(tir, 1.0, fr)


def _phase_hg(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 / (4.0 * np.pi)) * (1.0 - g * g) / np.maximum(denom * np.sqrt(np.maximum(denom, 1e-12)), 1e-12)


# ---------------------------------------------------------------------------
# Photon beam diffusion (bssrdf.rs:57-135) — vectorized over (rho, r) grids
# ---------------------------------------------------------------------------

_N_DEPTH = 100  # depth samples per (rho, r) cell, as in the reference


def beam_diffusion_ms(sigma_s, sigma_a, g, eta, r):
    """Multi-scatter term via the classical dipole over exponentially
    sampled source depths. sigma_s/sigma_a/r broadcast elementwise."""
    sigma_s = np.asarray(sigma_s, np.float64)
    sigma_a = np.asarray(sigma_a, np.float64)
    r = np.asarray(r, np.float64)
    sigmap_s = sigma_s * (1.0 - g)
    sigmap_t = sigma_a + sigmap_s
    rhop = sigmap_s / np.maximum(sigmap_t, 1e-12)
    # non-classical (Grosjean) diffusion coefficient, eq. 15.24
    dg = (2.0 * sigma_a + sigmap_s) / (3.0 * sigmap_t * sigmap_t)
    sigma_tr = np.sqrt(sigma_a / dg)
    fm1 = fresnel_moment1(eta)
    fm2 = fresnel_moment2(eta)
    ze = -2.0 * dg * (1.0 + 3.0 * fm2) / (1.0 - 2.0 * fm1)
    c_phi = 0.25 * (1.0 - 2.0 * fm1)
    c_e = 0.5 * (1.0 - 3.0 * fm2)
    # all depth samples at once: leading axis = depth
    i = (np.arange(_N_DEPTH, dtype=np.float64) + 0.5) / _N_DEPTH
    shape = (_N_DEPTH,) + (1,) * np.ndim(r)
    i = i.reshape(shape)
    zr = -np.log(1.0 - i) / sigmap_t
    zv = -zr + 2.0 * ze
    dr = np.sqrt(r * r + zr * zr)
    dv = np.sqrt(r * r + zv * zv)
    inv4pi = 1.0 / (4.0 * np.pi)
    phi_d = inv4pi / dg * (np.exp(-sigma_tr * dr) / dr - np.exp(-sigma_tr * dv) / dv)
    e_dn = inv4pi * (zr * (1.0 + sigma_tr * dr) * np.exp(-sigma_tr * dr) / dr**3
                     - zv * (1.0 + sigma_tr * dv) * np.exp(-sigma_tr * dv) / dv**3)
    e = phi_d * c_phi + e_dn * c_e
    kappa = 1.0 - np.exp(-2.0 * sigmap_t * (dr + zr))
    return np.mean(kappa * rhop * rhop * e, axis=0)


def beam_diffusion_ss(sigma_s, sigma_a, g, eta, r):
    """Single-scatter term along the refracted beam (bssrdf.rs:112-135)."""
    sigma_s = np.asarray(sigma_s, np.float64)
    sigma_a = np.asarray(sigma_a, np.float64)
    r = np.asarray(r, np.float64)
    sigma_t = sigma_a + sigma_s
    rho = sigma_s / np.maximum(sigma_t, 1e-12)
    t_crit = r * np.sqrt(max(eta * eta - 1.0, 0.0))
    i = (np.arange(_N_DEPTH, dtype=np.float64) + 0.5) / _N_DEPTH
    shape = (_N_DEPTH,) + (1,) * np.ndim(r)
    i = i.reshape(shape)
    ti = t_crit - np.log(1.0 - i) / sigma_t
    d = np.sqrt(r * r + ti * ti)
    cos_to = ti / np.maximum(d, 1e-12)
    ess = (rho * np.exp(-sigma_t * (d + t_crit)) / np.maximum(d * d, 1e-12)
           * _phase_hg(cos_to, g)
           * (1.0 - _fr_dielectric(-cos_to, 1.0, eta))
           * np.abs(cos_to))
    return np.mean(ess, axis=0)


# ---------------------------------------------------------------------------
# Catmull-Rom spline machinery (interpolation.rs)
# ---------------------------------------------------------------------------


def catmull_rom_weights(nodes: np.ndarray, x):
    """Spline basis: returns (offset, w) with w shape (..., 4); zero weights
    when x is outside the node range (interpolation.rs catmull_rom_weights).
    The four weights apply to f[offset .. offset+3]."""
    nodes = np.asarray(nodes, np.float64)
    x = np.asarray(x, np.float64)
    n = len(nodes)
    inside = (x >= nodes[0]) & (x <= nodes[-1])
    i = np.clip(np.searchsorted(nodes, x, side="right") - 1, 0, n - 2)
    x0 = nodes[i]
    x1 = nodes[i + 1]
    t = (x - x0) / np.maximum(x1 - x0, 1e-30)
    t2 = t * t
    t3 = t2 * t
    w1 = 2.0 * t3 - 3.0 * t2 + 1.0
    w2 = -2.0 * t3 + 3.0 * t2
    has_prev = i > 0
    has_next = i + 2 < n
    t3m2t2pt = t3 - 2.0 * t2 + t
    t3mt2 = t3 - t2
    # left derivative: central difference when a previous node exists,
    # folded one-sided difference otherwise
    w0p = t3m2t2pt * (x1 - x0) / np.where(has_prev, nodes[np.maximum(i - 1, 0)] * 0 + (x1 - nodes[np.maximum(i - 1, 0)]), 1.0)
    w0 = np.where(has_prev, -w0p, 0.0)
    w2 = w2 + np.where(has_prev, w0p, t3m2t2pt)
    w1 = w1 + np.where(has_prev, 0.0, -t3m2t2pt)
    # right derivative
    w3p = t3mt2 * (x1 - x0) / np.where(has_next, nodes[np.minimum(i + 2, n - 1)] - x0, 1.0)
    w3 = np.where(has_next, w3p, 0.0)
    w1 = w1 + np.where(has_next, -w3p, -t3mt2)
    w2 = w2 + np.where(has_next, 0.0, t3mt2)
    w = np.stack([w0, w1, w2, w3], axis=-1)
    offset = i - 1
    w = np.where(inside[..., None], w, 0.0)
    offset = np.where(inside, offset, 0)
    return offset, w


def integrate_catmull_rom(nodes: np.ndarray, f: np.ndarray):
    """Definite integral of the spline through (nodes, f) and its running
    CDF at the nodes. f: (..., n). Returns (integral (...), cdf (..., n))."""
    nodes = np.asarray(nodes, np.float64)
    f = np.asarray(f, np.float64)
    n = len(nodes)
    width = nodes[1:] - nodes[:-1]  # (n-1,)
    f0 = f[..., :-1]
    f1 = f[..., 1:]
    # derivative estimates (one-sided at the ends)
    prev_w = np.empty(n - 1)
    prev_w[0] = nodes[1] - nodes[0]
    prev_w[1:] = nodes[2:] - nodes[:-2]
    next_w = np.empty(n - 1)
    next_w[:-1] = nodes[2:] - nodes[:-2]
    next_w[-1] = nodes[-1] - nodes[-2]
    fprev = np.concatenate([f[..., :1], f[..., :-2]], axis=-1)
    fnext = np.concatenate([f[..., 2:], f[..., -1:]], axis=-1)
    d0 = width * (f1 - fprev) / prev_w
    d1 = width * (fnext - f0) / next_w
    seg = width * ((f0 + f1) * 0.5 + (d0 - d1) * (1.0 / 12.0))
    cdf = np.concatenate([np.zeros(f.shape[:-1] + (1,)), np.cumsum(seg, axis=-1)], axis=-1)
    return cdf[..., -1].copy(), cdf


def invert_catmull_rom(nodes: np.ndarray, f: np.ndarray, y):
    """Solve f(x) = y for x on a monotone spline (interpolation.rs
    invert_catmull_rom), via bisection+Newton on the containing segment."""
    nodes = np.asarray(nodes, np.float64)
    f = np.asarray(f, np.float64)
    y = np.asarray(y, np.float64)
    n = len(nodes)
    y_cl = np.clip(y, f[0], f[-1])
    i = np.clip(np.searchsorted(f, y_cl, side="right") - 1, 0, n - 2)
    x0 = nodes[i]
    x1 = nodes[i + 1]
    f0 = f[i]
    f1 = f[i + 1]
    width = x1 - x0
    has_prev = i > 0
    has_next = i + 2 < n
    d0 = np.where(has_prev, width * (f1 - f[np.maximum(i - 1, 0)]) /
                  (x1 - nodes[np.maximum(i - 1, 0)]), f1 - f0)
    d1 = np.where(has_next, width * (f[np.minimum(i + 2, n - 1)] - f0) /
                  (nodes[np.minimum(i + 2, n - 1)] - x0), f1 - f0)
    # Newton with bisection safeguard on t in [0, 1]
    a = np.zeros_like(y_cl)
    b = np.ones_like(y_cl)
    t = 0.5 * np.ones_like(y_cl)
    for _ in range(30):
        t2 = t * t
        t3 = t2 * t
        fhat = ((2 * t3 - 3 * t2 + 1) * f0 + (-2 * t3 + 3 * t2) * f1
                + (t3 - 2 * t2 + t) * d0 + (t3 - t2) * d1)
        dfhat = ((6 * t2 - 6 * t) * f0 + (-6 * t2 + 6 * t) * f1
                 + (3 * t2 - 4 * t + 1) * d0 + (3 * t2 - 2 * t) * d1)
        too_high = fhat > y_cl
        a = np.where(too_high, a, t)
        b = np.where(too_high, t, b)
        t_newton = t - (fhat - y_cl) / np.where(np.abs(dfhat) > 1e-12, dfhat, 1.0)
        ok = (t_newton > a) & (t_newton < b) & (np.abs(dfhat) > 1e-12)
        t = np.where(ok, t_newton, 0.5 * (a + b))
    return x0 + t * width


# ---------------------------------------------------------------------------
# Table build (bssrdf.rs:137-187)
# ---------------------------------------------------------------------------

N_RHO = 100
N_RADIUS = 64


def compute_beam_diffusion_table(g: float, eta: float,
                                 n_rho: int = N_RHO, n_radius: int = N_RADIUS) -> dict:
    """Precompute the (albedo x optical radius) diffusion profile table.

    Returns dict of float32 arrays:
      rho_samples (n_rho,), radius_samples (n_radius,),
      profile (n_rho, n_radius)  [= 2*pi*r*(Ess + Ems)],
      rho_eff (n_rho,), profile_cdf (n_rho, n_radius).
    """
    radius = np.zeros(n_radius)
    radius[1] = 2.5e-3
    for j in range(2, n_radius):
        radius[j] = radius[j - 1] * 1.2
    k = np.arange(n_rho, dtype=np.float64)
    rho = (1.0 - np.exp(-8.0 * k / (n_rho - 1))) / (1.0 - np.exp(-8.0))

    rr = rho[:, None]
    rj = radius[None, :]
    profile = 2.0 * np.pi * rj * (
        beam_diffusion_ss(rr, 1.0 - rr, g, eta, rj)
        + beam_diffusion_ms(rr, 1.0 - rr, g, eta, rj)
    )
    rho_eff, cdf = integrate_catmull_rom(radius, profile)
    return {
        "rho_samples": rho.astype(np.float32),
        "radius_samples": radius.astype(np.float32),
        "profile": profile.astype(np.float32),
        "rho_eff": rho_eff.astype(np.float32),
        "profile_cdf": cdf.astype(np.float32),
        "g": float(g),
        "eta": float(eta),
    }


def subsurface_from_diffuse(table: dict, rho_eff_target, mfp):
    """Invert the effective-albedo mapping: given a desired diffuse
    reflectance and mean free path, return (sigma_a, sigma_s) per channel
    (bssrdf.rs:190-201)."""
    rho_eff_target = np.asarray(rho_eff_target, np.float64)
    mfp = np.asarray(mfp, np.float64)
    rho = invert_catmull_rom(table["rho_samples"].astype(np.float64),
                             table["rho_eff"].astype(np.float64), rho_eff_target)
    sigma_s = rho / np.maximum(mfp, 1e-12)
    sigma_a = (1.0 - rho) / np.maximum(mfp, 1e-12)
    return sigma_a.astype(np.float32), sigma_s.astype(np.float32)
