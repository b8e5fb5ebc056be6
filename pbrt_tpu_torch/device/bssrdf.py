"""The tabulated BSSRDF on the device: the profile's spline, its radial
sampling and the pdfs of the exit point.

The port's counterpart of ``pbrt_tpu/device/bssrdf.py`` (TabulatedBSSRDF,
src/core/bssrdf.rs:271-545): each subsurface material row carries its own
64-knot radial rows (the compiler folds the table's albedo axis per row,
scene/builder.py), so a lookup is a Catmull-Rom spline over one row:

    sss_prof    (M, 3, 64)  profile row per channel (2 pi r Sr)
    sss_cdf     (M, 3, 64)  its running integral (the radial CDF)
    sss_rhoeff  (M, 3)      the CDF's last knot (effective albedo)
    sss_sigma_t (M, 3)      extinction per channel
    sss_radius  (64,)       the optical-radius knots

``sample_radial_cdf`` inverts the radial CDF on the segment that holds the
target with 20 fixed bisection-Newton steps on the quartic; ``pdf_sp`` sums
the pdf over the three projection axes and three channels. The reference
looks up knots by one-hot sums (gather-free on the TPU); here a gather
does, with the same values.
"""
from __future__ import annotations

import math

import torch

from .bsdf import ipow

N_RAD = 64


def fresnel_moment1_dev(eta):
    e = eta
    lo = (0.45966 - 1.73965 * e + 3.37668 * ipow(e, 2) - 3.904945 * ipow(e, 3) + 2.49277 * ipow(e, 4)
          - 0.68441 * ipow(e, 5))
    hi = (-4.61686 + 11.1136 * e - 10.4646 * ipow(e, 2) + 5.11455 * ipow(e, 3) - 1.27198 * ipow(e, 4)
          + 0.12746 * ipow(e, 5))
    return torch.where(e < 1.0, lo, hi)


def _fr_dielectric(cos_i, eta):
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = torch.where(entering, 1.0, eta)
    et = torch.where(entering, eta, 1.0)
    ci = cos_i.abs()
    sin_t = ei / et * torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    tir = sin_t >= 1.0
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_par = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-12)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-12)
    return torch.where(tir, 1.0, 0.5 * (r_par * r_par + r_perp * r_perp))


def sw_factor(eta, cos_w):
    """The directional term Sw (bssrdf.rs:602-607): (1 - Fr(cos)) / (c pi)."""
    c = 1.0 - 2.0 * fresnel_moment1_dev(1.0 / eta)
    return (1.0 - _fr_dielectric(cos_w, eta)) / torch.clamp(c * math.pi, min=1e-6)


def _segment(radius, x):
    """(index of the last knot <= x, clipped to a segment, inside)."""
    n = radius.shape[0]
    inside = (x >= radius[0]) & (x <= radius[-1])
    i = (radius[None, :] <= x[:, None]).sum(1) - 1
    return torch.clamp(i, 0, n - 2), inside


def _row_at(rows, i):
    return rows.gather(1, i[:, None])[:, 0]


def _spline_coeffs(radius, rows, i):
    """Segment i's x0, width, f0, f1, d0, d1 for per-ray rows (R, 64)."""
    n = radius.shape[0]
    x0 = radius[i]
    x1 = radius[i + 1]
    f0 = _row_at(rows, i)
    f1 = _row_at(rows, i + 1)
    width = x1 - x0
    xm1 = radius[torch.clamp(i - 1, min=0)]
    xp2 = radius[torch.clamp(i + 2, max=n - 1)]
    fm1 = _row_at(rows, torch.clamp(i - 1, min=0))
    fp2 = _row_at(rows, torch.clamp(i + 2, max=n - 1))
    d0 = torch.where(i > 0, width * (f1 - fm1) / torch.clamp(x1 - xm1, min=1e-30), f1 - f0)
    d1 = torch.where(i + 2 < n, width * (fp2 - f0) / torch.clamp(xp2 - x0, min=1e-30), f1 - f0)
    return x0, width, f0, f1, d0, d1


def _spline_eval(f0, f1, d0, d1, t):
    t2 = t * t
    t3 = t2 * t
    return ((2 * t3 - 3 * t2 + 1) * f0 + (-2 * t3 + 3 * t2) * f1
            + (t3 - 2 * t2 + t) * d0 + (t3 - t2) * d1)


def eval_profile_row(radius, rows, r_optical):
    """Catmull-Rom interpolation of per-ray rows (R, 64) at r_optical (R,);
    zero outside the knots."""
    i, inside = _segment(radius, r_optical)
    x0, width, f0, f1, d0, d1 = _spline_coeffs(radius, rows, i)
    t = (r_optical - x0) / torch.clamp(width, min=1e-30)
    return torch.where(inside, _spline_eval(f0, f1, d0, d1, t), 0.0)


def sample_radial_cdf(radius, prof_rows, cdf_rows, rho_eff, u):
    """r_optical (R,) with CDF(r) = u rho_eff (interpolation.rs
    sample_catmull_rom_2d on one row): the CDF's segment, then 20
    bisection-Newton steps on the integral of the segment's cubic."""
    target = u * rho_eff
    n = radius.shape[0]
    i = torch.clamp((cdf_rows <= target[:, None]).sum(1) - 1, 0, n - 2)
    x0, width, f0, f1, d0, d1 = _spline_coeffs(radius, prof_rows, i)
    c0 = _row_at(cdf_rows, i)
    ybar = (target - c0) / torch.clamp(width, min=1e-30)

    def cdf_hat(t):
        t2 = t * t
        t3 = t2 * t
        t4 = t2 * t2
        return (f0 * (t - t3 + 0.5 * t4) + f1 * (t3 - 0.5 * t4)
                + d0 * (0.25 * t4 / 1.0 - (2.0 / 3.0) * t3 + 0.5 * t2) + d1 * (0.25 * t4 - t3 / 3.0))

    a = torch.zeros_like(ybar)
    b = torch.ones_like(ybar)
    t = torch.full_like(ybar, 0.5)
    for _ in range(20):
        fh = cdf_hat(t) - ybar
        too_high = fh > 0
        a = torch.where(too_high, a, t)
        b = torch.where(too_high, t, b)
        df = _spline_eval(f0, f1, d0, d1, t)
        tn = t - fh / torch.where(df.abs() > 1e-12, df, 1.0)
        ok = (tn > a) & (tn < b) & (df.abs() > 1e-12)
        t = torch.where(ok, tn, 0.5 * (a + b))
    return x0 + t * width


def pdf_radial(radius, prof_rows, rho_eff, sigma_t_ch, r_world):
    """The pdf of sample_radial in world radius for one channel (bssrdf.rs
    pdf_sr): profile(r_opt) / (2 pi r_opt) sigma_t^2 / rho_eff."""
    r_opt = r_world * sigma_t_ch
    sr = eval_profile_row(radius, prof_rows, r_opt)
    sr = torch.where(r_opt > 1e-9, sr / torch.clamp(2.0 * math.pi * r_opt, min=1e-12), sr)
    return torch.clamp(sr * sigma_t_ch * sigma_t_ch / torch.clamp(rho_eff, min=1e-9), min=0.0)


def sr_eval(radius, prof_rows3, sigma_t3, r_world):
    """The spatial term Sr(r) per channel (bssrdf.rs sr()): prof_rows3
    (R, 3, 64), sigma_t3 (R, 3), r_world (R,) -> (R, 3)."""
    outs = []
    for ch in range(3):
        r_opt = r_world * sigma_t3[:, ch]
        sr = eval_profile_row(radius, prof_rows3[:, ch], r_opt)
        sr = torch.where(r_opt > 1e-9, sr / torch.clamp(2.0 * math.pi * r_opt, min=1e-12), sr)
        outs.append(torch.clamp(sr, min=0.0) * sigma_t3[:, ch] * sigma_t3[:, ch])
    return torch.stack(outs, dim=-1)


def pdf_sp(radius, prof_rows3, rho_eff3, sigma_t3, d_world, n_exit, ss, ts, ns):
    """The exit point's pdf summed over the 3 projection axes (probabilities
    1/4, 1/4, 1/2) and the 3 channels (bssrdf.rs pdf_sp): d_world = po - pi,
    n_exit the exit surface's normal, (ss, ts, ns) the entry frame."""
    dl = torch.stack([(ss * d_world).sum(-1), (ts * d_world).sum(-1), (ns * d_world).sum(-1)], dim=-1)
    nl = torch.stack([(ss * n_exit).sum(-1), (ts * n_exit).sum(-1), (ns * n_exit).sum(-1)], dim=-1)
    r_proj = torch.stack([
        torch.sqrt(ipow(dl[:, 1], 2) + ipow(dl[:, 2], 2)),
        torch.sqrt(ipow(dl[:, 2], 2) + ipow(dl[:, 0], 2)),
        torch.sqrt(ipow(dl[:, 0], 2) + ipow(dl[:, 1], 2)),
    ], dim=-1)
    axis_prob = (0.25, 0.25, 0.5)
    pdf = torch.zeros(d_world.shape[0], dtype=torch.float32, device=d_world.device)
    for axis in range(3):
        for ch in range(3):
            p = pdf_radial(radius, prof_rows3[:, ch], rho_eff3[:, ch], sigma_t3[:, ch], r_proj[:, axis])
            pdf = pdf + p * nl[:, axis].abs() * (1.0 / 3.0) * axis_prob[axis]
    return pdf
