"""Tabulated (Fourier) BSDF: evaluation, pdf and sampling of measured
Fourier tables.

The port's counterpart of ``pbrt_tpu/device/fourier.py`` (src/core/
reflection.rs:1237-1485 FourierBSDF f, sample_f and pdf; src/core/
interpolation.rs catmull_rom_weights, sample_catmull_rom_2d, fourier,
sample_fourier), with the reference's arithmetic:

- the ragged coefficient runs are dense (core/fourierbsdf.py), so a lookup
  is a row of uniform width: 16 rows of the 4x4 spline stencil, plain
  indexing;
- the azimuthal series sum_k a_k cos(k phi) is a (R, MCAP) basis
  contraction;
- both Newton-bisection inversions (the mu_i spline CDF and the phi Fourier
  CDF) are Python loops of a fixed number of steps over the whole batch,
  with converged lanes kept in their bracket by masks: no data-dependent
  exit, so every lane takes the reference's steps.

Every entry point takes ``ft``, the stacked tables (SceneTensors.fourier):
mu (NT, NMU), aflat (NT, NMU * NMU, 3 MCAP), a0 and cdf (NT, NMU, NMU),
eta (NT,); and ``tid``, each lane's table id.
"""
from __future__ import annotations

import math

import torch

INV_2PI = 0.5 / math.pi
_N_NEWTON = 16


def _sel(rows, i):
    """rows[r, i[r]]."""
    return rows.gather(-1, i[:, None])[:, 0]


def _table_rows(ft, name, tid):
    """ft[name][tid], or the one table's block (no gather) when the scene
    has a single table."""
    arr = ft[name]
    return arr[0] if arr.shape[0] == 1 else arr[tid]


def catmull_rom_weights(mu, x):
    """catmull_rom_weights (interpolation.rs:3-50) per lane. mu: (NMU,) or
    (R, NMU) node positions; x: (R,). Returns (offset (R,) int64, weights
    (R, 4), valid (R,) bool)."""
    mu_b = (mu[None, :] if mu.dim() == 1 else mu).expand(x.shape[0], mu.shape[-1])
    nmu = mu_b.shape[-1]
    valid = (x >= mu_b[:, 0]) & (x < mu_b[:, -1])
    idx = torch.clamp((mu_b <= x[:, None]).sum(-1) - 1, 0, nmu - 2)
    x0 = _sel(mu_b, idx)
    x1 = _sel(mu_b, idx + 1)
    xm1 = _sel(mu_b, torch.clamp(idx - 1, min=0))
    xp2 = _sel(mu_b, torch.clamp(idx + 2, max=nmu - 1))
    t = (x - x0) / torch.clamp(x1 - x0, min=1e-12)
    t2 = t * t
    t3 = t2 * t
    w1 = 2.0 * t3 - 3.0 * t2 + 1.0
    w2 = -2.0 * t3 + 3.0 * t2
    w0raw = t3 - 2.0 * t2 + t
    has_prev = idx > 0
    w0v = torch.where(has_prev, w0raw * (x1 - x0) / torch.clamp(x1 - xm1, min=1e-12), w0raw)
    w0 = torch.where(has_prev, -w0v, 0.0)
    w1 = w1 - torch.where(has_prev, 0.0, w0v)
    w2 = w2 + w0v
    w3raw = t3 - t2
    has_next = idx + 2 < nmu
    w3v = torch.where(has_next, w3raw * (x1 - x0) / torch.clamp(xp2 - x0, min=1e-12), w3raw)
    w1 = w1 - w3v
    w3 = torch.where(has_next, w3v, 0.0)
    w2 = w2 + torch.where(has_next, 0.0, w3v)
    weights = torch.stack([w0, w1, w2, w3], dim=-1)
    return idx - 1, torch.where(valid[:, None], weights, 0.0), valid


def _accumulate_ak(ft, tid, offi, wi4, offo, wo4):
    """The 16-tap spline stencil of coefficient rows: ak (R, 3, MCAP) =
    sum over (b, a) of wi4[a] wo4[b] A[(offo + b) NMU + offi + a]."""
    nmu = ft["mu"].shape[-1]
    aflat = ft["aflat"]
    n_rows = aflat.shape[1]
    single = aflat.shape[0] == 1
    ak = torch.zeros((offi.shape[0], aflat.shape[-1]), dtype=torch.float32, device=offi.device)
    for b in range(4):
        for a in range(4):
            w = wi4[:, a] * wo4[:, b]
            flat = torch.clamp((offo + b) * nmu + (offi + a), 0, n_rows - 1)
            rows = aflat[0][flat] if single else aflat[tid, flat]
            ak = ak + torch.where((w != 0.0)[:, None], w[:, None] * rows, 0.0)
    return ak.reshape(ak.shape[0], 3, aflat.shape[-1] // 3)


def _series_all(ak, cos_phi):
    """Y, R and B of the Fourier series at the azimuth difference with
    cosine cos_phi: the cos(k arccos(x)) basis, three contractions."""
    mcap = ak.shape[-1]
    phi = torch.arccos(torch.clamp(cos_phi, -1.0, 1.0))
    basis = torch.cos(phi[:, None] * torch.arange(mcap, dtype=torch.float32, device=ak.device)[None, :])
    return tuple((ak[:, c] * basis).sum(-1) for c in range(3))


def _cos_d_phi(wa, wb):
    """cos of the azimuth difference of wa and wb (geometry.rs cos_d_phi)."""
    waxy = wa[:, 0] * wa[:, 0] + wa[:, 1] * wa[:, 1]
    wbxy = wb[:, 0] * wb[:, 0] + wb[:, 1] * wb[:, 1]
    num = wa[:, 0] * wb[:, 0] + wa[:, 1] * wb[:, 1]
    den = torch.sqrt(torch.clamp(waxy * wbxy, min=1e-20))
    return torch.where((waxy > 1e-12) & (wbxy > 1e-12), torch.clamp(num / den, -1.0, 1.0), 1.0)


def _weights_io(ft, tid, wo, wi):
    mui = -wi[:, 2]  # cos_theta(-wi), the table's convention
    muo = wo[:, 2]
    mu = _table_rows(ft, "mu", tid)
    offi, wi4, vi = catmull_rom_weights(mu, mui)
    offo, wo4, vo = catmull_rom_weights(mu, muo)
    return mui, muo, offi, wi4, offo, wo4, vi & vo


def _rgb_from_series(y, r, b, scale):
    g = 1.39829 * y - 0.100913 * b - 0.297375 * r
    return torch.clamp(torch.stack([r, g, b], dim=-1) * scale[:, None], min=0.0)


def _radiance_scale(ft, tid, mui, muo, mode: str = "radiance"):
    """1/|mui| and, on transmission, radiance transport's eta^2 factor
    (reflection.rs:1301-1316); importance transport keeps the bare 1/|mui|."""
    scale = torch.where(mui.abs() > 1e-9, 1.0 / torch.clamp(mui.abs(), min=1e-9), 0.0)
    if mode != "radiance":
        return scale
    eta = _table_rows(ft, "eta", tid).expand(mui.shape)
    ef = torch.where(mui > 0, 1.0 / torch.clamp(eta, min=1e-6), eta)
    return torch.where(mui * muo > 0, scale * ef * ef, scale)


def fourier_f(ft, tid, wo, wi, mode: str = "radiance"):
    """The tabulated BSDF's value (R, 3) (reflection.rs f()) in transport
    mode `mode`."""
    mui, muo, offi, wi4, offo, wo4, valid = _weights_io(ft, tid, wo, wi)
    ak = _accumulate_ak(ft, tid, offi, wi4, offo, wo4)
    y, r, b = _series_all(ak, _cos_d_phi(-wi, wo))
    rgb = _rgb_from_series(torch.clamp(y, min=0.0), r, b, _radiance_scale(ft, tid, mui, muo, mode))
    return torch.where(valid[:, None], rgb, 0.0)


def fourier_pdf(ft, tid, wo, wi):
    """Solid-angle pdf of fourier_sample (reflection.rs pdf()): the
    luminance series over the spline-interpolated albedo rho."""
    mui, muo, offi, wi4, offo, wo4, valid = _weights_io(ft, tid, wo, wi)
    ak = _accumulate_ak(ft, tid, offi, wi4, offo, wo4)
    y = _series_all(ak, _cos_d_phi(-wi, wo))[0]
    cdf = _table_rows(ft, "cdf", tid)  # rows [o, i]
    nmu = ft["mu"].shape[-1]
    last = cdf[..., nmu - 1]  # each mu_o row's albedo integral
    last = (last[None, :] if last.dim() == 1 else last).expand(wo.shape[0], nmu)
    rho = torch.zeros(wo.shape[0], dtype=torch.float32, device=wo.device)
    for b in range(4):
        rho = rho + wo4[:, b] * _sel(last, torch.clamp(offo + b, 0, nmu - 1)) * (2.0 * math.pi)
    ok = valid & (rho > 0) & (y > 0)
    return torch.where(ok, y / torch.clamp(rho, min=1e-12), 0.0)


def _spline_fh(f0, f1, d0, d1, t):
    return f0 + t * (d0 + t * (-2.0 * d0 - d1 + 3.0 * (f1 - f0) + t * (d0 + d1 + 2.0 * (f0 - f1))))


def _spline_invert(f0, f1, d0, d1, u):
    """Newton-bisection inverting the integral of a cubic spline segment,
    _N_NEWTON steps (interpolation.rs sample_catmull_rom_2d's inner loop).
    Returns (t, fhat)."""
    a = torch.zeros_like(u)
    b = torch.ones_like(u)
    # the linear interpolant's inverse as the first guess, as the reference
    lin = (f0 - f1).abs() > 1e-9
    disc = torch.clamp(f0 * f0 + 2.0 * u * (f1 - f0), min=0.0)
    t = torch.where(lin, (f0 - torch.sqrt(disc)) / torch.where(lin, f0 - f1, 1.0), u / torch.clamp(f0, min=1e-9))
    t = torch.clamp(t, 0.0, 1.0)
    for _ in range(_N_NEWTON):
        t = torch.where((t > a) & (t < b), t, 0.5 * (a + b))
        fh_int = t * (f0 + t * (0.5 * d0 + t * ((1.0 / 3.0) * (-2.0 * d0 - d1) + f1 - f0
                                               + t * (0.25 * (d0 + d1) + 0.5 * (f0 - f1)))))
        fh = _spline_fh(f0, f1, d0, d1, t)
        err = fh_int - u
        below = err < 0
        a = torch.where(below, t, a)
        b = torch.where(below, b, t)
        t = t - err / torch.where(fh.abs() > 1e-12, fh, 1.0)
    t = torch.minimum(torch.maximum(t, a), b)
    return t, _spline_fh(f0, f1, d0, d1, t)


def _sample_mui(ft, tid, offo, wo4, u):
    """sample_catmull_rom_2d over the mu_i marginal (interpolation.rs:134)."""
    nmu = ft["mu"].shape[-1]
    mu = _table_rows(ft, "mu", tid)
    mu_b = (mu[None, :] if mu.dim() == 1 else mu).expand(u.shape[0], nmu)
    cdf_t, a0_t = ft["cdf"], ft["a0"]
    single = cdf_t.shape[0] == 1
    C = torch.zeros((u.shape[0], nmu), dtype=torch.float32, device=u.device)
    V = torch.zeros_like(C)
    for b in range(4):
        row = torch.clamp(offo + b, 0, nmu - 1)
        crow = cdf_t[0][row] if single else cdf_t[tid, row]
        vrow = a0_t[0][row] if single else a0_t[tid, row]
        C = C + wo4[:, b:b + 1] * crow
        V = V + wo4[:, b:b + 1] * vrow
    maximum = C[:, -1]
    uu = u * maximum
    idx = torch.clamp((C <= uu[:, None]).sum(-1) - 1, 0, nmu - 2)
    f0 = _sel(V, idx)
    f1 = _sel(V, idx + 1)
    x0 = _sel(mu_b, idx)
    x1 = _sel(mu_b, idx + 1)
    im1 = torch.clamp(idx - 1, min=0)
    ip2 = torch.clamp(idx + 2, max=nmu - 1)
    xm1, xp2 = _sel(mu_b, im1), _sel(mu_b, ip2)
    fm1, fp2 = _sel(V, im1), _sel(V, ip2)
    width = x1 - x0
    d0 = torch.where(idx > 0, width * (f1 - fm1) / torch.clamp(x1 - xm1, min=1e-12), f1 - f0)
    d1 = torch.where(idx + 2 < nmu, width * (fp2 - f0) / torch.clamp(xp2 - x0, min=1e-12), f1 - f0)
    u_seg = (uu - _sel(C, idx)) / torch.clamp(width, min=1e-12)
    t, fh = _spline_invert(f0, f1, d0, d1, u_seg)
    pdf_mu = torch.where(maximum > 0, torch.clamp(fh, min=0.0) / torch.clamp(maximum, min=1e-12), 0.0)
    return x0 + width * t, pdf_mu


def _sample_phi(ak_y, u):
    """sample_fourier (interpolation.rs:354): invert the azimuthal CDF
    F(phi) = a0 phi + sum_k a_k sin(k phi) / k by Newton-bisection,
    _N_NEWTON + 4 steps. Returns (phi, pdf_phi)."""
    mcap = ak_y.shape[-1]
    k = torch.arange(mcap, dtype=torch.float32, device=u.device)
    recip = torch.where(k > 0, 1.0 / torch.clamp(k, min=1.0), 0.0)
    flip = u >= 0.5
    u2 = torch.where(flip, 1.0 - 2.0 * (u - 0.5), 2.0 * u)
    a0c = ak_y[:, 0]
    ak_r = ak_y * recip[None, :]
    a = torch.zeros_like(u2)
    b = torch.full_like(u2, math.pi)
    phi = torch.full_like(u2, 0.5 * math.pi)
    for _ in range(_N_NEWTON + 4):
        ang = phi[:, None] * k[None, :]
        f = (ak_y * torch.cos(ang)).sum(-1)
        F = a0c * phi + (ak_r * torch.sin(ang)).sum(-1) - u2 * a0c * math.pi
        pos = F > 0
        b = torch.where(pos, phi, b)
        a = torch.where(pos, a, phi)
        phi = phi - F / torch.where(f.abs() > 1e-9, f, 1.0)
        phi = torch.where((phi > a) & (phi < b), phi, 0.5 * (a + b))
    phi = torch.minimum(torch.maximum(phi, a), b)
    f = (ak_y * torch.cos(phi[:, None] * k[None, :])).sum(-1)
    pdf = torch.where(a0c > 0, INV_2PI * f / torch.clamp(a0c, min=1e-12), 0.0)
    return torch.where(flip, 2.0 * math.pi - phi, phi), torch.clamp(pdf, min=0.0)


def fourier_sample(ft, tid, wo, u1, u2, mode: str = "radiance"):
    """Importance-sample the tabulated BSDF (reflection.rs sample_f()) in
    transport mode `mode`. Returns {wi, f (R, 3), pdf, valid}."""
    muo = wo[:, 2]
    mu = _table_rows(ft, "mu", tid)
    offo, wo4, vo = catmull_rom_weights(mu, muo)
    mui, pdf_mu = _sample_mui(ft, tid, offo, wo4, u2)
    offi, wi4, vi = catmull_rom_weights(mu, mui)
    ak = _accumulate_ak(ft, tid, offi, wi4, offo, wo4)
    phi, pdf_phi = _sample_phi(ak[:, 0, :], u1)
    sin_phi = torch.sin(phi)
    cos_phi = torch.cos(phi)
    sin2_ti = torch.clamp(1.0 - mui * mui, min=0.0)
    sin2_to = torch.clamp(1.0 - muo * muo, min=0.0)
    norm = torch.where(sin2_to > 1e-12, torch.sqrt(sin2_ti / torch.clamp(sin2_to, min=1e-12)), 0.0)
    wi = -torch.stack([norm * (cos_phi * wo[:, 0] - sin_phi * wo[:, 1]),
                       norm * (sin_phi * wo[:, 0] + cos_phi * wo[:, 1]), mui], dim=-1)
    wi = wi / torch.clamp(torch.sqrt((wi * wi).sum(-1, keepdim=True)), min=1e-12)
    y, r, b = _series_all(ak, cos_phi)
    f = _rgb_from_series(torch.clamp(y, min=0.0), r, b, _radiance_scale(ft, tid, mui, muo, mode))
    pdf = torch.clamp(pdf_phi * pdf_mu, min=0.0)
    valid = vo & vi & (pdf > 0)
    return {"wi": wi, "f": torch.where(valid[:, None], f, 0.0), "pdf": pdf, "valid": valid}
