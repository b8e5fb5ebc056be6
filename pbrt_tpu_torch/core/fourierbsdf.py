"""FourierBSDF table IO: the SCATFUN binary format, densified.

The port's own copy of ``pbrt_tpu/core/fourierbsdf.py`` (host NumPy code;
the reference package cannot be imported where the port runs). The
reference (src/core/reflection.rs:193-333 FourierBSDFTable::read) keeps the
measured-BSDF Fourier coefficients as a ragged CSR-style array (per
(mu_i, mu_o) pair a variable-order coefficient run); the reader densifies
it to a fixed (nmu^2, 3, m_cap) array with zero padding, so the device
evaluates the azimuthal series against a cos(k*phi) basis and every
per-pair lookup is a row of uniform width (device/fourier.py).

Channel convention: tables store luminance Y (+ R, B for nchannels==3);
G is derived as 1.39829*Y - 0.100913*B - 0.297375*R. For monochromatic
tables we store R = B = Y so the same device formula yields ~(Y, Y, Y).

``write_rough_conductor_table`` and ``write_lambert_table`` synthesize
tables (the tests and scenes.zoo_room use them): they write the same bytes
as the reference's writers.
"""
from __future__ import annotations

import logging
import struct

import numpy as np

log = logging.getLogger(__name__)

_HEADER = b"SCATFUN\x01"
M_CAP_LIMIT = 256


def integrate_catmull_rom(x: np.ndarray, values: np.ndarray) -> np.ndarray:
    """CDF of the Catmull-Rom interpolant of `values` at nodes `x`
    (src/core/interpolation.rs integrate_catmull_rom); values may be
    batched over leading axes. Returns cdf with cdf[..., 0] = 0."""
    n = x.shape[-1]
    f0 = values[..., :-1]
    f1 = values[..., 1:]
    x0, x1 = x[:-1], x[1:]
    width = x1 - x0
    d0 = np.empty_like(f0)
    d1 = np.empty_like(f0)
    d0[..., 0] = f1[..., 0] - f0[..., 0]
    d0[..., 1:] = width[1:] * (f1[..., 1:] - values[..., : n - 2]) / (x1[1:] - x[: n - 2])
    d1[..., -1] = f1[..., -1] - f0[..., -1]
    d1[..., : n - 2] = width[: n - 2] * (values[..., 2:] - f0[..., : n - 2]) / (x[2:] - x0[: n - 2])
    seg = ((d0 - d1) / 12.0 + (f0 + f1) * 0.5) * width
    cdf = np.zeros(values.shape, values.dtype)
    np.cumsum(seg, axis=-1, out=cdf[..., 1:])
    return cdf


def read_fourier_table(path: str) -> dict | None:
    """Parse a SCATFUN v1 file into dense numpy arrays.

    Returns dict(mu (nmu,), a (nmu*nmu, 3, m_cap), a0 (nmu, nmu),
    cdf (nmu, nmu), eta, m_cap, nmu) or None on error (the reference
    logs and drops back to matte on unreadable tables, api.rs behavior).
    """
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        log.error("Unable to open tabulated BSDF file %r", path)
        return None
    if raw[:8] != _HEADER:
        log.error("Tabulated BSDF file %r has an incompatible format or version", path)
        return None
    ints = struct.unpack_from("<9i", raw, 8)
    flags, nmu, ncoeffs, nmax, nch, nbases = ints[:6]
    (eta,) = struct.unpack_from("<f", raw, 44)
    off = 48 + 16  # 4 unused i32
    if flags != 1 or nch not in (1, 3) or nbases != 1:
        log.error("Tabulated BSDF file %r: unsupported flags/channels/bases", path)
        return None
    mu = np.frombuffer(raw, "<f4", nmu, off)
    off += 4 * nmu
    cdf = np.frombuffer(raw, "<f4", nmu * nmu, off).reshape(nmu, nmu)
    off += 4 * nmu * nmu
    ol = np.frombuffer(raw, "<i4", 2 * nmu * nmu, off).reshape(nmu * nmu, 2)
    off += 8 * nmu * nmu
    a = np.frombuffer(raw, "<f4", ncoeffs, off)

    m_cap = int(min(nmax, M_CAP_LIMIT))
    if nmax > M_CAP_LIMIT:
        log.warning("fourier table %r: clipping order %d -> %d", path, nmax, M_CAP_LIMIT)
    dense = np.zeros((nmu * nmu, 3, m_cap), np.float32)
    aoff, m = ol[:, 0], ol[:, 1]
    for i in range(nmu * nmu):
        mi = int(min(m[i], m_cap))
        if mi <= 0:
            continue
        o = int(aoff[i])
        dense[i, 0, :mi] = a[o : o + mi]
        if nch == 3:
            dense[i, 1, :mi] = a[o + m[i] : o + m[i] + mi]
            dense[i, 2, :mi] = a[o + 2 * m[i] : o + 2 * m[i] + mi]
        else:
            dense[i, 1, :mi] = dense[i, 0, :mi]
            dense[i, 2, :mi] = dense[i, 0, :mi]
    a0 = dense[:, 0, 0].reshape(nmu, nmu).copy()  # [o, i] layout
    return {
        "mu": np.asarray(mu, np.float32),
        "a": dense,
        "a0": a0,
        "cdf": np.asarray(cdf, np.float32),
        "eta": float(eta),
        "m_cap": m_cap,
        "nmu": int(nmu),
    }


def write_rough_conductor_table(path: str, alpha: float = 0.3, nmu: int = 24,
                                n_phi: int = 256, rel_eps: float = 1e-4) -> None:
    """Synthesize a MULTI-LOBE SCATFUN table: Beckmann rough conductor
    (Fresnel = 1) projected onto the azimuthal cosine basis.

    Unlike write_lambert_table (order-1 everywhere), the per-pair Fourier
    order here genuinely varies with the geometry (grazing pairs need
    10-60 cosine terms at alpha=0.3), exercising the ragged->dense
    densification, the per-pair order bookkeeping, and the full series
    evaluation on device against independently computable ground truth —
    the role the reference's embedded measured table plays in
    tests/fourierbsdf.rs:14.

    Jakob convention (reflection.rs:193-333): pair (mu_o, mu_i) stores
    f(wo, wi) * |mu_i| as a series in cos(k * phi_d) where
    cos(phi_d) = CosDPhi(-wi, wo); reflection quadrants have
    mu_i * mu_o < 0.
    """
    t = np.linspace(-1.0, 1.0, nmu)
    mu = np.sign(t) * np.abs(t) ** 1.0
    mu = mu.astype(np.float32)
    phi_d = np.linspace(0.0, np.pi, n_phi)

    def f_micro(mu_o_abs, mu_i_abs, phi_i):
        # Beckmann D * Smith G / (4 cos_o cos_i), Fresnel = 1; wi at
        # azimuth phi_i, wo at azimuth 0 (see test for the same formula)
        so = np.sqrt(max(0.0, 1.0 - mu_o_abs**2))
        si = np.sqrt(max(0.0, 1.0 - mu_i_abs**2))
        wo = np.array([so, 0.0, mu_o_abs])
        wi = np.stack([si * np.cos(phi_i), si * np.sin(phi_i),
                       np.full_like(phi_i, mu_i_abs)], axis=-1)
        wh = wi + wo
        nrm = np.linalg.norm(wh, axis=-1)
        wh = wh / np.maximum(nrm, 1e-12)[:, None]
        ct2 = np.clip(wh[:, 2] ** 2, 1e-12, 1.0)
        tan2 = (1.0 - ct2) / ct2
        D = np.exp(-tan2 / alpha**2) / (np.pi * alpha**2 * ct2**2)

        def lam(c):
            s = np.sqrt(max(0.0, 1.0 - c * c))
            if s < 1e-9:
                return 0.0
            a = c / (alpha * s)
            return 0.0 if a >= 1.6 else (1 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)

        G = 1.0 / (1.0 + lam(mu_o_abs) + lam(mu_i_abs))
        out = D * G / max(4.0 * mu_o_abs * mu_i_abs, 1e-9)
        return np.where(nrm > 1e-9, out, 0.0)

    pair_coeffs: dict[int, np.ndarray] = {}
    max_order = 1
    # cosine projection basis + trapezoid weights (f even in phi_d over
    # [0, pi]) — pair-independent, hoisted out of the nmu x nmu loop
    basis = np.cos(np.outer(np.arange(64), phi_d))
    w = np.full(n_phi, np.pi / (n_phi - 1))
    w[0] *= 0.5
    w[-1] *= 0.5
    for o in range(nmu):
        for i in range(nmu):
            if mu[o] * mu[i] >= 0 or abs(mu[i]) < 1e-3 or abs(mu[o]) < 1e-3:
                continue
            # phi_d -> physical wi azimuth: cos(phi_i) = -cos(phi_d)
            vals = f_micro(abs(mu[o]), abs(mu[i]), np.pi - phi_d) * abs(mu[i])
            ak = (basis * (vals * w)[None, :]).sum(axis=1) / np.pi
            ak[1:] *= 2.0
            m = 64
            while m > 1 and abs(ak[m - 1]) < rel_eps * max(ak[0], 1e-12):
                m -= 1
            pair_coeffs[o * nmu + i] = ak[:m].astype(np.float32)
            max_order = max(max_order, m)
    a0 = np.zeros((nmu, nmu), np.float32)
    for flat, ak in pair_coeffs.items():
        a0[flat // nmu, flat % nmu] = max(ak[0], 0.0)
    cdf = integrate_catmull_rom(mu.astype(np.float64), a0.astype(np.float64)).astype(np.float32)
    coeffs: list[float] = []
    ol = np.zeros((nmu * nmu, 2), np.int32)
    for flat in range(nmu * nmu):
        ak = pair_coeffs.get(flat)
        if ak is None or len(ak) == 0:
            ol[flat] = (len(coeffs), 0)
        else:
            ol[flat] = (len(coeffs), len(ak))
            coeffs.extend(ak.tolist())
    a = np.asarray(coeffs, np.float32)
    with open(path, "wb") as f:
        f.write(_HEADER)
        f.write(struct.pack("<9i", 1, nmu, len(a), max_order, 1, 1, 0, 0, 0))
        f.write(struct.pack("<f", 1.0))
        f.write(struct.pack("<4i", 0, 0, 0, 0))
        f.write(mu.tobytes())
        f.write(cdf.tobytes())
        f.write(ol.tobytes())
        f.write(a.tobytes())


def write_lambert_table(path: str, rho: float = 0.8, nmu: int = 32) -> None:
    """Synthesize a SCATFUN file for a Lambertian BRDF with albedo rho.

    Used by tests to exercise the full read -> densify -> device
    eval/sample pipeline without external measured data. The Jakob
    representation stores f * |mu_i| as an azimuthal cosine series; a
    Lambertian is order-1 with a0 = rho * |mu_i| / pi on the reflection
    quadrants (mu_i * mu_o < 0 under the mu_i = cos_theta(-wi) convention).
    """
    # strictly increasing nodes over [-1, 1], denser near grazing
    t = np.linspace(-1.0, 1.0, nmu)
    mu = np.sign(t) * np.abs(t) ** 1.0  # linear is fine for order-1 data
    mu = mu.astype(np.float32)
    a0 = np.zeros((nmu, nmu), np.float32)  # [o, i]
    for o in range(nmu):
        for i in range(nmu):
            if mu[o] * mu[i] < 0.0:
                a0[o, i] = rho * abs(mu[i]) / np.pi
    cdf = integrate_catmull_rom(mu.astype(np.float64), a0.astype(np.float64)).astype(np.float32)
    coeffs = []
    ol = np.zeros((nmu * nmu, 2), np.int32)
    for o in range(nmu):
        for i in range(nmu):
            flat = o * nmu + i
            if a0[o, i] > 0:
                ol[flat] = (len(coeffs), 1)
                coeffs.append(a0[o, i])
            else:
                ol[flat] = (len(coeffs), 0)
    a = np.asarray(coeffs, np.float32)
    with open(path, "wb") as f:
        f.write(_HEADER)
        f.write(struct.pack("<9i", 1, nmu, len(a), 1, 1, 1, 0, 0, 0))
        f.write(struct.pack("<f", 1.0))
        f.write(struct.pack("<4i", 0, 0, 0, 0))
        f.write(mu.tobytes())
        f.write(cdf.tobytes())
        f.write(ol.tobytes())
        f.write(a.tobytes())
