"""Host-side spectral helpers (NumPy): the copper eta/k that the 'metal'
material defaults to.

The port's copy of the part of ``pbrt_tpu/core/spectrum.py`` that the scene
compiler reads, with the same formulas in the same order, so the material
rows come out bit-identical. The CIE matching functions are the multi-lobe
Gaussian fits of Wyman, Sloan & Shirley (JCGT 2013); copper's complex index
is the Lorentz-Drude model of Rakic et al. (1998).
"""
from __future__ import annotations

import numpy as np

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0


def _gauss(x, alpha, mu, sigma1, sigma2):
    sigma = np.where(x < mu, sigma1, sigma2)
    return alpha * np.exp(-((x - mu) ** 2) / (2.0 * sigma**2))


def cie_xyz_fit(lam):
    """Analytic CIE 1931 2-deg color matching functions at wavelength(s) nm."""
    lam = np.asarray(lam, dtype=np.float64)
    x = (
        _gauss(lam, 0.362, 442.0, 16.0, 26.7)
        + _gauss(lam, 1.056, 599.8, 37.9, 31.0)
        + _gauss(lam, -0.065, 501.1, 20.4, 26.2)
    )
    y = _gauss(lam, 0.821, 568.8, 46.9, 40.5) + _gauss(lam, 0.286, 530.9, 16.3, 31.1)
    z = _gauss(lam, 1.217, 437.0, 11.8, 36.0) + _gauss(lam, 0.681, 459.0, 26.0, 13.8)
    return np.stack([x, y, z], axis=-1)


_CIE_LAMBDA = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0, 1.0)
_CIE_XYZ = cie_xyz_fit(_CIE_LAMBDA)  # (471, 3)
_CIE_Y_SUM = float(np.sum(_CIE_XYZ[:, 1]))


def xyz_to_rgb(xyz):
    """sRGB primaries, linear (spectrum.rs xyz_to_rgb)."""
    xyz = np.asarray(xyz, dtype=np.float64)
    m = np.array(
        [
            [3.240479, -1.537150, -0.498535],
            [-0.969256, 1.875991, 0.041556],
            [0.055648, -0.204043, 1.057311],
        ]
    )
    return xyz @ m.T


def spd_to_rgb(lam_nm, values):
    """Integrate an SPD given at sample points against the CIE curves
    (SampledSpectrum::from_sampled -> to_xyz, spectrum.rs:129, :276), then
    to linear sRGB."""
    lam_nm = np.asarray(lam_nm, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    order = np.argsort(lam_nm)
    lam_nm, values = lam_nm[order], values[order]
    dense = np.interp(_CIE_LAMBDA, lam_nm, values, left=values[0], right=values[-1])
    xyz = (dense[:, None] * _CIE_XYZ).sum(axis=0) / _CIE_Y_SUM
    return xyz_to_rgb(xyz)


def _lorentz_drude_copper(lam_nm):
    """Copper complex refractive index via the Lorentz-Drude model (Rakic 1998)."""
    lam = np.asarray(lam_nm, dtype=np.float64)
    ev = 1239.84193 / lam  # photon energy in eV
    wp = 10.83
    f0, g0 = 0.575, 0.030
    osc = [
        (0.061, 0.378, 0.291),
        (0.104, 1.056, 2.957),
        (0.723, 3.213, 5.300),
        (0.638, 4.305, 11.18),
    ]
    w = ev
    eps = 1.0 - (f0 * wp**2) / (w * (w + 1j * g0))
    for f, g, wj in osc:
        eps = eps + (f * wp**2) / ((wj**2 - w**2) - 1j * w * g)
    n_complex = np.sqrt(eps)
    return n_complex.real, n_complex.imag


def copper_eta_k_rgb():
    """(eta_rgb, k_rgb) for copper, used by the 'metal' material defaults."""
    n, k = _lorentz_drude_copper(_CIE_LAMBDA)
    eta = spd_to_rgb(_CIE_LAMBDA, n)
    kk = spd_to_rgb(_CIE_LAMBDA, k)
    return np.maximum(eta, 0.0), np.maximum(kk, 0.0)
