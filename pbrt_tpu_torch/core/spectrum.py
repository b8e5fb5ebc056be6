"""Host-side spectral machinery (NumPy).

The port's copy of ``pbrt_tpu/core/spectrum.py``, with the same formulas in
the same order, so parsed parameters and material rows come out
bit-identical.

The renderer runs RGB on device, exactly as the reference does
(src/core/spectrum.rs:7 — ``type Spectrum = RGBSpectrum``).
This module provides the host-only conversions that feed it: CIE XYZ color
matching, blackbody emitters, sampled-spectrum resampling, and RGB<->XYZ.

Instead of embedding the 1nm CIE tables, the color matching functions use the
multi-lobe Gaussian analytic fits of Wyman, Sloan & Shirley, "Simple Analytic
Approximations to the CIE XYZ Color Matching Functions" (JCGT 2013) — accurate
to well under 1% of peak, which is far below the render MSE gate.
"""
from __future__ import annotations

import numpy as np

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
N_SPECTRAL_SAMPLES = 60  # parity with reference spectrum.rs:234 (SampledSpectrum)

# Integral of the CIE Y matching curve; the standard value used for luminance
# normalization (reference spectrum.rs uses CIE_Y_INTEGRAL = 106.856895).
CIE_Y_INTEGRAL = 106.856895


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


# Dense wavelength grid for integration against arbitrary SPDs.
_CIE_LAMBDA = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0, 1.0)
_CIE_XYZ = cie_xyz_fit(_CIE_LAMBDA)  # (471, 3)
_CIE_Y_SUM = float(np.sum(_CIE_XYZ[:, 1]))


def xyz_to_rgb(xyz):
    """sRGB primaries, linear (reference spectrum.rs xyz_to_rgb)."""
    xyz = np.asarray(xyz, dtype=np.float64)
    m = np.array(
        [
            [3.240479, -1.537150, -0.498535],
            [-0.969256, 1.875991, 0.041556],
            [0.055648, -0.204043, 1.057311],
        ]
    )
    return xyz @ m.T


def rgb_to_xyz(rgb):
    rgb = np.asarray(rgb, dtype=np.float64)
    m = np.array(
        [
            [0.412453, 0.357580, 0.180423],
            [0.212671, 0.715160, 0.072169],
            [0.019334, 0.119193, 0.950227],
        ]
    )
    return rgb @ m.T


def blackbody(lam_nm, t_kelvin):
    """Planck's law: emitted radiance W/(m^2 sr m) (reference spectrum.rs:36-55)."""
    lam = np.asarray(lam_nm, dtype=np.float64) * 1e-9
    h = 6.62606957e-34
    c = 299792458.0
    kb = 1.3806488e-23
    with np.errstate(over="ignore"):
        le = (2.0 * h * c * c) / (lam**5 * (np.expm1((h * c) / (lam * kb * t_kelvin))))
    return le


def blackbody_normalized(lam_nm, t_kelvin):
    """Planck spectrum normalized so its peak is 1 (spectrum.rs:57-71)."""
    le = blackbody(lam_nm, t_kelvin)
    # Wien's displacement law for the peak wavelength.
    lambda_max = 2.8977721e-3 / t_kelvin * 1e9
    max_l = blackbody(np.array([lambda_max]), t_kelvin)[0]
    return le / max_l


def spd_to_xyz(lam_nm, values):
    """Integrate an SPD given at sample points against the CIE curves.

    Mirrors SampledSpectrum::from_sampled -> to_xyz (spectrum.rs:129, :276):
    the SPD is piecewise-linearly resampled onto a dense grid, then integrated.
    """
    lam_nm = np.asarray(lam_nm, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    order = np.argsort(lam_nm)
    lam_nm, values = lam_nm[order], values[order]
    dense = np.interp(_CIE_LAMBDA, lam_nm, values, left=values[0], right=values[-1])
    xyz = (dense[:, None] * _CIE_XYZ).sum(axis=0) / _CIE_Y_SUM
    return xyz


def spd_to_rgb(lam_nm, values):
    return xyz_to_rgb(spd_to_xyz(lam_nm, values))


def blackbody_rgb(t_kelvin, scale=1.0):
    """RGB of a normalized blackbody at temperature T, scaled (for 'blackbody' params)."""
    vals = blackbody_normalized(_CIE_LAMBDA, t_kelvin)
    rgb = xyz_to_rgb(spd_to_xyz(_CIE_LAMBDA, vals))
    return np.maximum(rgb, 0.0) * scale


def y_of_rgb(rgb):
    """Luminance of linear RGB (reference RGBSpectrum::y)."""
    rgb = np.asarray(rgb, dtype=np.float64)
    w = np.array([0.212671, 0.715160, 0.072169])
    return rgb @ w


# -- named spectra ----------------------------------------------------------
# The reference embeds measured copper n/k data for the metal material
# (src/materials/metal.rs:13-51). We use the Lorentz-Drude
# analytic model fits from Rakic et al. (1998), a standard public model, to
# produce equivalent copper eta/k curves.


def _lorentz_drude_copper(lam_nm):
    """Copper complex refractive index via the Lorentz-Drude model (Rakic 1998)."""
    lam = np.asarray(lam_nm, dtype=np.float64)
    ev = 1239.84193 / lam  # photon energy in eV
    # Rakic et al. LD parameters for Cu: wp, f0, G0, then oscillators (f, G, w).
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
