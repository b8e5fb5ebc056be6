"""BSDF sample / eval / pdf for the Lambertian reflection lobe.

The port's counterpart of ``pbrt_tpu/device/bsdf.py`` restricted to what
matte with a constant Kd builds: one LOBE_LAMBERT_R slot (or none where
Kd is black). A lobe set is {"kind": (R,) int, "color": (R, 3)}; with a
single slot, the reference's uniform lobe pick and its average over active
lobes reduce to that slot, so every result below equals the reference's
8-slot evaluation of the same lobes.
"""
from __future__ import annotations

import math

import torch

from .camera import concentric_sample_disk
from .shading import normalize

# lobe ids and slot count of the reference's lobe sets (bsdf.py); the
# wavefront evaluates LOBE_LAMBERT_R only, the brute megakernel bakes the
# others (device/materials.bake_lobes)
N_SLOTS = 8
LOBE_NONE = 0
LOBE_LAMBERT_R = 1
LOBE_OREN_NAYAR = 3
LOBE_MICRO_R = 4
LOBE_MICRO_T = 5
LOBE_SPEC_R = 6
LOBE_SPEC_T = 7
LOBE_FRESNEL_SPEC = 8
INV_PI = 1.0 / math.pi


def tr_roughness_to_alpha(rough):
    """TrowbridgeReitz::roughness_to_alpha (microfacet.rs), float32 in the
    reference's operation order."""
    r = torch.clamp(rough, min=1e-3)
    x = torch.log(r)
    x2 = x * x
    return 1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * (x2 * x) + 0.000640711 * (x2 * x2)


def abs_cos_theta(w):
    return w[..., 2].abs()


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0


def cosine_sample_hemisphere(u1, u2):
    dx, dy = concentric_sample_disk(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=0.0))
    return torch.stack([dx, dy, z], dim=-1)


def num_lobes(lobes):
    return (lobes["kind"] != LOBE_NONE).to(torch.int64)


def bsdf_f(lobes, wo, wi, refl):
    """Sum of lobe f values matching the reflect/transmit geometry bit."""
    match = (lobes["kind"] == LOBE_LAMBERT_R) & refl
    return torch.where(match[:, None], lobes["color"] * INV_PI, 0.0)


def bsdf_pdf(lobes, wo, wi):
    """Average pdf over the active lobes (reflection.rs BSDF::pdf)."""
    lam = (lobes["kind"] == LOBE_LAMBERT_R) & same_hemisphere(wo, wi)
    return torch.where(lam, abs_cos_theta(wi) * INV_PI, 0.0)


def bsdf_sample(lobes, wo, u_lobe, u1, u2):
    """Sample the BSDF (reflection.rs:1583-1669).

    Returns dict {wi, f, pdf, specular, valid, eta_scale, abs_cos}."""
    kind = lobes["kind"]
    active = kind != LOBE_NONE
    entering = (wo[:, 2] > 0)[:, None]
    wi_cos = cosine_sample_hemisphere(u1, u2)
    flip_z = torch.tensor([1.0, 1.0, -1.0], dtype=wi_cos.dtype, device=wi_cos.device)
    wi = torch.where(entering, wi_cos, wi_cos * flip_z)
    wi = torch.where((kind == LOBE_LAMBERT_R)[:, None], wi, 0.0)
    wi = normalize(wi)
    refl = same_hemisphere(wo, wi)
    f = bsdf_f(lobes, wo, wi, refl)
    pdf = bsdf_pdf(lobes, wo, wi)
    return {
        "wi": wi,
        "f": f,
        "pdf": torch.clamp(pdf, min=0.0),
        "specular": torch.zeros_like(active),
        "valid": active & (pdf > 0),
        "eta_scale": torch.ones_like(pdf),
        "abs_cos": abs_cos_theta(wi),
    }
