"""Spatial (voxel-grid) light sampling distribution.

The port's counterpart of ``pbrt_tpu/device/lightdistrib.py``: the
reference's redesign of SpatialLightDistribution
(src/core/lightdistrib.rs:153-339) precomputes the whole voxel grid of
per-light CDFs when the route is built, in one sweep over voxels x lights x
point samples, in place of pbrt's lazily filled hash table. Each voxel's
importance per light is the luminance of Li / pdf summed over
N_POINT_SAMPLES hashed points inside it (no visibility, as pbrt), floored so
every light stays selectable. An infinite light's importance comes from
sample_li like any other light's (its radiance over its pdf, the same in
every voxel), as in the reference. At NEE time a lookup is a voxel index
and a row gather.
"""
from __future__ import annotations

import numpy as np
import torch

from .lights import sample_li
from .rng import pcg_hash, u32_to_float

N_POINT_SAMPLES = 32  # points per voxel (the reference's choice; pbrt uses 128 Halton points)
MAX_VOXELS = 1 << 15  # cap V so V * L stays small
_LUM = (0.212671, 0.71516, 0.072169)


def grid_resolution(static, world_lo, world_hi, max_voxels=MAX_VOXELS):
    """Per-axis voxel counts: proportional to the scene's extent per axis,
    the longest axis capped at 64 (lightdistrib.rs:166-172) and lowered for
    scenes with many lights to bound V * L."""
    diag = np.maximum(np.asarray(world_hi) - np.asarray(world_lo), 1e-6)
    base = int(np.clip((max_voxels / max(static.n_lights, 1)) ** (1.0 / 3.0) * 2.0, 4, 64))
    rel = diag / diag.max()
    res = np.maximum((rel * base).astype(np.int64), 1)
    while int(np.prod(res)) > max_voxels:
        res = np.maximum(res // 2, 1)
    return tuple(int(r) for r in res)


def build_spatial_distribution(sa, static, seed: int = 0):
    """The voxel-grid table on the scene's device.

    Returns dict {pmf (V, L), cdf (V, L), res (3,), lo (3,), inv_cell (3,),
    n_voxels} with V = prod(res)."""
    L = static.n_lights
    dev = sa.light_param.device
    wc = sa.world_center.cpu().numpy()
    wr = float(sa.world_radius)
    lo = wc - wr
    hi = wc + wr
    res = grid_resolution(static, lo, hi)
    nx, ny, nz = res
    V = nx * ny * nz
    iz, iy, ix = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    vox0 = torch.as_tensor(np.stack([ix, iy, iz], axis=-1).reshape(V, 3).astype(np.float32), device=dev)
    cell = (hi - lo).astype(np.float32) / np.asarray([nx, ny, nz], np.float32)
    lo_t = torch.as_tensor(lo.astype(np.float32), device=dev)
    cell_t = torch.as_tensor(cell, device=dev)
    lum = torch.tensor(_LUM, dtype=torch.float32, device=dev)
    vid = torch.arange(V, dtype=torch.int64, device=dev) * 0x9E3779B1
    acc = torch.zeros((V, L), dtype=torch.float32, device=dev)
    for s in range(N_POINT_SAMPLES):
        # hashed points inside each voxel, one light at a time
        h1 = pcg_hash(vid + (seed * 7919 + s))
        h2 = pcg_hash(h1 ^ 0x85EBCA6B)
        h3 = pcg_hash(h2 ^ 0xC2B2AE35)
        frac = torch.stack([u32_to_float(h1), u32_to_float(h2), u32_to_float(h3)], dim=-1)
        p = lo_t + (vox0 + frac) * cell_t
        for li in range(L):
            lid = torch.full((V,), li, dtype=torch.int64, device=dev)
            ua = u32_to_float(pcg_hash(h1 + li * 31))
            ub = u32_to_float(pcg_hash(h2 + li * 57))
            ls = sample_li(sa, static, lid, p, ua, ub)
            y = (ls["li"] * lum).sum(-1)
            acc[:, li] += torch.where(ls["pdf"] > 0, y / torch.clamp(ls["pdf"], min=1e-9), 0.0)
    # min-pmf floor (lightdistrib.rs:222-227): every light selectable
    total = acc.sum(1, keepdim=True)
    acc = torch.maximum(acc, torch.where(total > 0, total * (0.001 / L), 1.0))
    pmf = acc / acc.sum(1, keepdim=True)
    return {
        "pmf": pmf,
        "cdf": torch.cumsum(pmf, 1),
        "res": (nx, ny, nz),
        "lo": lo_t,
        "inv_cell": torch.as_tensor((1.0 / np.maximum(cell, 1e-12)).astype(np.float32), device=dev),
        "n_voxels": V,
    }


def voxel_of(dist, p):
    """(R, 3) world points -> flat voxel ids."""
    nx, ny, nz = dist["res"]
    q = (p - dist["lo"]) * dist["inv_cell"]
    ix = torch.clamp(q[:, 0].to(torch.int64), 0, nx - 1)
    iy = torch.clamp(q[:, 1].to(torch.int64), 0, ny - 1)
    iz = torch.clamp(q[:, 2].to(torch.int64), 0, nz - 1)
    return (iz * ny + iy) * nx + ix


def spatial_select(dist, p, u_sel):
    """Sample a light id per shading point from its voxel's CDF.

    Returns (lid (R,), pmf (R,))."""
    vox = voxel_of(dist, p)
    cdf_rows = dist["cdf"][vox]  # (R, L)
    L = cdf_rows.shape[1]
    lid = torch.clamp((u_sel[:, None] > cdf_rows[:, :-1]).sum(1), 0, L - 1)
    return lid, dist["pmf"][vox, lid]


def spatial_pmf_of(dist, p, lid):
    """pmf of a given light at each point's voxel (for MIS weights)."""
    L = dist["pmf"].shape[1]
    return dist["pmf"][voxel_of(dist, p), torch.clamp(lid, 0, L - 1)]
