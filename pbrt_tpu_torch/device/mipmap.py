"""MIPMap: the host pyramid build and the trilinear and EWA lookups.

The port's counterpart of ``pbrt_tpu/device/mipmap.py`` (src/core/mipmap.rs):
images are resampled to powers of two with a Lanczos-windowed sinc
(resample_weights :269), the pyramid is a 2x2 box downsample chain, and
lookups are trilinear over the two levels the texture-space footprint width
selects (:202) or elliptically weighted averages over the footprint's axes
(:225).

- ``build_pyramid``: host numpy, the reference's arithmetic, so every level
  is bit-identical (the scene compiler stores level k of image i as
  ``tex_images[f"img{i}_l{k}"]``).
- ``mip_atlas``: all levels of one pyramid stacked along rows, so that a
  per-lane level is index arithmetic; built once per route
  (``texture.prepare_atlases``) instead of once per lookup.
- ``lookup_trilinear``, ``lookup_ewa``: plain torch tensor code, as the
  reference's are XLA code outside any Pallas kernel. The EWA scan visits
  the reference's 2 EWA_R x 2 EWA_R texel window one window row at a time,
  so its temporaries are (R, 2 EWA_R, 3), never the whole (R, 64, 3)
  window of a level.

The reference's lookups treat the "black" wrap as "clamp" (only its
single-level bilinear lookup masks black texels); the port does the same.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host-side pyramid build
# ---------------------------------------------------------------------------


def _lanczos_resample_weights(old_n: int, new_n: int, filter_width: float = 2.0):
    """Per-output-texel contribution weights (mipmap.rs resample_weights)."""
    first = np.zeros(new_n, np.int64)
    weights = np.zeros((new_n, 4), np.float64)
    for i in range(new_n):
        center = (i + 0.5) * old_n / new_n - 0.5
        first[i] = int(np.floor(center - filter_width + 0.5))
        for j in range(4):
            pos = first[i] + j + 0.5 - 0.5
            x = abs((pos - center) / filter_width)
            if x < 1e-9:
                w = 1.0
            elif x > 1.0:
                w = 0.0
            else:
                x *= np.pi
                w = (np.sin(x * 2.0) / (x * 2.0)) * (np.sin(x) / x)
            weights[i, j] = w
        s = weights[i].sum()
        if s != 0:
            weights[i] /= s
    return first, weights


def _resample_axis(img: np.ndarray, new_n: int, axis: int) -> np.ndarray:
    old_n = img.shape[axis]
    if old_n == new_n:
        return img
    first, w = _lanczos_resample_weights(old_n, new_n)
    moved = np.moveaxis(img, axis, 0)
    out = np.zeros((new_n,) + moved.shape[1:], moved.dtype)
    for j in range(4):
        idx = np.clip(first + j, 0, old_n - 1)
        out += w[:, j].reshape((-1,) + (1,) * (moved.ndim - 1)) * moved[idx]
    return np.moveaxis(out, 0, axis)


def build_pyramid(img: np.ndarray) -> list[np.ndarray]:
    """Image -> power-of-two pyramid down to 1x1 (mipmap.rs:76-160)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    ph = 1 << max(int(math.ceil(math.log2(max(h, 1)))), 0)
    pw = 1 << max(int(math.ceil(math.log2(max(w, 1)))), 0)
    base = img
    if (ph, pw) != (h, w):
        base = _resample_axis(_resample_axis(img.astype(np.float64), pw, 1), ph, 0)
        base = np.maximum(base, 0.0).astype(np.float32)
    levels = [base]
    cur = base
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        nh = max(cur.shape[0] // 2, 1)
        nw = max(cur.shape[1] // 2, 1)
        c = cur[: nh * 2 if cur.shape[0] > 1 else 1, : nw * 2 if cur.shape[1] > 1 else 1]
        if cur.shape[0] > 1 and cur.shape[1] > 1:
            nxt = 0.25 * (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2])
        elif cur.shape[0] > 1:
            nxt = 0.5 * (c[0::2] + c[1::2])
        else:
            nxt = 0.5 * (c[:, 0::2] + c[:, 1::2])
        levels.append(nxt.astype(np.float32))
        cur = nxt
    return levels


# ---------------------------------------------------------------------------
# Device-side lookups
# ---------------------------------------------------------------------------


def image_bilinear(img, u, v, wrap="repeat"):
    """Bilinear lookup in one (H, W, 3) level at texture coordinates (u, v),
    v flipped (imagemap.rs: pbrt images are top-down); wrap repeat, clamp
    or black (texels outside read 0)."""
    h, w, _ = img.shape
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def fetch(xi, yi):
        if wrap == "black":
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            t = img[torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1)]
            return torch.where(inside[..., None], t, 0.0)
        if wrap == "repeat":
            return img[torch.remainder(yi, h), torch.remainder(xi, w)]
        return img[torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1)]

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def mip_atlas(levels):
    """Stack the levels into one (sum H_k, W_0, 3) tensor: (atlas, row
    offsets, heights, widths), the last three int64 (L,) tensors."""
    w0 = levels[0].shape[1]
    dev = levels[0].device
    offs, hs, ws, rows = [], [], [], []
    off = 0
    for lv in levels:
        h, w = lv.shape[0], lv.shape[1]
        offs.append(off)
        hs.append(h)
        ws.append(w)
        rows.append(torch.nn.functional.pad(lv, (0, 0, 0, w0 - w)) if w0 != w else lv)
        off += h
    as_t = (lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev))
    return torch.cat(rows, dim=0), as_t(offs), as_t(hs), as_t(ws)


def _atlas_bilinear(atlas, off_l, h_l, w_l, u, v, wrap):
    """Bilinear tap at a per-lane level of the atlas."""
    x = u * w_l.to(torch.float32) - 0.5
    y = (1.0 - v) * h_l.to(torch.float32) - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0.to(torch.float32))[:, None]
    fy = (y - y0.to(torch.float32))[:, None]

    def wrapx(i):
        return torch.remainder(i, w_l) if wrap == "repeat" else torch.minimum(torch.clamp(i, min=0), w_l - 1)

    def wrapy(j):
        return (torch.remainder(j, h_l) if wrap == "repeat" else torch.minimum(torch.clamp(j, min=0), h_l - 1)) + off_l

    c00 = atlas[wrapy(y0), wrapx(x0)]
    c10 = atlas[wrapy(y0), wrapx(x0 + 1)]
    c01 = atlas[wrapy(y0 + 1), wrapx(x0)]
    c11 = atlas[wrapy(y0 + 1), wrapx(x0 + 1)]
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def _levels_of(levels, atlas):
    return atlas if atlas is not None else mip_atlas(levels)


def lookup_trilinear(levels, u, v, width, wrap="repeat", atlas=None):
    """Trilinear MIPMap lookup (mipmap.rs lookup :202): levels, a list of
    (H_k, W_k, 3) tensors; width (R,), the footprint in [0, 1] texture
    space; taps at the two per-lane adjacent levels. atlas: mip_atlas of
    the levels, when the caller holds it."""
    n = len(levels)
    if n == 1:
        return image_bilinear(levels[0], u, v, wrap)
    at, offs, hs, ws = _levels_of(levels, atlas)
    lvl = (n - 1) + torch.log2(torch.clamp(width, min=1e-8))
    lvl = torch.clamp(lvl, 0.0, n - 1 - 1e-4)
    i0 = torch.floor(lvl).to(torch.int64)
    ft = (lvl - i0.to(torch.float32))[:, None]
    i1 = torch.clamp(i0 + 1, max=n - 1)
    v_lo = _atlas_bilinear(at, offs[i0], hs[i0], ws[i0], u, v, wrap)
    v_hi = _atlas_bilinear(at, offs[i1], hs[i1], ws[i1], u, v, wrap)
    return v_lo * (1.0 - ft) + v_hi * ft


EWA_R = 4  # half-width of the bounded EWA scan window, in texels
_EWA_LUT = np.exp(-2.0 * np.linspace(0.0, 1.0, 128)) - np.exp(-2.0)


def lookup_ewa(levels, u, v, duv0, duv1, wrap="repeat", max_anisotropy=8.0, atlas=None):
    """EWA anisotropic lookup (mipmap.rs lookup2 :225): duv0, duv1 (R, 2)
    the footprint's axes in texture space. The level comes from the minor
    axis, raised so that the major axis fits the +-EWA_R texel window, as
    in the reference."""
    n = len(levels)
    l0 = (duv0 * duv0).sum(-1)
    l1 = (duv1 * duv1).sum(-1)
    swap = l1 > l0
    major = torch.where(swap[:, None], duv1, duv0)
    minor = torch.where(swap[:, None], duv0, duv1)
    maj_len = torch.sqrt(torch.clamp(torch.where(swap, l1, l0), min=1e-20))
    min_len = torch.sqrt(torch.clamp(torch.where(swap, l0, l1), min=1e-20))
    # clamp the eccentricity
    scale = torch.where(min_len * max_anisotropy < maj_len,
                        maj_len / torch.clamp(min_len * max_anisotropy, min=1e-20), 1.0)
    min_len = min_len * scale
    minor = minor * scale[:, None]
    if n == 1:
        return image_bilinear(levels[0], u, v, wrap)
    at, offs, hs, ws = _levels_of(levels, atlas)
    eff = torch.maximum(min_len, maj_len / EWA_R)
    lvl = torch.clamp((n - 1) + torch.log2(torch.clamp(eff, min=1e-8)), 0.0, n - 1 - 1e-4)
    i0 = torch.floor(lvl).to(torch.int64)
    ft = (lvl - i0.to(torch.float32))[:, None]
    i1 = torch.clamp(i0 + 1, max=n - 1)
    v_lo = _ewa_level_atlas(at, offs[i0], hs[i0], ws[i0], u, v, major, minor, wrap)
    v_hi = _ewa_level_atlas(at, offs[i1], hs[i1], ws[i1], u, v, major, minor, wrap)
    return v_lo * (1.0 - ft) + v_hi * ft


def _ewa_level_atlas(atlas, off_l, h_li, w_li, u, v, major, minor, wrap):
    """Elliptically weighted average at a per-lane level (mipmap.rs ewa),
    one window row of 2 EWA_R texels at a time."""
    w = w_li.to(torch.float32)
    h = h_li.to(torch.float32)
    st0 = u * w - 0.5
    st1 = (1.0 - v) * h - 0.5
    d0x, d0y = major[:, 0] * w, -(major[:, 1] * h)
    d1x, d1y = minor[:, 0] * w, -(minor[:, 1] * h)
    a = d0y * d0y + d1y * d1y + 1.0
    b = -2.0 * (d0x * d0y + d1x * d1y)
    c = d0x * d0x + d1x * d1x + 1.0
    inv_f = 1.0 / torch.clamp(a * c - b * b * 0.25, min=1e-12)
    a, b, c = a * inv_f, b * inv_f, c * inv_f
    det = -b * b + 4.0 * a * c
    inv_det = 1.0 / torch.clamp(det, min=1e-12)
    u_r = torch.sqrt(torch.clamp(c * det, min=0.0)) * inv_det * 2.0
    v_r = torch.sqrt(torch.clamp(a * det, min=0.0)) * inv_det * 2.0
    s0 = torch.ceil(st0 - torch.clamp(u_r, max=float(EWA_R))).to(torch.int64)
    t0 = torch.ceil(st1 - torch.clamp(v_r, max=float(EWA_R))).to(torch.int64)

    lut = torch.as_tensor(_EWA_LUT, dtype=torch.float32, device=u.device)
    di = torch.arange(2 * EWA_R, device=u.device)
    si = s0[:, None] + di  # (R, 2R): the window row's columns
    ss = si.to(torch.float32) - st0[:, None]
    xi = torch.remainder(si, w_li[:, None]) if wrap == "repeat" else torch.minimum(
        torch.clamp(si, min=0), w_li[:, None] - 1)
    acc = torch.zeros(u.shape + (3,), dtype=torch.float32, device=u.device)
    wsum = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for dj in range(2 * EWA_R):
        tj = t0 + dj
        tt = (tj.to(torch.float32) - st1)[:, None]
        r2 = a[:, None] * ss * ss + b[:, None] * ss * tt + c[:, None] * tt * tt
        li = torch.clamp((r2 * 128).to(torch.int64), 0, 127)
        wt = torch.where(r2 < 1.0, lut[li], 0.0)
        yj = torch.remainder(tj, h_li) if wrap == "repeat" else torch.minimum(torch.clamp(tj, min=0), h_li - 1)
        texels = atlas[(yj + off_l)[:, None], xi]  # (R, 2R, 3)
        acc = acc + (wt[:, :, None] * texels).sum(1)
        wsum = wsum + wt.sum(1)
    fallback = _atlas_bilinear(atlas, off_l, h_li, w_li, u, v, wrap)
    ok = wsum > 1e-6
    return torch.where(ok[:, None], acc / torch.clamp(wsum, min=1e-6)[:, None], fallback)
