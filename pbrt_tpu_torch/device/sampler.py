"""Per-ray sample streams, bit-exact with ``pbrt_tpu/device/sampler.py``
for the "zerotwosequence" (and its alias "lowdiscrepancy"), "random",
"stratified", "halton", "sobol" and "maxmindist" samplers.

``dim`` is a Python int (film and lens dimensions) or an integer tensor
(the per-lane bounce dimensions of the persistent loop); both give the same
bits as the reference. The stratified sampler stratifies the int
dimensions: the film pair by the sample index, every other dimension with
a per-(pixel, dimension) rotation of the strata; tensor dimensions draw
from the random stream, as the reference's do. Halton and Sobol continue
one sequence into the tensor dimensions (per-lane prime bases and
generator-matrix columns); MaxMinDist draws its film pair from a searched
generator matrix and every other dimension from the (0,2)-sequence.

``strata`` is the declared stratified shape (x_samples, y_samples, jitter)
(stratified.rs:121-131). The reference keeps it in a module global set by
render_compiled; the port passes it along in the sampler config. It is used
when x_samples * y_samples == spp, else the shape is floor(sqrt(spp)) x
spp // that, jittered.

The film and lens dimensions of the halton and sobol samplers come from
the global enumerations of the film (``halton_tables`` / ``sobol_tables``,
built once per route into the sampler config, and ``halton_film_jitter``,
``halton_dim_2d``, ``sobol_film_jitter``, ``sobol_dim_2d``), as
``render.make_regen`` draws them. uint32 values ride in int64 tensors
masked to 32 bits (see device/rng.py).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import rng
from .rng import MASK32

SAMPLER_KINDS = ("zerotwosequence", "lowdiscrepancy", "random", "stratified", "halton", "sobol", "maxmindist")


def _check(kind: str):
    if kind not in SAMPLER_KINDS:
        raise NotImplementedError(f"pbrt_tpu_torch does not support the '{kind}' sampler yet")


def stratified_shape(spp: int, strata=None) -> tuple[int, int, bool]:
    """(xs, ys, jitter) of the stratified sampler (sampler.stratified_shape)."""
    if strata is not None and strata[0] * strata[1] == spp:
        return int(strata[0]), int(strata[1]), bool(strata[2])
    xs = max(int(math.floor(math.sqrt(spp))), 1)
    return xs, max(spp // xs, 1), True if strata is None else bool(strata[2])


def _wrap(u):
    return torch.where(u >= 1.0, u - 1.0, u)


def _xor_columns(idx, cols, res):
    """res ^ (GF(2) product of the generator columns `cols` with idx's bits)."""
    for j, c in enumerate(cols):
        c = int(c)
        if c:
            res = res ^ (((idx >> j) & 1) * c)
    return res


# ---------------------------------------------------------------------------
# Sobol' dimensions (core/sobolmat.py generator matrices)
# ---------------------------------------------------------------------------


def sobol_dim(sample_idx, dim: int, scramble):
    """Sobol' sample of dimension `dim` at index `sample_idx`, XOR-scrambled
    (sampler.sobol_dim). Dims >= 1024 draw a scramble-hashed uniform."""
    from ..core.sobolmat import matrix

    idx = rng._u32(sample_idx)
    if dim >= 1024:
        return rng.u32_to_float(rng.pcg_hash(rng._u32(scramble) ^ idx))
    res = torch.zeros_like(idx) + rng._u32(scramble)
    return rng.u32_to_float(_xor_columns(idx, matrix(dim), res))


def _sobol_cols(max_dim: int) -> np.ndarray:
    from ..core.sobolmat import matrix

    return np.stack([matrix(k) for k in range(max_dim)])


def sobol_dim_dyn(sample_idx, dim, scramble, max_dim: int = 64, to_float=rng.u32_to_float):
    """Sobol' sample with a per-lane dimension: the generator columns of the
    first max_dim dimensions, gathered per lane (sampler.sobol_dim_dyn);
    to_float converts the scrambled uint32 to [0, 1)."""
    table = rng.device_table(f"sobol_cols_{max_dim}", lambda: _sobol_cols(max_dim), dim.device)
    cols = table[torch.clamp(dim.to(torch.int64), 0, max_dim - 1)]  # (..., 32)
    idx = rng._u32(sample_idx)
    res = torch.zeros(torch.broadcast_shapes(idx.shape, cols.shape[:-1]), dtype=torch.int64, device=dim.device)
    res = res + rng._u32(scramble)
    for j in range(32):
        res = res ^ (((idx >> j) & 1) * cols[..., j])
    return to_float(res)


# ---------------------------------------------------------------------------
# Per-lane samples
# ---------------------------------------------------------------------------


def sample_2d(kind: str, seed, pixel, sample_idx, dim, spp: int, strata=None):
    """One 2D sample (u1, u2) per lane."""
    _check(kind)
    if kind in ("halton", "sobol") and not isinstance(dim, int):
        d2 = 2 * dim
        if kind == "sobol":
            s1 = rng.hash_combine(seed, pixel, d2)
            s2 = rng.hash_combine(seed, pixel, d2 + 1)
            return sobol_dim_dyn(sample_idx, d2, s1), sobol_dim_dyn(sample_idx, d2 + 1, s2)
        b0 = torch.clamp(d2, max=len(rng.PRIMES) - 2)
        u1 = rng.radical_inverse_dyn(b0, sample_idx) + rng.u32_to_float(rng.hash_combine(seed, pixel, d2))
        u2 = rng.radical_inverse_dyn(b0 + 1, sample_idx) + rng.u32_to_float(rng.hash_combine(seed, pixel, d2 + 1))
        return _wrap(u1), _wrap(u2)
    if kind == "maxmindist" and isinstance(dim, int) and dim == 0:
        return maxmin_2d_dim0(seed, pixel, sample_idx, spp)
    if kind in ("random", "stratified"):
        u1 = rng.uniform_1d(seed, pixel, sample_idx, 2 * dim)
        u2 = rng.uniform_1d(seed, pixel, sample_idx, 2 * dim + 1)
        if kind == "stratified" and isinstance(dim, int):
            # jittered strata on every int dimension pair; the strata order
            # rotates per (pixel, dim) past the film pair (uint32 sums)
            xs, ys, jitter = stratified_shape(spp, strata)
            idx = rng._u32(sample_idx)
            if dim != 0:
                idx = ((idx + rng.hash_combine(seed, pixel, 7919 * dim)) & MASK32) % max(xs * ys, 1)
            sx = (idx % xs).float()
            sy = ((idx // xs) % ys).float()
            if not jitter:  # stratum centres
                u1 = u1.new_full(u1.shape, 0.5)
                u2 = u2.new_full(u2.shape, 0.5)
            u1 = (sx + u1) / xs
            u2 = (sy + u2) / ys
        return u1, u2
    if kind == "sobol":
        s1 = rng.hash_combine(seed, pixel, 2 * dim)
        s2 = rng.hash_combine(seed, pixel, 2 * dim + 1)
        return sobol_dim(sample_idx, 2 * dim, s1), sobol_dim(sample_idx, 2 * dim + 1, s2)
    if kind == "halton":
        # Cranley-Patterson rotated Halton: bases (2, 3), (5, 7), ... per pair
        b0 = min(2 * dim, len(rng.PRIMES) - 2)
        u1 = rng.radical_inverse(b0, sample_idx) + rng.u32_to_float(rng.hash_combine(seed, pixel, 2 * dim))
        u2 = rng.radical_inverse(b0 + 1, sample_idx) + rng.u32_to_float(rng.hash_combine(seed, pixel, 2 * dim + 1))
        return _wrap(u1), _wrap(u2)
    # (0,2)-sequence: per-(pixel, dim-pair) scramble, index = sample
    s1 = rng.hash_combine(seed, pixel, 2 * dim)
    s2 = rng.hash_combine(seed, pixel, 2 * dim + 1)
    return rng.sample_02(sample_idx, s1, s2)


def sample_1d(kind: str, seed, pixel, sample_idx, dim, spp: int, strata=None):
    _check(kind)
    if kind in ("halton", "sobol") and not isinstance(dim, int):
        d2 = 2 * dim
        s1 = rng.hash_combine(seed, pixel, d2)
        if kind == "sobol":
            return sobol_dim_dyn(sample_idx, d2, s1)
        b0 = torch.clamp(d2, max=len(rng.PRIMES) - 2)
        return _wrap(rng.radical_inverse_dyn(b0, sample_idx) + rng.u32_to_float(s1))
    if kind == "stratified" and isinstance(dim, int):
        # 1D jittered strata with a per-(pixel, dim) rotation
        _xs, _ys, jitter = stratified_shape(spp, strata)
        rot = rng.hash_combine(seed, pixel, 104729 + 7919 * dim)
        idx = ((rng._u32(sample_idx) + rot) & MASK32) % max(spp, 1)
        u = rng.uniform_1d(seed, pixel, sample_idx, 1024 + dim)
        if not jitter:
            u = u.new_full(u.shape, 0.5)
        return (idx.float() + u) / max(spp, 1)
    if kind in ("random", "stratified"):
        return rng.uniform_1d(seed, pixel, sample_idx, 1024 + dim)
    if kind == "sobol":
        return sobol_dim(sample_idx, 512 + dim, rng.hash_combine(seed, pixel, 4096 + dim))
    if kind == "halton":
        b = min(dim, len(rng.PRIMES) - 1)
        u = rng.radical_inverse(b, sample_idx) + rng.u32_to_float(rng.hash_combine(seed, pixel, 4096 + dim))
        return _wrap(u)
    s = rng.hash_combine(seed, pixel, 4096 + dim)
    return rng.van_der_corput(sample_idx, s)


# ---------------------------------------------------------------------------
# Halton global-index machinery (halton.rs:120-156)
# ---------------------------------------------------------------------------


def _inverse_radical(base: int, exp: int, value):
    """Index residue whose base-`base` radical inverse lands on `value`
    (reversed digits; halton.rs inverse_radical_inverse)."""
    inv = np.zeros_like(value)
    v = value.copy()
    for _ in range(exp):
        inv = inv * base + (v % base)
        v //= base
    return inv


def _ext(a, b):
    """(g, inverse of a mod b) by the iterative extended Euclid."""
    old_r, r = a, b
    old_s, s = 1, 0
    while r:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
    return old_r, old_s


def halton_tables(width: int, height: int, device="cpu"):
    """Per-pixel first-sample offsets and the stride of the Halton sampler
    (sampler.halton_tables): the film is tiled by 2^j x 3^k pixels, the
    scales at least min(W, 128) and min(H, 128) (halton.rs
    K_MAX_RESOLUTION), and the Chinese remainder theorem combines the
    per-axis residues into each pixel's global index offset. "offset" is an
    int64 tensor of uint32 values on `device`."""
    kmax = 128
    j = 0
    while (1 << j) < min(width, kmax):
        j += 1
    k = 0
    while 3 ** k < min(height, kmax):
        k += 1
    sx = 1 << j
    sy = 3 ** k
    stride = sx * sy
    ys, xs = np.mgrid[0:height, 0:width]
    px = (xs % sx).astype(np.int64).ravel()
    py = (ys % sy).astype(np.int64).ravel()
    off = _inverse_radical(2, j, px) * (stride // sx) * (_ext((stride // sx) % sx, sx)[1] % sx)
    off += _inverse_radical(3, k, py) * (stride // sy) * (_ext((stride // sy) % sy, sy)[1] % sy)
    off %= stride
    return {
        "offset": torch.as_tensor(off.astype(np.uint32).astype(np.int64), device=device),
        "stride": int(stride),
        "sx": sx,
        "sy": sy,
        "exp_x": j,
        "exp_y": k,
    }


def halton_index(aux, pixel_linear, sample_idx):
    """Global Halton index of sample `sample_idx` at a pixel (linear id)."""
    off = aux["offset"][pixel_linear.to(torch.int64)]
    return (off + rng._u32(sample_idx) * aux["stride"]) & MASK32


def halton_film_jitter(aux, pixel_linear, sample_idx):
    """In-pixel (jx, jy) of the Halton point: the fractional parts of
    ri_2 * 2^j and ri_3 * 3^k (halton.rs dims 0-1)."""
    idx = halton_index(aux, pixel_linear, sample_idx)
    x = rng.radical_inverse(0, idx) * aux["sx"]
    y = rng.radical_inverse(1, idx) * aux["sy"]
    return x - torch.floor(x), y - torch.floor(y)


def halton_dim_2d(aux, pixel_linear, sample_idx, dim: int):
    """2D Halton sample at the int dimension pair `dim` >= 1, with
    Faure-permuted digits (lowdiscrepancy.rs)."""
    idx = halton_index(aux, pixel_linear, sample_idx)
    b0 = min(2 * dim, len(rng.PRIMES) - 2)
    p0, p1 = (rng.device_table(f"faure_{b}", lambda: rng.faure_permutation(int(rng.PRIMES[b])), idx.device)
              for b in (b0, b0 + 1))
    return rng.scrambled_radical_inverse(b0, idx, p0), rng.scrambled_radical_inverse(b0 + 1, idx, p1)


# ---------------------------------------------------------------------------
# Sobol global film enumeration (sobol.rs:61-75 sobol_interval_to_index):
# the (index low bits) -> (pixel x, y bits) GF(2) map of the generator
# matrices, inverted by Gaussian elimination when the tables are built.
# ---------------------------------------------------------------------------


def _gf2_invert(cols, n):
    """cols: n ints, column j = output bits for input bit j (bit i of
    cols[j] = row i). Returns the inverse's columns, or None if singular."""
    rows = [0] * n
    for j in range(n):
        for i in range(n):
            if (cols[j] >> i) & 1:
                rows[i] |= 1 << j
    aug = [(rows[i], 1 << i) for i in range(n)]
    for c in range(n):
        piv = None
        for r in range(c, n):
            if (aug[r][0] >> c) & 1:
                piv = r
                break
        if piv is None:
            return None
        aug[c], aug[piv] = aug[piv], aug[c]
        for r in range(n):
            if r != c and (aug[r][0] >> c) & 1:
                aug[r] = (aug[r][0] ^ aug[c][0], aug[r][1] ^ aug[c][1])
    inv_rows = [aug[i][1] for i in range(n)]
    inv_cols = [0] * n
    for i in range(n):
        for j in range(n):
            if (inv_rows[i] >> j) & 1:
                inv_cols[j] |= 1 << i
    return inv_cols


def sobol_tables(width: int, height: int, spp: int):
    """Global-Sobol film enumeration tables, or None when the index would
    overflow 32 bits (the samples then come from per-pixel scrambled
    sequences, as in the reference)."""
    from ..core.sobolmat import matrix

    m = 0
    while (1 << m) < max(width, height):
        m += 1
    n_frame_bits = max(int(np.ceil(np.log2(max(spp, 1)))), 1) + 2
    if 2 * m + n_frame_bits > 31 or m == 0:
        return None
    cols0 = matrix(0)
    cols1 = matrix(1)

    def outbits(j):
        # x-pixel bits (low m) | y-pixel bits (high m)
        return (int(cols0[j]) >> (32 - m)) | ((int(cols1[j]) >> (32 - m)) << m)

    inv = _gf2_invert([outbits(j) for j in range(2 * m)], 2 * m)
    if inv is None:
        return None
    return {
        "m": m,
        "res": 1 << m,
        "inv_cols": tuple(inv),
        "delta_cols": tuple(outbits(2 * m + c) for c in range(n_frame_bits)),
        "n_frame_bits": n_frame_bits,
    }


def sobol_global_index(aux, px, py, sample_idx):
    """Global Sobol index whose dims (0, 1) land in pixel (px, py) at frame
    sample_idx (sampler.sobol_global_index)."""
    m = aux["m"]
    frame = rng._u32(sample_idx)
    delta = _xor_columns(frame, aux["delta_cols"], torch.zeros_like(frame))
    b = (rng._u32(px) | (rng._u32(py) << m)) ^ delta
    low = _xor_columns(b, aux["inv_cols"], torch.zeros_like(b))
    return ((frame << (2 * m)) & MASK32) | low


def sobol_film_jitter(aux, px, py, sample_idx):
    """In-pixel offsets of the global Sobol point for (pixel, frame)."""
    idx = sobol_global_index(aux, px, py, sample_idx)
    res = float(aux["res"])
    x = sobol_dim(idx, 0, 0) * res - px.to(torch.float32)
    y = sobol_dim(idx, 1, 0) * res - py.to(torch.float32)
    return torch.clamp(x, 0.0, 1.0 - 1e-6), torch.clamp(y, 0.0, 1.0 - 1e-6)


def sobol_dim_2d(aux, px, py, sample_idx, dim: int):
    """2D sample from the global Sobol sequence at the int dim pair >= 1."""
    idx = sobol_global_index(aux, px, py, sample_idx)
    return sobol_dim(idx, 2 * dim, 0), sobol_dim(idx, 2 * dim + 1, 0)


# ---------------------------------------------------------------------------
# MaxMinDist sampler (samplers/maxmindist.rs + lowdiscrepancy.rs:220): the
# generator matrices are searched when first needed, random invertible
# GF(2) maps scored by the minimum toroidal distance of (i/n, y(i)), as the
# reference searches them (same RandomState seeds, same candidates).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def maxmin_matrix(log2spp: int):
    """(log2spp,) uint32 generator columns for the y coordinate."""
    k = max(min(log2spp, 16), 0)
    n = 1 << k
    if k == 0:
        return (np.uint32(0x80000000),)
    rs = np.random.RandomState(0xC0FFEE + k)
    i = np.arange(n)
    x = (i + 0.5) / n

    def points_of(cols):
        y = np.zeros(n, np.uint64)
        for j in range(k):
            y = y ^ np.where((i >> j) & 1 > 0, np.uint64(cols[j]), np.uint64(0))
        return (y.astype(np.float64) / 2**32 + 0.5 / n) % 1.0

    def min_dist(y):
        dx = np.abs(x[:, None] - x[None, :])
        dx = np.minimum(dx, 1.0 - dx)
        dy = np.abs(y[:, None] - y[None, :])
        dy = np.minimum(dy, 1.0 - dy)
        d2 = dx * dx + dy * dy
        np.fill_diagonal(d2, np.inf)
        return float(np.sqrt(d2.min()))

    n_cand = 600 if k <= 6 else (120 if k <= 9 else 24)
    best, best_d = None, -1.0
    for _ in range(n_cand):
        # random invertible k x k bit matrix on the top k output bits
        while True:
            mat = [int(rs.randint(0, n)) for _ in range(k)]
            if _gf2_invert([m_ & (n - 1) for m_ in mat], k) is not None:
                break
        cols = tuple(np.uint32((m_ & (n - 1)) << (32 - k)) for m_ in mat)
        d = min_dist(points_of(cols))
        if d > best_d:
            best, best_d = cols, d
    return best


def maxmin_2d_dim0(seed, pixel, sample_idx, spp: int):
    """Film-dimension pair of the MaxMinDist sampler: x = i/n, Cranley-
    Patterson rotated per pixel; y from the searched generator matrix,
    XOR-scrambled per pixel."""
    k = max(int(math.ceil(math.log2(max(spp, 1)))), 0)
    n = 1 << k
    i = rng._u32(sample_idx) % n
    y = _xor_columns(i, maxmin_matrix(k), torch.zeros_like(i))
    y = y ^ rng.hash_combine(seed, pixel, 0x51D)
    u1 = (i.to(torch.float32) + 0.5) / n + rng.u32_to_float(rng.hash_combine(seed, pixel, 0xC9))
    return _wrap(u1), rng.u32_to_float(y)
