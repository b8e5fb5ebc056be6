"""Sobol' generator matrices, constructed algorithmically at host time.

The reference ships 27k lines of precomputed tables
(src/core/sobolmatrices.rs, NUM_SOBOL_DIMENSIONS=1024 over 52-bit
matrices). We derive equivalent 32-bit generator matrices from first
principles instead of shipping data:

- primitive polynomials over GF(2) are enumerated by degree and tested for
  primitivity (irreducible + x has order 2^d - 1 in GF(2)[x]/p), exactly
  the classical Sobol construction;
- initial direction numbers m_1..m_d are SEARCHED per dimension in the
  Joe-Kuo spirit: a deterministic candidate stream of odd m_i < 2^i is
  scored by exact 2-D elementary-interval stratification (the
  (0, m, 2)-net property over every 2^a x 2^b split of the first 2^10
  points) against the van der Corput dimension and the nearest preceding
  dimensions — the projections that dominate rendering integrands (film
  x first-bounce, consecutive bounce pairs). This reproduces what the
  published Joe-Kuo D(6) tables optimize (joint 2-D t-values) without
  shipping their data; the renderer additionally XOR-scrambles per
  pixel, which further decorrelates the remaining projections.

Matrices are cached per dimension; `matrix(d)` returns a (32,) uint32
column vector array v_j = m_j << (32 - j).

The port's copy of ``pbrt_tpu/core/sobolmat.py``, with its own copy of the
packaged table ``_sobol32_data.npy``; it reads and writes no cache outside
the package.
"""
from __future__ import annotations

import functools

import numpy as np

N_BITS = 32


def _poly_mulmod(a: int, b: int, p: int, d: int) -> int:
    """(a*b) mod p over GF(2), p of degree d."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> d & 1:
            a ^= p
    return r


def _poly_powmod(a: int, e: int, p: int, d: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = _poly_mulmod(r, a, p, d)
        a = _poly_mulmod(a, a, p, d)
        e >>= 1
    return r


def _prime_factors(n: int) -> list[int]:
    out = []
    f = 2
    while f * f <= n:
        if n % f == 0:
            out.append(f)
            while n % f == 0:
                n //= f
        f += 1
    if n > 1:
        out.append(n)
    return out


@functools.lru_cache(maxsize=None)
def _mersenne_factors(d: int) -> tuple:
    return tuple(_prime_factors((1 << d) - 1))


def _is_primitive(p: int, d: int) -> bool:
    """p (bitmask incl. x^d term) primitive over GF(2)?"""
    order = (1 << d) - 1
    # x^order == 1 mod p (implies p | x^order - 1; combined with the
    # subgroup checks below this gives primitivity for squarefree p)
    if _poly_powmod(2, order, p, d) != 1:
        return False
    for q in _mersenne_factors(d):
        if _poly_powmod(2, order // q, p, d) == 1:
            return False
    return True


@functools.lru_cache(maxsize=None)
def _primitive_polys(count: int) -> tuple:
    """First `count` primitive polynomials as (degree, a-coeff bits) where
    the a bits are the coefficients of x^{d-1}..x^1 (constant term is 1)."""
    out = []
    d = 1
    while len(out) < count:
        for a in range(1 << (d - 1)):
            p = (1 << d) | (a << 1) | 1
            if _is_primitive(p, d):
                out.append((d, a))
                if len(out) == count:
                    break
        d += 1
    return tuple(out)


def _hash64(x: int) -> int:
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _cols_from_initial(dim: int, m_init: tuple) -> np.ndarray:
    """Expand initial direction numbers through the primitive-polynomial
    recurrence into the (32,) uint32 column vector."""
    d, a = _primitive_polys(dim)[dim - 1]
    m = [0] * (N_BITS + 1)
    for i in range(1, d + 1):
        m[i] = m_init[i - 1]
    for k in range(d + 1, N_BITS + 1):
        v = m[k - d] ^ (m[k - d] << d)
        for j in range(1, d):
            if (a >> (d - 1 - j)) & 1:
                v ^= m[k - j] << j
        m[k] = v
    cols = np.zeros(N_BITS, np.uint32)
    for j in range(1, N_BITS + 1):
        cols[j - 1] = np.uint32((m[j] << (N_BITS - j)) & 0xFFFFFFFF)
    return cols


_SCORE_LOG2N = 10  # score over the first 2^10 points


def _points_10bit(cols: np.ndarray) -> np.ndarray:
    """Top-10-bit values of the first 2^10 Sobol points of one dimension."""
    n = 1 << _SCORE_LOG2N
    i = np.arange(n, dtype=np.uint32)
    x = np.zeros(n, np.uint64)
    for j in range(_SCORE_LOG2N):
        x ^= np.where((i >> j) & 1 > 0, np.uint64(int(cols[j])), np.uint64(0))
    return (x >> np.uint64(32 - _SCORE_LOG2N)).astype(np.int64)  # in [0, 2^10)


def _pair_deficiency(xa: np.ndarray, xb: np.ndarray, log2n: int = _SCORE_LOG2N) -> int:
    """Exact 2-D stratification deficiency of the pair over the first
    2^log2n points: for every elementary split 2^a x 2^b (a+b=log2n),
    count cells not holding exactly one point. 0 == the pair is a
    (0, log2n, 2)-net in base 2 (t-value 0 at this resolution)."""
    n = 1 << log2n
    sh = _SCORE_LOG2N - log2n
    xa = xa[:n] >> sh
    xb = xb[:n] >> sh
    bad = 0
    for a in range(log2n + 1):
        b = log2n - a
        cell = (xa >> (log2n - a)) * (1 << b) + (xb >> (log2n - b))
        occ = np.bincount(cell, minlength=n)
        # near-square splits dominate rendering integrands (area-light /
        # BSDF warps use both coordinates at comparable resolution), so
        # weight each split by 1 + min(a, b): a candidate that is perfect
        # on the skewed splits but collapses on the square one must lose
        bad += (1 + min(a, b)) * int(np.sum(occ != 1))
    return bad


@functools.lru_cache(maxsize=None)
def matrix(dim: int) -> np.ndarray:
    """32-bit generator matrix columns for Sobol dimension `dim` (0-based).

    Initial direction numbers are searched (Joe-Kuo-style): 48 candidate
    m-vectors from a deterministic hash stream, scored by exact 2-D
    stratification against dim 0 (van der Corput) and the two preceding
    dimensions; ties keep the earliest candidate, so the construction is
    stable and reproducible."""
    if dim == 0:
        # van der Corput: identity matrix
        return (np.uint32(1) << (N_BITS - 1 - np.arange(N_BITS, dtype=np.uint32))).astype(np.uint32)
    cached = _disk_cache_get(dim)
    if cached is not None:
        return cached
    d, _a = _primitive_polys(dim)[dim - 1]
    # the sampler consumes dims as (2k, 2k+1) pairs (sample_2d), so the
    # even-odd partner dominates the score for odd dims; dim 0 covers the
    # film/first-bounce projections, dim-2 the cross-pair correlations
    partners = [(matrix(0), 1)]
    if dim >= 2:
        partners.append((matrix(dim - 1), 8 if dim % 2 == 1 else 1))
    if dim >= 3:
        partners.append((matrix(dim - 2), 1))
    partner_pts = [(_points_10bit(c), w) for c, w in partners]

    # candidate space: all (m_1..m_d) with odd m_i < 2^i has
    # 2^(d(d-1)/2) members — exhaustive through degree 5, hashed
    # subsampling beyond
    space = 1 << (d * (d - 1) // 2)
    n_cand = space if d <= 5 else (4096 if d <= 7 else 1024)

    def cand_init(c):
        if d <= 5:
            # enumerate: bits of c select the free (non-low) bits of each m_i
            ms, shift = [], 0
            for i in range(1, d + 1):
                free = i - 1
                ms.append((((c >> shift) & ((1 << free) - 1)) << 1) | 1)
                shift += free
            return tuple(ms)
        return tuple(
            (_hash64(dim * 1315423911 + i * 2654435761 + c * 97531) % (1 << i)) | 1
            for i in range(1, d + 1))

    # square-split deficiency (missing cells of the g x g grid over the
    # first g^2 points) is the term that tracks rendering variance at
    # production spp; it DOMINATES the score, with the all-splits
    # deficiency as tiebreak. Weights favor the spp 64-256 regime.
    _SQ = ((16, 4, 4), (64, 8, 4), (256, 16, 4), (1024, 32, 2))

    def sq_def(pa, pb):
        tot = 0
        for n, g, w in _SQ:
            import math

            sh = _SCORE_LOG2N - int(math.log2(g))
            cell = (pa[:n] >> sh) * g + (pb[:n] >> sh)
            tot += w * (n - len(np.unique(cell)))
        return tot

    best, best_score = None, None
    for c in range(n_cand):
        cols = _cols_from_initial(dim, cand_init(c))
        pts = _points_10bit(cols)
        score = 0
        for pp, w in partner_pts:
            score += w * (1000 * sq_def(pp, pts)
                          + _pair_deficiency(pp, pts)
                          + 4 * _pair_deficiency(pp, pts, log2n=8))
            if best_score is not None and score >= best_score:
                break
        if best_score is None or score < best_score:
            best, best_score = cols, score
            if score == 0:
                break
    return best


_packaged = None


def _disk_cache_get(dim: int):
    """Generator columns of `dim` from the packaged table, else None. The
    search is deterministic, so shipping its output for the first 64
    dimensions trades ~90 s of first-render latency for an 8 KB data file;
    later dimensions are searched once per process (``matrix`` caches)."""
    global _packaged
    if _packaged is None:
        import os

        arr = np.load(os.path.join(os.path.dirname(__file__), "_sobol32_data.npy"))
        _packaged = {i: arr[i] for i in range(arr.shape[0]) if arr[i].any()}
    return _packaged.get(dim)
