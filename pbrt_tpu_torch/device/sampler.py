"""Per-ray sample streams, bit-exact with ``pbrt_tpu/device/sampler.py``
for the "zerotwosequence" (and its alias "lowdiscrepancy"), "random" and
"stratified" samplers.

``dim`` is a Python int (film and lens dimensions) or an integer tensor
(the per-lane bounce dimensions of the persistent loop); both give the same
bits as the reference. The stratified sampler stratifies the int
dimensions: the film pair by the sample index, every other dimension with
a per-(pixel, dimension) rotation of the strata; tensor dimensions draw
from the random stream, as the reference's do.

``strata`` is the declared stratified shape (x_samples, y_samples, jitter)
(stratified.rs:121-131). The reference keeps it in a module global set by
render_compiled; the port passes it along in the sampler config. It is used
when x_samples * y_samples == spp, else the shape is floor(sqrt(spp)) x
spp // that, jittered.
"""
from __future__ import annotations

import math

from . import rng

SAMPLER_KINDS = ("zerotwosequence", "lowdiscrepancy", "random", "stratified")


def _check(kind: str):
    if kind not in SAMPLER_KINDS:
        raise NotImplementedError(f"pbrt_tpu_torch does not support the '{kind}' sampler yet")


def stratified_shape(spp: int, strata=None) -> tuple[int, int, bool]:
    """(xs, ys, jitter) of the stratified sampler (sampler.stratified_shape)."""
    if strata is not None and strata[0] * strata[1] == spp:
        return int(strata[0]), int(strata[1]), bool(strata[2])
    xs = max(int(math.floor(math.sqrt(spp))), 1)
    return xs, max(spp // xs, 1), True if strata is None else bool(strata[2])


def sample_2d(kind: str, seed, pixel, sample_idx, dim, spp: int, strata=None):
    """One 2D sample (u1, u2) per lane."""
    _check(kind)
    if kind in ("random", "stratified"):
        u1 = rng.uniform_1d(seed, pixel, sample_idx, 2 * dim)
        u2 = rng.uniform_1d(seed, pixel, sample_idx, 2 * dim + 1)
        if kind == "stratified" and isinstance(dim, int):
            # jittered strata on every int dimension pair; the strata order
            # rotates per (pixel, dim) past the film pair (uint32 sums)
            xs, ys, jitter = stratified_shape(spp, strata)
            idx = rng._u32(sample_idx)
            if dim != 0:
                idx = ((idx + rng.hash_combine(seed, pixel, 7919 * dim)) & rng.MASK32) % max(xs * ys, 1)
            sx = (idx % xs).float()
            sy = ((idx // xs) % ys).float()
            if not jitter:  # stratum centres
                u1 = u1.new_full(u1.shape, 0.5)
                u2 = u2.new_full(u2.shape, 0.5)
            u1 = (sx + u1) / xs
            u2 = (sy + u2) / ys
        return u1, u2
    # (0,2)-sequence: per-(pixel, dim-pair) scramble, index = sample
    s1 = rng.hash_combine(seed, pixel, 2 * dim)
    s2 = rng.hash_combine(seed, pixel, 2 * dim + 1)
    return rng.sample_02(sample_idx, s1, s2)


def sample_1d(kind: str, seed, pixel, sample_idx, dim, spp: int, strata=None):
    _check(kind)
    if kind == "stratified" and isinstance(dim, int):
        # 1D jittered strata with a per-(pixel, dim) rotation
        _xs, _ys, jitter = stratified_shape(spp, strata)
        rot = rng.hash_combine(seed, pixel, 104729 + 7919 * dim)
        idx = ((rng._u32(sample_idx) + rot) & rng.MASK32) % max(spp, 1)
        u = rng.uniform_1d(seed, pixel, sample_idx, 1024 + dim)
        if not jitter:
            u = u.new_full(u.shape, 0.5)
        return (idx.float() + u) / max(spp, 1)
    if kind in ("random", "stratified"):
        return rng.uniform_1d(seed, pixel, sample_idx, 1024 + dim)
    s = rng.hash_combine(seed, pixel, 4096 + dim)
    return rng.van_der_corput(sample_idx, s)
