"""Stateless counter-based RNG and (0,2)-sequence samples, bit-exact with
``pbrt_tpu/device/rng.py``.

Every sample is a pure function of (seed, pixel, sample index, dimension),
so the port draws exactly the reference's numbers with no generator state.
Torch has few uint32 operations, so uint32 values ride in int64 tensors and
are masked to 32 bits after every multiply, add and left shift; the
products below stay under 2^63, so int64 never overflows.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
ONE_MINUS_EPS = float(np.float32(1.0 - 2.0 ** -24))
_INV_2_32 = 2.3283064365386963e-10  # 0x1p-32, exact in f32


def _u32(x):
    """uint32 value of x as an int64 tensor (or a Python int for ints)."""
    if isinstance(x, int):
        return x & MASK32
    return x.to(torch.int64) & MASK32


def pcg_hash(x):
    """PCG output permutation as an integer hash (one round), mod 2^32.

    Mirrors the reference's PCG32 core (src/core/rng.rs:6-67) used as a
    stateless mixer; standard pcg_hash from Jarzynski & Olano."""
    x = _u32(x)
    if isinstance(x, int):
        x = torch.tensor(x, dtype=torch.int64)
    state = (x * 747796405 + 2891336453) & MASK32
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def hash_combine(*xs):
    h = 0x9E3779B9
    for x in xs:
        h = pcg_hash(h ^ _u32(x))
    return h


def u32_to_float(u):
    """uint32 -> [0, 1) float32 (matches reference one_minus_epsilon clamp)."""
    f = u.to(torch.float32) * _INV_2_32
    return torch.clamp(f, max=ONE_MINUS_EPS)


def uniform_1d(seed, pixel, sample, dim):
    return u32_to_float(hash_combine(seed, pixel, sample, dim))


def reverse_bits_32(x):
    x = _u32(x)
    x = ((x << 16) & MASK32) | (x >> 16)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    return x


def van_der_corput(index, scramble):
    """Base-2 radical inverse with XOR scramble (lowdiscrepancy.rs)."""
    return u32_to_float(reverse_bits_32(index) ^ _u32(scramble))


def _sobol2_matrix():
    v = []
    a = 1 << 31
    for _ in range(32):
        v.append(a)
        a ^= a >> 1
    return v


_SOBOL2 = _sobol2_matrix()


def sobol_2nd_dim(index, scramble):
    """Second component of the (0,2)-sequence via generator-matrix multiply."""
    index = _u32(index)
    result = _u32(scramble)
    for i in range(32):
        bit = (index >> i) & 1
        result = result ^ (bit * _SOBOL2[i])
    return u32_to_float(result)


def sample_02(index, scramble_x, scramble_y):
    """One point of the scrambled (0,2)-sequence (ZeroTwoSequence sampler,
    src/samplers/zerotwosequence.rs)."""
    return van_der_corput(index, scramble_x), sobol_2nd_dim(index, scramble_y)


# ---------------------------------------------------------------------------
# Halton: scrambled radical inverse over prime bases
# (src/core/lowdiscrepancy.rs radical_inverse + pbrt_macros specialization)
# ---------------------------------------------------------------------------

PRIMES = np.array(
    [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
     73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149, 151,
     157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229, 233,
     239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311, 313, 317,
     331, 337, 347, 349, 353, 359, 367, 373, 379, 383, 389, 397, 401, 409, 419,
     421, 431, 433, 439, 443, 449, 457, 461, 463, 467, 479, 487, 491, 499, 503,
     509, 521, 523, 541], dtype=np.int64)


_DEVICE_TABLES: dict = {}


def device_table(name: str, make, device):
    """The host array make() as an int64 tensor on `device`, made and copied
    there once per (name, device)."""
    key = (name, str(device))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = _DEVICE_TABLES[key] = torch.as_tensor(np.asarray(make(), np.int64), device=device)
    return t


def radical_inverse_dyn(base_index, index):
    """Radical inverse with a per-lane base index (rng.radical_inverse_dyn):
    32 digit steps in float32, a lane's digits ending when its index
    reaches 0."""
    primes = device_table("primes", lambda: PRIMES, index.device)
    b = primes[torch.clamp(base_index.to(torch.int64), 0, len(PRIMES) - 1)]
    index = _u32(index)
    bf = b.to(torch.float32)
    inv_base = 1.0 / bf
    shape = torch.broadcast_shapes(index.shape, b.shape)
    reversed_digits = torch.zeros(shape, dtype=torch.float32, device=index.device)
    inv_base_n = torch.ones_like(reversed_digits)
    for _ in range(32):
        next_i = index // b
        digit = index - next_i * b
        has = index > 0
        reversed_digits = torch.where(has, reversed_digits * bf + digit.to(torch.float32), reversed_digits)
        inv_base_n = torch.where(has, inv_base_n * inv_base, inv_base_n)
        index = next_i
    return torch.clamp(reversed_digits * inv_base_n, max=ONE_MINUS_EPS)


def _n_digits(b: int) -> int:
    return int(np.floor(np.log(2.0 ** 32) / np.log(b))) + 1


def radical_inverse(base_index: int, index):
    """Radical inverse of `index` in PRIMES[base_index] (a fixed base),
    accumulated in float32 as the reference does."""
    b = int(PRIMES[base_index])
    if b == 2:
        return u32_to_float(reverse_bits_32(index))
    index = _u32(index)
    inv_base = float(np.float32(1.0 / b))
    reversed_digits = torch.zeros(index.shape, dtype=torch.float32, device=index.device)
    inv_base_n = torch.ones_like(reversed_digits)
    for _ in range(_n_digits(b)):
        next_i = index // b
        digit = index - next_i * b
        has = index > 0
        reversed_digits = torch.where(has, reversed_digits * b + digit.to(torch.float32), reversed_digits)
        inv_base_n = torch.where(has, inv_base_n * inv_base, inv_base_n)
        index = next_i
    return torch.clamp(reversed_digits * inv_base_n, max=ONE_MINUS_EPS)


def scrambled_radical_inverse(base_index: int, index, perm):
    """Scrambled radical inverse: perm is a (base,) digit permutation tensor
    on index's device (lowdiscrepancy.rs scrambled_radical_inverse), with the limit term of
    the infinite tail of permuted zero digits."""
    b = int(PRIMES[base_index])
    index = _u32(index)
    inv_base32 = np.float32(1.0 / b)
    inv_base = float(inv_base32)
    permf = perm.to(torch.float32)
    reversed_digits = torch.zeros(index.shape, dtype=torch.float32, device=index.device)
    inv_base_n = torch.ones_like(reversed_digits)
    for _ in range(_n_digits(b)):
        next_i = index // b
        digit = index - next_i * b
        has = index > 0
        reversed_digits = torch.where(has, reversed_digits * b + permf[digit], reversed_digits)
        inv_base_n = torch.where(has, inv_base_n * inv_base, inv_base_n)
        index = next_i
    tail = inv_base_n * permf[0] * inv_base / float(np.float32(1.0) - inv_base32)
    return torch.clamp(reversed_digits * inv_base_n + tail, max=ONE_MINUS_EPS)


def faure_permutation(b: int) -> np.ndarray:
    """Deterministic digit permutation (identity-free), host side."""
    if b == 2:
        return np.array([0, 1], dtype=np.int32)
    if b % 2 == 0:
        h = faure_permutation(b // 2)
        return np.concatenate([2 * h, 2 * h + 1]).astype(np.int32)
    c = (b - 1) // 2
    p = faure_permutation(b - 1)
    p = np.where(p >= c, p + 1, p)
    return np.concatenate([p[:c], [c], p[c:]]).astype(np.int32)
