"""Batched EFloat interval arithmetic (src/core/efloat.rs).

The port's counterpart of ``pbrt_tpu/device/efloat.py``, with its choices:
every operation widens the interval by +/- 2 eps |x| (which contains the
reference's one-ulp next_float_down/up), exact zeros stay zero, and the
quadratic's discriminant is an interval computed in float32 (efloat.rs:211
uses float64). Values are (v, lo, hi) triples of same-shape float32
tensors; only the operations the sphere test needs are here.
"""
from __future__ import annotations

import torch

from .affine import xf_vector

# 2 * machine epsilon for float32 (directed-rounding inflation factor)
_TWO_EPS = float(2.0 * 2.0 ** -23)
# gamma(3) = 3 eps / (1 - 3 eps), eps = 2^-24 (pbrt.rs gamma)
_GAMMA3 = float(torch.tensor(3.0 * 2.0 ** -24 / (1.0 - 3.0 * 2.0 ** -24), dtype=torch.float32))


def _down(x):
    return x - x.abs() * _TWO_EPS


def _up(x):
    return x + x.abs() * _TWO_EPS


def ef(v, err=None):
    """EFloat::new(v, err): exact where err is None (efloat.rs:12-25)."""
    if err is None:
        return (v, v, v)
    return (v, _down(v - err), _up(v + err))


def add(a, b):
    av, alo, ahi = a
    bv, blo, bhi = b
    return (av + bv, _down(alo + blo), _up(ahi + bhi))


def sub(a, b):
    av, alo, ahi = a
    bv, blo, bhi = b
    return (av - bv, _down(alo - bhi), _up(ahi - blo))


def mul(a, b):
    av, alo, ahi = a
    bv, blo, bhi = b
    p00 = alo * blo
    p01 = alo * bhi
    p10 = ahi * blo
    p11 = ahi * bhi
    lo = torch.minimum(torch.minimum(p00, p01), torch.minimum(p10, p11))
    hi = torch.maximum(torch.maximum(p00, p01), torch.maximum(p10, p11))
    return (av * bv, _down(lo), _up(hi))


def div(a, b):
    """Interval division; a divisor interval straddling 0 gives [-inf, inf]
    (efloat.rs Div)."""
    av, alo, ahi = a
    bv, blo, bhi = b
    straddle = (blo <= 0.0) & (bhi >= 0.0)
    safe_blo = torch.where(straddle, 1.0, blo)
    safe_bhi = torch.where(straddle, 1.0, bhi)
    q00 = alo / safe_blo
    q01 = alo / safe_bhi
    q10 = ahi / safe_blo
    q11 = ahi / safe_bhi
    lo = torch.minimum(torch.minimum(q00, q01), torch.minimum(q10, q11))
    hi = torch.maximum(torch.maximum(q00, q01), torch.maximum(q10, q11))
    lo = torch.where(straddle, -float("inf"), _down(lo))
    hi = torch.where(straddle, float("inf"), _up(hi))
    vv = av / torch.where(bv != 0.0, bv, 1e-30)
    return (vv, lo, hi)


def sqr(a):
    """a*a with the tighter same-operand bounds (an interval square is >= 0)."""
    av, alo, ahi = a
    m0 = alo * alo
    m1 = ahi * ahi
    lo = torch.minimum(m0, m1)
    hi = torch.maximum(m0, m1)
    crosses = (alo <= 0.0) & (ahi >= 0.0)
    lo = torch.where(crosses, 0.0, lo)
    return (av * av, _down(lo), _up(hi))


def neg(a):
    av, alo, ahi = a
    return (-av, -ahi, -alo)


def scale(a, s):
    """Multiply by an exact scalar or tensor s."""
    return mul(a, ef(s))


def quadratic(a, b, c):
    """EFloat quadratic solve (efloat.rs:211-233).

    Returns (has_root, t0, t1) with t0 <= t1 by value; each t a (v, lo, hi)
    triple. has_root is False where the float32 discriminant is negative."""
    av = a[0]
    bv = b[0]
    cv = c[0]
    disc = bv * bv - 4.0 * av * cv
    has = disc >= 0.0
    rd = torch.sqrt(torch.clamp(disc, min=0.0))
    # the discriminant's interval, through the products and the square root
    e_disc = sub(sqr(b), mul(mul(ef(4.0), a), c))
    frd = (rd, torch.sqrt(torch.clamp(e_disc[1], min=0.0)), torch.sqrt(torch.clamp(e_disc[2], min=0.0)))
    q_neg = mul(sub(b, frd), ef(-0.5))
    q_pos = mul(add(b, frd), ef(-0.5))
    is_neg = bv < 0.0
    q = tuple(torch.where(is_neg, n, p) for n, p in zip(q_neg, q_pos))
    t0 = div(q, a)
    t1 = div(c, q)
    swap = t0[0] > t1[0]
    lo_t = tuple(torch.where(swap, x1, x0) for x0, x1 in zip(t0, t1))
    hi_t = tuple(torch.where(swap, x0, x1) for x0, x1 in zip(t0, t1))
    return has, lo_t, hi_t


def transform_ray_error(w2o, o, d):
    """Float error of transforming an exact world ray into object space
    (transform.rs transform_point_error :433 and the vector error):
    o_err = gamma(3) (|M||o| + |m_t|), d_err = gamma(3) |M||d|.
    w2o: (..., 3, 4); o, d: (..., 3). Returns (o_err, d_err)."""
    abs_m = w2o[..., :3].abs()
    o_err = _GAMMA3 * (xf_vector(abs_m, o.abs()) + w2o[..., 3].abs())
    d_err = _GAMMA3 * xf_vector(abs_m, d.abs())
    return o_err, d_err
