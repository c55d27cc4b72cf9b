"""Double-single (two-float) arithmetic (port of ``paths_tpu/math/ds.py``).

The bundled scenes model ground planes as spheres of radius 1e6, where a
plain f32 quadratic loses about five decimal digits to cancellation.  The
few critical scalars of the sphere test are carried as unevaluated (hi, lo)
f32 pairs, giving about 48 effective mantissa bits.

Classic error-free transforms (Dekker 1971, Knuth TAOCP vol. 2).  No fused
multiply-add is assumed, so products are split Dekker-style.  Every step is
a separate eager tensor op: PyTorch does not contract them into FMAs.  Never
``torch.compile`` this module -- contraction would break the transforms.
"""

from __future__ import annotations

import torch

from paths_tpu_torch.math.vec import sqrt as _sqrt_f32

_SPLITTER = 4097.0  # 2^12 + 1 Dekker split


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split: a = hi + lo, each with <= 12 mantissa bits."""
    t = _SPLITTER * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (no FMA required)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ds(hi, lo=None):
    if lo is None:
        lo = torch.zeros_like(hi)
    return hi, lo


def add(x, y):
    """(hi,lo) + (hi,lo)."""
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return fast_two_sum(s, e)


def sub(x, y):
    return add(x, (-y[0], -y[1]))


def mul(x, y):
    p, e = two_prod(x[0], y[0])
    e = e + x[0] * y[1] + x[1] * y[0]
    return fast_two_sum(p, e)


def sqr(x):
    return mul(x, x)


def neg(x):
    return (-x[0], -x[1])


def to_f32(x):
    return x[0] + x[1]


def sqrt(x):
    """Double-single sqrt via one Newton step on the f32 estimate."""
    hi, lo = x
    s = _sqrt_f32(hi)
    p, e = two_prod(s, s)
    r = (hi - p) - e + lo
    safe_s = torch.where(s > 0, s, torch.ones_like(s))
    corr = r / (2.0 * safe_s)
    corr = torch.where(s > 0, corr, torch.zeros_like(corr))
    return fast_two_sum(s, corr)
