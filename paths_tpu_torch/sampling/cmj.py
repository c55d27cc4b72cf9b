"""Correlated Multi-Jittered sampling (port of ``paths_tpu/sampling/cmj.py``,
bit-exact).

Reference: src/sampling.rs:166-265.  Upstream's ``permute`` guards its
scramble loop with ``while i > l`` and every call site passes ``i < l``, so
it reduces to ``(i + p) % l``; the jitter hash ``rand_float`` is the full
Pixar hash.  Words are int64 tensors in [0, 2^32), as in ``hashing``.
"""

from __future__ import annotations

import math

import torch

from paths_tpu_torch.math import vec
from paths_tpu_torch.sampling.hashing import MASK32, as_u32, mul32


def permute(i: torch.Tensor, l, p: torch.Tensor) -> torch.Tensor:
    """sampling.rs:187-210 with i < l: ``(i + p) % l`` in u32."""
    return ((i + p) & MASK32) % l


def rand_float(i: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Pixar jitter hash, sampling.rs:212-221; the final scale is
    i * (1/4294967808) in f32."""
    i = i ^ p
    i = i ^ (i >> 17)
    i = i ^ (i >> 10)
    i = mul32(i, 0xB36534E5)
    i = i ^ (i >> 12)
    i = i ^ (i >> 21)
    i = mul32(i, 0x93FC4795)
    i = i ^ 0xDF6E307F
    i = i ^ (i >> 17)
    i = (i * (1 | (p >> 18))) & MASK32  # factor < 2^14: no overflow
    return i.to(torch.float32) * (1.0 / 4294967808.0)


def cmj(s, m: int, n: int, p):
    """The CMJ point for sample s of an m x n pattern with seed p
    (sampling.rs:226-235).  Returns (x, y) in [0,1)^2 as f32."""
    s = as_u32(s)
    p = as_u32(p)
    mn = (m * n) & MASK32
    ps = permute(s, mn, mul32(p, 0xA73BD290))
    sx = permute(ps % m, m, mul32(p, 0xA511E9B3)).to(torch.float32)
    sy = permute(ps // m, n, mul32(p, 0x63D83595)).to(torch.float32)
    jx = rand_float(s, mul32(p, 0xA399D265))
    jy = rand_float(s, mul32(p, 0x711AD6A5))
    x = ((s % m).to(torch.float32) + (sy + jx) / float(n)) / float(m)
    y = ((s // m).to(torch.float32) + (sx + jy) / float(m)) / float(n)
    return x, y


def cmj_disk(s, m, n, p):
    """Disk-domain pattern (sampling.rs:250-265): theta = 2 pi x,
    r = sqrt(y)."""
    return to_disk(*cmj(s, m, n, p))


def to_disk(x, y):
    """A square point's polar map onto the unit disk (sampling.rs:250-265):
    theta = 2 pi x, r = sqrt(y)."""
    theta = (2.0 * math.pi) * x
    r = vec.sqrt(y)
    return r * torch.cos(theta), r * torch.sin(theta)
