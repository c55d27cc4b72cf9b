"""Counter-based per-lane RNG for shading decisions (port of
``paths_tpu/sampling/hashing.py``, bit-exact).

Every uniform is a pure hash of (seed, pixel_id, sample_id, bounce,
dimension), so renders are deterministic and independent of lane order or
device.  The mixer is murmur3's 32-bit finalizer chained over the key
words.

PyTorch's uint32 op coverage is thin, so words are carried as int64 holding
values in [0, 2^32).  A product of two 32-bit words can exceed int64, so
``mul32`` splits the multiplier into 16-bit halves and keeps only the low 32
bits of each partial product.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# Dimension slots per bounce (keep in sync with integrator.py).
DIM_LIGHT_PICK = 0
DIM_LIGHT_U = 1
DIM_LIGHT_V = 2
DIM_LOBE = 3
DIM_BSDF_U = 4
DIM_BSDF_V = 5
DIM_RR = 6
DIM_ENV_CDF = 7
DIM_ENV_JX = 8
DIM_ENV_JY = 9
DIMS_PER_BOUNCE = 10


def as_u32(x, device=None) -> torch.Tensor:
    """A u32 word (int, numpy array or tensor) as an int64 tensor in
    [0, 2^32)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def mul32(a: torch.Tensor, c) -> torch.Tensor:
    """(a * c) mod 2^32 for a word tensor a and a word c (int or tensor)
    without int64 overflow."""
    c_lo, c_hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (a * c_lo + (((a * c_hi) & 0xFFFF) << 16)) & MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash_u32(*keys) -> torch.Tensor:
    """Mix any number of u32 keys (ints or tensors) into one u32 word, on the
    device of the tensor keys."""
    device = next((k.device for k in keys if isinstance(k, torch.Tensor)), None)
    h = as_u32(0x9E3779B9, device)
    for k in keys:
        k = as_u32(k, device)
        h = _fmix32((mul32(h ^ k, 0x85EBCA6B) + 0xE6546B64) & MASK32)
    return h


def uniform(*keys) -> torch.Tensor:
    """U[0,1) from hashed keys: the top 24 bits, exact in f32."""
    bits = hash_u32(*keys)
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def shading_uniform(seed, lane_key, bounce, dim):
    """The canonical shading-decision uniform: a pure function of the path
    identity (lane_key = pixel*S + sample), bounce index and dimension."""
    ctr = (mul32(as_u32(bounce), DIMS_PER_BOUNCE) + dim) & MASK32
    return uniform(seed, lane_key, ctr)
