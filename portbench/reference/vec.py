"""Vector math over (..., 3) tensors (port of ``paths_tpu/math/vec.py``).

Reference: src/vector.rs:4-81.  Every function vectorises over arbitrary
leading batch dimensions, so a "vector" is a lane of a wavefront.
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root.  PyTorch's vectorised float32 sqrt on
    the CPU is accurate to about half an ulp but not correctly rounded (it
    differs from IEEE sqrt in the last bit for about 0.7% of inputs), which
    breaks the double-single transforms and bit parity with the reference;
    rounding the float64 root once is exact.  CUDA's sqrt is IEEE."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis (vector.rs:23-25)."""
    return torch.sum(a * b, dim=-1)


def dot_keep(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product (vector.rs:43-49)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def norm_sq(a: torch.Tensor) -> torch.Tensor:
    """Squared length (the reference's ``magnitude()``, vector.rs:27-29)."""
    return dot(a, a)


def length(a: torch.Tensor) -> torch.Tensor:
    return sqrt(norm_sq(a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Unit vector (vector.rs:39-41); 0-vectors give inf/nan as upstream."""
    return a / sqrt(norm_sq(a))[..., None]


def normalize_safe(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return a / sqrt(torch.clamp_min(norm_sq(a), eps))[..., None]


def max_component(a: torch.Tensor) -> torch.Tensor:
    return torch.amax(a, dim=-1)


def min_component(a: torch.Tensor) -> torch.Tensor:
    return torch.amin(a, dim=-1)


def form_basis(n: torch.Tensor):
    """Orthonormal frame (i, j, k) with j == n (vector.rs:51-61): i =
    normalize(n x +Y) unless n.x == 0 exactly, then i = +X; k = i x j."""
    j = n
    up = torch.zeros_like(n)
    up[..., 1] = 1.0
    generic = cross(j, up)
    degenerate = torch.abs(n[..., 0]) == 0.0
    x_axis = torch.zeros_like(n)
    x_axis[..., 0] = 1.0
    i = torch.where(degenerate[..., None], x_axis, normalize_safe(generic))
    k = cross(i, j)
    return i, j, k


def switch_basis(v, i, j, k):
    """Express local vector v in the world frame (geom.rs:26-28)."""
    return i * v[..., 0:1] + j * v[..., 1:2] + k * v[..., 2:3]


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of outgoing v about n, normalised
    (material.rs:246-248)."""
    return normalize_safe(n * (2.0 * dot_keep(n, v)) - v)
