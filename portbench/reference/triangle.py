"""Ray/triangle intersection, vectorised (port of
``paths_tpu/geom/triangle.py``).

Reference: src/geom.rs:264-303 -- plane hit + signed-area barycentrics (not
Moller-Trumbore), backface normal flip, NaN-guarded.  The barycentric
weights (bx: vertex a, by: vertex b, bz: vertex c) drive the smooth-normal
and vertex-colour interpolation (model.rs:142-172).
"""

from __future__ import annotations

import torch

from portbench.reference import vec

BIG = 3.4e38  # rounds to the f32 value 3.4e38 the reference uses


def intersect(o, d, v0, v1, v2, n):
    """Batched ray/triangle test.  All args (..., 3), broadcastable.

    Returns (t, hit, bx, by, bz, cos_theta): t = BIG where miss; bary
    weights follow geom.rs:287-293; cos_theta = n . d (used for the backface
    flip by callers)."""
    cos_theta = vec.dot(n, d)
    dd = vec.dot(n, v0)  # plane constant (geom.rs:274)
    denom = torch.where(cos_theta == 0.0, 1.0, cos_theta)
    t = (dd - vec.dot(n, o)) / denom
    valid = (cos_theta != 0.0) & (t >= 0.0) & torch.isfinite(t)

    p = o + d * t[..., None]

    area_abc = vec.dot(n, vec.cross(v1 - v0, v2 - v0))
    area_pbc = vec.dot(n, vec.cross(v1 - p, v2 - p))
    area_pca = vec.dot(n, vec.cross(v2 - p, v0 - p))

    denom_a = torch.where(area_abc == 0.0, 1.0, area_abc)
    bx = area_pbc / denom_a
    by = area_pca / denom_a
    bz = 1.0 - bx - by

    inside = (bx >= 0.0) & (by >= 0.0) & (bz >= 0.0) & (area_abc != 0.0)
    hit = valid & inside
    t = torch.where(hit, t, torch.full_like(t, BIG))
    return t, hit, bx, by, bz, cos_theta
