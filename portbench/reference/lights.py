"""Light sampling for next-event estimation (port of ``paths_tpu/lights.py``).

Reference: src/scene.rs:41-66 (Light::sample) and src/geom.rs:146-173.

Light types:
  0 Point  -- the evidently intended semantics (direction from light to
     surface, inv_pdf = 1, occluded iff a hit lies closer than the light);
     upstream's point-light sample is broken and no bundled scene uses it.
  1 Sphere -- uniform point on the full sphere, inv_pdf =
     max(0, area * (n . out_dir) / dist^2)  (geom.rs:160-169).

A "light record" is a dict of per-lane tensors:
  ltype (i32), position (.,3), radius, colour (.,3), intensity, ent_id (i32)
"""

from __future__ import annotations

import torch

from portbench.reference import vec

POINT = 0
SPHERE = 1

_PI = 3.141592653589793
BIG = 3.4e38


def sample(light, from_point, u1, u2):
    """Sample an incoming-light direction from `from_point`.  Returns
    (in_dir, inv_pdf, max_dist): in_dir points from the light sample toward
    the surface (shadow rays travel along -in_dir); max_dist is BIG for
    sphere lights, where occlusion is resolved by entity identity."""
    # Sphere area light (geom.rs:146-169).
    theta = 2.0 * _PI * u1
    phi_cos = 2.0 * u2 - 1.0
    phi_sin = vec.sqrt(torch.clamp_min(1.0 - phi_cos * phi_cos, 0.0))
    n = torch.stack(
        [phi_sin * torch.cos(theta), phi_sin * torch.sin(theta), phi_cos], dim=-1
    )
    point = light["position"] + n * light["radius"][..., None]
    out_vec = from_point - point
    dist_sq = torch.clamp_min(vec.norm_sq(out_vec), 1e-20)
    out_dir = out_vec / vec.sqrt(dist_sq)[..., None]
    area = 4.0 * _PI * light["radius"] * light["radius"]
    sph_inv_pdf = torch.clamp_min(area * vec.dot(n, out_dir) / dist_sq, 0.0)

    # Point light (intended semantics; see module docstring).
    pt_vec = from_point - light["position"]
    pt_dist = vec.sqrt(torch.clamp_min(vec.norm_sq(pt_vec), 1e-20))
    pt_dir = pt_vec / pt_dist[..., None]

    is_point = light["ltype"] == POINT
    in_dir = torch.where(is_point[..., None], pt_dir, out_dir)
    inv_pdf = torch.where(is_point, 1.0, sph_inv_pdf)
    max_dist = torch.where(is_point, pt_dist, BIG)
    return in_dir, inv_pdf, max_dist
