"""Skybox lighting (port of ``paths_tpu/sky.py``: the flat and gradient
skies).

Reference: src/scene.rs:68-113.  The integrator evaluates the sky at the
*negated* ray direction (trace.rs:21), reproduced at the call site.  The
HDRI sky and its importance sampling (``hdri``/``sample_env``) need the HDR
loader and are still to be ported (ROADMAP Queue 1, "HDRI sky").
"""

from __future__ import annotations

from typing import NamedTuple

import torch

FLAT = 0
GRADIENT = 1
HDRI = 2


class Sky(NamedTuple):
    # colour_a: flat colour / overhead colour; colour_b: horizon colour.
    colour_a: torch.Tensor  # (3,)
    colour_b: torch.Tensor  # (3,)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def flat(colour, device="cpu") -> tuple[int, Sky]:
    return FLAT, Sky(_f32(colour, device), torch.zeros(3, device=device))


def gradient(overhead, horizon, device="cpu") -> tuple[int, Sky]:
    return GRADIENT, Sky(_f32(overhead, device), _f32(horizon, device))


def hdri(image, device="cpu"):
    raise NotImplementedError(
        "HDRI skies are not ported yet (ROADMAP Queue 1, 'HDRI sky': "
        "hdr_loader.py, sky.hdri and sky.sample_env)"
    )


def ambient_light(sky_type: int, sky: Sky, direction: torch.Tensor) -> torch.Tensor:
    """Sky radiance for (..., 3) directions (scene.rs:88-113)."""
    if sky_type == FLAT:
        return sky.colour_a.expand(direction.shape)
    if sky_type == GRADIENT:
        cos_theta = direction[..., 1:2]
        return sky.colour_a * cos_theta + sky.colour_b * (1.0 - cos_theta)
    raise NotImplementedError(f"sky type {sky_type} is not ported yet")
