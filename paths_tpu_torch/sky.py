"""Skybox and environment lighting (port of ``paths_tpu/sky.py``).

Reference: src/scene.rs:68-113.  Three sky models: Flat, Gradient, Hdri
(equirectangular).  The integrator evaluates the sky at the *negated* ray
direction (trace.rs:21), reproduced at the call site.  An HDRI sky also
carries the tables that importance-sample it for environment NEE
(``sample_env``): the reference package's extension over the upstream
renderer, which only evaluates the skybox on a miss.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FLAT = 0
GRADIENT = 1
HDRI = 2

_PI = 3.141592653589793


class Sky(NamedTuple):
    # colour_a: flat colour / overhead colour; colour_b: horizon colour.
    colour_a: torch.Tensor  # (3,)
    colour_b: torch.Tensor  # (3,)
    image: torch.Tensor  # (H, W, 3) HDRI data (1x1 zeros when unused)
    # Environment importance-sampling tables.  env_cdf: flat (H*W,)
    # inclusive CDF over luminance x sin(latitude); env_inv_pdf: (H, W)
    # reciprocal solid-angle pdf per texel (0 where the texel has no
    # energy).  Flat and gradient skies hold ones((1,)) and zeros((1, 1)).
    env_cdf: torch.Tensor  # (H*W,) f32
    env_inv_pdf: torch.Tensor  # (H, W) f32


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def no_env(device):
    """The image and tables of a sky without an image: 1x1 stand-ins."""
    return (torch.zeros((1, 1, 3), device=device), torch.ones(1, device=device),
            torch.zeros((1, 1), device=device))


def flat(colour, device="cpu") -> tuple[int, Sky]:
    return FLAT, Sky(_f32(colour, device), torch.zeros(3, device=device),
                     *no_env(device))


def gradient(overhead, horizon, device="cpu") -> tuple[int, Sky]:
    return GRADIENT, Sky(_f32(overhead, device), _f32(horizon, device),
                         *no_env(device))


def hdri(image, device="cpu") -> tuple[int, Sky]:
    """The HDRI sky of an (H, W, 3) image, with its importance-sampling
    tables, built in numpy f64 step for step as the reference builds them
    and cast to f32 on ``device``.

    The per-texel weight is luminance x sin(latitude) (the texel's
    solid-angle share of the equirectangular map); the flat CDF over all
    texels makes sampling a single searchsorted, and env_inv_pdf converts
    the discrete texel probability to a reciprocal solid-angle density:
      inv_pdf = omega_texel / p_texel,  omega_texel = (pi/H)(2pi/W) sin(lat).
    """
    img = np.asarray(image, np.float32)
    h, w = img.shape[0], img.shape[1]
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    # Row y maps to latitude via the lookup in ambient_light:
    # y = h*(1 - lat/pi)  =>  lat = pi*(1 - (y+0.5)/h).
    lat = _PI * (1.0 - (np.arange(h, dtype=np.float64) + 0.5) / h)
    sin_lat = np.maximum(np.sin(lat), 0.0)
    weight = lum.astype(np.float64) * sin_lat[:, None]
    total = weight.sum()
    if total <= 0.0:
        weight = np.ones_like(weight) * sin_lat[:, None]
        total = weight.sum()
    p = weight / total
    omega = (_PI / h) * (2.0 * _PI / w) * sin_lat[:, None]
    inv_pdf = np.where(p > 0.0, omega / np.maximum(p, 1e-30), 0.0)
    cdf = np.cumsum(p.reshape(-1))
    cdf[-1] = 1.0

    z = torch.zeros(3, device=device)
    return HDRI, Sky(z, z, _f32(img, device), _f32(cdf, device),
                     _f32(inv_pdf, device))


def sample_env(sky: Sky, u_cdf, u_jx, u_jy):
    """Importance-sample the environment map at (N,) uniforms.

    Returns (in_dir, inv_pdf, radiance):
      in_dir: (N, 3) unit vector in the map's convention -- pointing from
        the sky TOWARD the surface (as the integrator evaluates
        ambient_light at -ray_direction, trace.rs:21); shadow rays travel
        along -in_dir;
      inv_pdf: (N,) reciprocal solid-angle pdf of the chosen texel;
      radiance: (N, 3) the texel's RGB (what ambient_light returns for a ray
        escaping along -in_dir).
    """
    h, w = sky.image.shape[0], sky.image.shape[1]
    idx = torch.searchsorted(sky.env_cdf, u_cdf.contiguous(), right=True)
    idx = idx.clamp(0, h * w - 1)
    y = idx // w
    x = idx % w
    radiance = sky.image[y, x]
    inv_pdf = sky.env_inv_pdf[y, x]

    # Texel -> direction: invert the equirectangular lookup
    # (x = (w/2)(long/pi) + w/2, y = h(1 - lat/pi)), jittered within the
    # texel (radiance and pdf are constant across it).
    xf = x.to(torch.float32) + u_jx
    yf = y.to(torch.float32) + u_jy
    long = _PI * (2.0 * xf / w - 1.0)
    lat = _PI * (1.0 - yf / h)
    sin_lat = torch.sin(lat)
    in_dir = torch.stack(
        [sin_lat * torch.cos(long), torch.cos(lat), sin_lat * torch.sin(long)],
        dim=-1)
    return in_dir, inv_pdf, radiance


def _texel(v, n):
    """floor(v) capped at n - 1, as an index.  Below 0 and NaN give 0, as
    the reference's gather clamps its indices and XLA converts NaN."""
    return torch.nan_to_num(torch.floor(v).clamp(0, n - 1), nan=0.0).to(torch.int64)


def ambient_light(sky_type: int, sky: Sky, direction: torch.Tensor) -> torch.Tensor:
    """Sky radiance for (..., 3) directions (scene.rs:88-113)."""
    if sky_type == FLAT:
        return sky.colour_a.expand(direction.shape)
    if sky_type == GRADIENT:
        cos_theta = direction[..., 1:2]
        return sky.colour_a * cos_theta + sky.colour_b * (1.0 - cos_theta)
    # HDRI equirectangular lookup (scene.rs:95-111).
    h, w = sky.image.shape[0], sky.image.shape[1]
    lat = torch.arccos(direction[..., 1].clamp(-1.0, 1.0))  # [0, pi]
    long = torch.atan2(direction[..., 2], direction[..., 0])  # (-pi, pi]
    x = (w / 2.0) * (long / _PI) + w / 2.0
    y = h * (1.0 - lat / _PI)
    return sky.image[_texel(y, h), _texel(x, w)]
