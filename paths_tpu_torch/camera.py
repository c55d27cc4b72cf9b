"""Thin-lens camera: vectorised primary-ray generation (port of
``paths_tpu/camera.py``).

Reference: src/camera.rs:25-94.  Numeric contract (camera.rs:47-94):
  x,y flipped:   x' = W-1-x, y' = H-1-y           (lens inversion)
  p = f*v/(v-f)                                    (focal plane distance)
  k = ((x'-W/2+jx)*sw/W, (H/2-y'-jy)*sh/H, -v)     (sensor point)
  l = disk * (f/aperture)                          (lens point)
  dir = -(k*(p/v) + l), normalised
  origin = R@l + loc, direction = R@dir
  weight = dir.z before rotation                   (cosine at sensor)
The camera's scalars are f32 0-dim tensors so the arithmetic runs in f32
exactly as the reference package's does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from paths_tpu_torch.math import matrix as mat
from paths_tpu_torch.math import vec


class Camera(NamedTuple):
    location: torch.Tensor  # (3,)
    rot: torch.Tensor  # (3,3) world-from-camera rotation
    focal_length: torch.Tensor  # scalar
    distance_from_lens: torch.Tensor  # scalar, v
    aperture: torch.Tensor  # scalar (f-stop)
    sensor_width: torch.Tensor  # scalar (metres)
    sensor_height: torch.Tensor
    width: torch.Tensor  # image dims as f32 scalars (used arithmetically)
    height: torch.Tensor


def make_camera(
    width: int,
    height: int,
    location=(0.0, 0.0, 0.0),
    orientation=(0.0, 0.0, 0.0),  # (pitch, yaw, roll) in YAML order
    sensor_width: float = None,
    sensor_height: float = None,
    focal_length: float = 9.86,
    focus_distance: float = None,
    aperture: float = 2.0,
    distance_from_lens: float = None,
    device="cpu",
) -> Camera:
    """Build a Camera.  Defaults mirror Camera::new (camera.rs:26-39)."""
    pitch, yaw, roll = orientation
    rot = mat.camera_rotation(yaw, pitch, roll)
    if distance_from_lens is None:
        if focus_distance is None:
            distance_from_lens = 10.0
        else:
            # serde.rs:185
            distance_from_lens = (focal_length * focus_distance) / (
                focus_distance - focal_length
            )
    if sensor_width is None:
        sensor_width = float(width)
    if sensor_height is None:
        sensor_height = float(height)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(
        location=f(np.asarray(location, np.float64)),
        rot=f(rot),
        focal_length=f(focal_length),
        distance_from_lens=f(distance_from_lens),
        aperture=f(aperture),
        sensor_width=f(sensor_width),
        sensor_height=f(sensor_height),
        width=f(float(width)),
        height=f(float(height)),
    )


def resize(cam: Camera, width: int, height: int) -> Camera:
    """Same physical camera at a different pixel resolution."""
    dev = cam.location.device
    return cam._replace(
        width=torch.tensor(float(width), dtype=torch.float32, device=dev),
        height=torch.tensor(float(height), dtype=torch.float32, device=dev),
    )


def get_rays(cam: Camera, px, py, square_xy, disk_xy):
    """Rays for integer pixel coords (px, py) with sensor jitter
    ``square_xy`` in [0,1)^2 and lens sample ``disk_xy`` in the unit disk.
    Returns (origin (...,3), direction (...,3), weight (...))."""
    px = px.to(torch.float32)
    py = py.to(torch.float32)
    jx, jy = square_xy
    dx, dy = disk_xy

    # Lens image flip (camera.rs:55-57).
    x = cam.width - px - 1.0
    y = cam.height - py - 1.0

    f = cam.focal_length
    v = cam.distance_from_lens
    p = (f * v) / (v - f)  # camera.rs:64-67

    x_scale = cam.sensor_width / cam.width
    y_scale = cam.sensor_height / cam.height
    image_x = x - cam.width / 2.0 + jx
    image_y = cam.height / 2.0 - y - jy
    k = torch.stack(
        [image_x * x_scale, image_y * y_scale, (-v).expand(image_x.shape)],
        dim=-1,
    )

    aperture_radius = f / cam.aperture  # camera.rs:41-45
    l = torch.stack(
        [dx * aperture_radius, dy * aperture_radius, torch.zeros_like(dx)],
        dim=-1,
    )

    direction_local = -(k * (p / v) + l)  # camera.rs:82-83
    norm_dir = vec.normalize(direction_local)

    def rotate(m, w3):
        # Explicit elementwise f32 products in the reference's order.
        return torch.stack(
            [
                m[0, 0] * w3[..., 0] + m[0, 1] * w3[..., 1] + m[0, 2] * w3[..., 2],
                m[1, 0] * w3[..., 0] + m[1, 1] * w3[..., 1] + m[1, 2] * w3[..., 2],
                m[2, 0] * w3[..., 0] + m[2, 1] * w3[..., 1] + m[2, 2] * w3[..., 2],
            ],
            dim=-1,
        )

    origin = rotate(cam.rot, l) + cam.location  # camera.rs:86-88
    direction = rotate(cam.rot, norm_dir)
    weight = norm_dir[..., 2]  # camera.rs:90-91
    return origin, direction, weight
