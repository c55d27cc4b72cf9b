"""Colour transfer functions (port of ``paths_tpu/math/colour.py``).

Reference: src/colour.rs.  Colours are (..., 3) linear RGB; this module
holds the display transfer used when writing images.
"""

from __future__ import annotations

import numpy as np
import torch

GAMMA = 0.45  # colour.rs:64


def to_bytes_np(rgb: np.ndarray) -> np.ndarray:
    """Gamma-encode linear RGB to u8 exactly as colour.rs:62-74:
    x**0.45, then >=1 -> 255, <=0 -> 0, else floor(x*256)."""
    x = np.power(np.maximum(np.asarray(rgb, np.float64), 0.0), GAMMA)
    b = np.clip(np.floor(x * 256.0), 0, 255)
    b = np.where(x >= 1.0, 255.0, b)
    return b.astype(np.uint8)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
