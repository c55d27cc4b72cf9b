"""3x3 rotation matrices, built on the host in numpy (a copy of
``paths_tpu/math/matrix.py``).

Reference: src/matrix.rs.  ``rotation(yaw, pitch, roll)`` composes
``Rx(pitch) @ Ry(yaw) @ Rz(roll)`` (matrix.rs:30-35).  Upstream calls it
with swapped argument order in two places, reproduced by the wrappers:
camera orientation ``rotation(yaw, pitch, roll)`` (serde.rs:177) and mesh
rotation ``rotation(pitch, yaw, roll)`` (serde.rs:107).
"""

from __future__ import annotations

import numpy as np


def rotation_x(angle: float) -> np.ndarray:
    s, c = np.sin(angle), np.cos(angle)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def rotation_y(angle: float) -> np.ndarray:
    s, c = np.sin(angle), np.cos(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def rotation_z(angle: float) -> np.ndarray:
    s, c = np.sin(angle), np.cos(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def rotation(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """matrix.rs:30-35: Rx(pitch) @ Ry(yaw) @ Rz(roll)."""
    return rotation_x(pitch) @ rotation_y(yaw) @ rotation_z(roll)


def camera_rotation(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """Camera orientation: serde.rs:177 calls rotation(yaw, pitch, roll)."""
    return rotation(yaw, pitch, roll)


def mesh_rotation(pitch: float, yaw: float, roll: float) -> np.ndarray:
    """Mesh orientation: serde.rs:107 calls rotation(pitch, yaw, roll)."""
    return rotation(pitch, yaw, roll)
