"""Scene representation: flattened SoA tensors (port of
``paths_tpu/scene/types.py`` for sphere scenes).

Every object and area light is flattened at build time into world-space
primitive arrays (reference: Scene, src/scene.rs:134-170): spheres in SoA
tensors, and one entity table (objects, then lights) holding the material
SoA and light emission.  ``SceneArrays`` holds the tensors, ``SceneStatic``
the build-time facts (counts, sky type, traversal layout).

Triangles (meshes) arrive with slice 2 of the port; the reference's TPU
schedule fields (one-hot tables, interpret mode, block widths, wave
presorting) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from paths_tpu_torch.ops.sphere_traverse import PackedSpheres
from paths_tpu_torch.sky import Sky


class SceneArrays(NamedTuple):
    # Spheres (objects' analytic spheres + area-light spheres).  Layout:
    # [0, n_sph_big) double-single-path spheres, then kernel spheres in the
    # packed table's order.
    sph_center: torch.Tensor  # (S, 3)
    sph_radius: torch.Tensor  # (S,)
    sph_ent: torch.Tensor  # (S,) int32 entity index

    # Entity table: objects [0, n_objects) then lights [n_objects, E).
    ent_is_light: torch.Tensor  # (E,) bool
    ent_light_emission: torch.Tensor  # (E, 3) colour * intensity for lights
    mat_mtype: torch.Tensor  # (E,) int32
    mat_albedo: torch.Tensor  # (E, 3)
    mat_albedo_vertex: torch.Tensor  # (E,) bool: albedo from vertex colours
    mat_emit: torch.Tensor  # (E, 3)
    mat_r0: torch.Tensor  # (E,)
    mat_metalness: torch.Tensor  # (E,)
    mat_roughness: torch.Tensor  # (E,)

    # FresnelCombination sub-materials (material.rs:373-428): for FRESNEL
    # rows the primary columns hold the diffuse sub-material (typed by
    # mat_fd_mtype) and the fs_ columns the specular one.
    mat_fd_mtype: torch.Tensor  # (E,) int32
    mat_fs_mtype: torch.Tensor  # (E,) int32
    mat_fs_albedo: torch.Tensor  # (E, 3)
    mat_fs_r0: torch.Tensor  # (E,)
    mat_fs_metalness: torch.Tensor  # (E,)
    mat_fs_roughness: torch.Tensor  # (E,)
    mat_fresnel_r0: torch.Tensor  # (E,)

    # Lights.
    light_ltype: torch.Tensor  # (L,) int32
    light_pos: torch.Tensor  # (L, 3)
    light_radius: torch.Tensor  # (L,)
    light_colour: torch.Tensor  # (L, 3)
    light_intensity: torch.Tensor  # (L,)
    light_ent: torch.Tensor  # (L,) int32

    sky: Sky
    # Packed small-sphere table for the traversal kernels (None when the
    # scene has at most 32 small spheres).
    psph: Optional[PackedSpheres] = None


@dataclass(frozen=True)
class SceneStatic:
    """Hashable build-time scene facts."""

    n_spheres: int
    n_lights: int
    n_entities: int
    sky_type: int
    has_fresnel: bool = False
    # Chunks of the packed small-sphere table; 0 means every sphere takes
    # the double-single path (no kernel).
    sph_chunks: int = 0
    # Spheres [0, n_sph_big) are big or far and stay on the double-single
    # path even when the kernel runs.
    n_sph_big: int = 0
    # Bounce cap (trace.rs:14 caps `loops > 10` -> 11 iterations).
    max_bounces: int = 10

    @property
    def has_spheres(self) -> bool:
        return self.n_spheres > 0


# Reference-package field names that differ from the port's.
_STATIC_RENAMES = {"pallas_sph_chunks": "sph_chunks"}


def scene_from_numpy(static_fields: dict, arrays: dict, device):
    """Build the port's scene from the reference package's scene given as
    numpy: ``static_fields`` is its SceneStatic as a dict (fields the port
    has no counterpart for are ignored), ``arrays`` maps each SceneArrays
    field name to an array, with ``sky.colour_a``/``sky.colour_b`` for the
    sky and ``psph.tris``/``psph.chunk_meta`` for the packed sphere table.
    Returns (SceneStatic, SceneArrays) on ``device``."""
    names = {f.name for f in dataclasses.fields(SceneStatic)}
    kw = {}
    for k, v in static_fields.items():
        k = _STATIC_RENAMES.get(k, k)
        if k in names:
            kw[k] = v
    static = SceneStatic(**kw)

    def tensor(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int32)
        elif a.dtype != np.bool_:
            a = a.astype(np.float32)
        return torch.tensor(a, device=device)  # a copy: owns its memory

    fields = {}
    for name in SceneArrays._fields:
        if name == "sky":
            fields[name] = Sky(tensor(arrays["sky.colour_a"]),
                               tensor(arrays["sky.colour_b"]))
        elif name == "psph":
            fields[name] = (
                PackedSpheres(tensor(arrays["psph.tris"]),
                              tensor(arrays["psph.chunk_meta"]))
                if "psph.tris" in arrays else None
            )
        else:
            fields[name] = tensor(arrays[name])
    return static, SceneArrays(**fields)
