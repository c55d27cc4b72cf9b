"""Scene representation: flattened SoA tensors (port of
``paths_tpu/scene/types.py``).

Every object, mesh and area light is flattened at build time into
world-space primitive arrays (reference: Scene, src/scene.rs:134-170):
spheres and triangles in SoA tensors, per-triangle shading data baked in
world space (vertex normals rotated, scene.rs:184; vertex colours,
model.rs:158-172), and one entity table (objects, then lights) holding the
material SoA and light emission.  ``SceneArrays`` holds the tensors,
``SceneStatic`` the build-time facts (counts, sky type, traversal layout).

Triangles take one of three routes, chosen at build (``scene/build.py``):
the packed triangle table and its kernels (``ptris``), the skip-link BVH
(``use_bvh``: ``pbvh``, the K6 table, on every device), or, for small
meshes, an unrolled scan of the scene arrays.  The
reference's TPU schedule fields (one-hot tables, interpret mode, block
widths, streamed and replicated triangle tables, wave presorting, occlusion
sorting) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import types
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from paths_tpu_torch.ops import packet_traverse as PK
from paths_tpu_torch.ops.packet_traverse import PackedBvh
from paths_tpu_torch.ops.sphere_traverse import PackedSpheres
from paths_tpu_torch.ops.tri_traverse import REFERENCE_FIELDS, PackedTris
from paths_tpu_torch import sky as SK
from paths_tpu_torch.sky import Sky


class SceneArrays(NamedTuple):
    # Spheres (objects' analytic spheres + area-light spheres).  Layout:
    # [0, n_sph_big) double-single-path spheres, then kernel spheres in the
    # packed table's order.
    sph_center: torch.Tensor  # (S, 3)
    sph_radius: torch.Tensor  # (S,)
    sph_ent: torch.Tensor  # (S,) int32 entity index
    # A big sphere's centre less sph_center (the float64 centre's low part,
    # for the double-single test); zero on the other spheres.
    sph_center_lo: torch.Tensor  # (S, 3)

    # Triangles in world space, in the BVH's order when the scene packed
    # them (so packed gids index these arrays directly).
    tri_v0: torch.Tensor  # (T, 3)
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_n: torch.Tensor  # (T, 3) unit geometric normal
    tri_vn0: torch.Tensor  # (T, 3) shading normals (may be non-unit,
    tri_vn1: torch.Tensor  #   reproducing model.rs:142-156 -- no renorm)
    tri_vn2: torch.Tensor
    tri_vc0: torch.Tensor  # (T, 3) vertex colours (ones when absent)
    tri_vc1: torch.Tensor
    tri_vc2: torch.Tensor
    tri_ent: torch.Tensor  # (T,) int32
    tri_smooth: torch.Tensor  # (T,) bool: smooth normals (no backface flip)

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
    # Packed triangle table for the traversal kernels (None unless the
    # triangles take the kernel route).
    ptris: Optional[PackedTris] = None
    # The skip-link BVH's packed table for K6 (None unless the triangles
    # take the BVH route).
    pbvh: Optional[PackedBvh] = None


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
    # Some big sphere's centre has a low part (SceneArrays.sph_center_lo):
    # the double-single test takes it.
    sph_lo: bool = False
    # The small spheres take the flat kernel (K5, ops/chunk_scan.py) instead
    # of the chunk walk (K1/K2): PATHS_TPU_SPH_FLAT=1 at build and a table of
    # at most SPH_FLAT_MAX_ROWS rows.
    sph_flat: bool = False
    n_tris: int = 0
    # Chunks of the packed triangle table (0: no table, the BVH route or
    # the unrolled scan) and its rows per chunk (8, or 20 for large tables).
    tri_chunks: int = 0
    tri_rows: int = 8
    # The triangles take the BVH route (build_scene's bvh_threshold).
    use_bvh: bool = False
    # Bounce cap (trace.rs:14 caps `loops > 10` -> 11 iterations).
    max_bounces: int = 10
    # Environment NEE: importance-sample the HDRI sky for direct light at
    # every bounce (sky.sample_env), with a miss collecting the sky only
    # after a specular bounce.  No effect on flat and gradient skies.
    env_nee: bool = False

    @property
    def has_spheres(self) -> bool:
        return self.n_spheres > 0

    @property
    def has_tris(self) -> bool:
        return self.n_tris > 0


# Reference-package field names that differ from the port's.
_STATIC_RENAMES = {"pallas_sph_chunks": "sph_chunks",
                   "pallas_sph_flat": "sph_flat",
                   "pallas_tri_chunks": "tri_chunks",
                   "pallas_tri_rows": "tri_rows"}


def scene_from_numpy(static_fields: dict, arrays: dict, device):
    """Build the port's scene from the reference package's scene given as
    numpy: ``static_fields`` is its SceneStatic as a dict (fields the port
    has no counterpart for are ignored), ``arrays`` maps each SceneArrays
    field name to an array (but ``sph_center_lo``: the reference package
    keeps the centres in float32, so the low parts are 0), with
    ``sky.colour_a``/``sky.colour_b`` for the
    sky and, when given, ``sky.image``/``sky.env_cdf``/``sky.env_inv_pdf``
    (an HDRI sky's image and tables; without them, the flat and gradient
    skies' 1x1 stand-ins), ``psph.tris``/``psph.chunk_meta`` for the
    packed sphere table and ``ptris.tris``/``ptris.chunk_meta``/
    ``ptris.tri_ent`` for the packed triangle table (the reference's
    replicated table is not read) and
    ``bvh.<field>`` for the reference's BVH arrays (node_min, node_max,
    hit_link, miss_link, prim_start, prim_count), from which ``pbvh``, the
    K6 table, is packed with the scene's f32 triangles (the scene build
    packs it from the f64 ones, so inv_area and n.v0 may differ by a
    rounding).  ``psph.nodes`` and ``ptris.nodes`` stay None: the walk
    kernels' trees are built from the f64 spheres and the BVH's tree,
    which only the scene build has, and the plain versions that the CPU
    runs read neither.  Returns (SceneStatic, SceneArrays) on ``device``."""
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
            env = ([tensor(arrays[f"sky.{f}"]) for f in Sky._fields[2:]]
                   if "sky.image" in arrays else SK.no_env(device))
            fields[name] = Sky(tensor(arrays["sky.colour_a"]),
                               tensor(arrays["sky.colour_b"]), *env)
        elif name == "psph":
            fields[name] = (
                PackedSpheres(tensor(arrays["psph.tris"]),
                              tensor(arrays["psph.chunk_meta"]))
                if "psph.tris" in arrays else None
            )
        elif name == "ptris":
            fields[name] = (
                PackedTris(*(tensor(arrays[f"ptris.{f}"]) for f in REFERENCE_FIELDS))
                if "ptris.tris" in arrays else None
            )
        elif name == "pbvh":
            fields[name] = _pack_reference_bvh(arrays, device)
        elif name == "sph_center_lo":
            fields[name] = tensor(np.zeros_like(arrays["sph_center"]))
        else:
            fields[name] = tensor(arrays[name])
    return static, SceneArrays(**fields)


_BVH_FIELDS = ("node_min", "node_max", "hit_link", "miss_link", "prim_start",
               "prim_count")


def _pack_reference_bvh(arrays: dict, device) -> Optional[PackedBvh]:
    """The K6 table of the reference's BVH arrays (``bvh.<field>``) and its
    f32 triangles in the BVH's order, or None when it has no BVH."""
    if "bvh.node_min" not in arrays:
        return None
    flat = types.SimpleNamespace(**{f: np.asarray(arrays[f"bvh.{f}"])
                                    for f in _BVH_FIELDS})
    flat.n_nodes = len(flat.prim_count)
    f64 = lambda k: np.asarray(arrays[k], np.float32).astype(np.float64)
    return PK.pack_bvh(flat, f64("tri_v0"), f64("tri_v1"), f64("tri_v2"),
                       f64("tri_n"), ent=np.asarray(arrays["tri_ent"]), device=device)
