"""Wavefront OBJ loader (port of ``paths_tpu/scene/obj_loader.py``).

Replaces the reference's tobj dependency (src/obj.rs:8-67): loads positions,
faces (fan-triangulated, matching tobj's triangulate=true), texcoords, and
per-model diffuse materials from .mtl.  Models split on ``o``/``g`` lines
like tobj, and the reference's "multi-model OBJ expands to multiple objects"
behaviour (serde.rs:110-138) is preserved downstream.  As in the reference,
the C++ parser (``csrc/mesh_io.cc``, through ``native.load_obj_native``)
reads the file by default, and the pure-numpy path below
(``use_native=False``) is the semantics reference, bit for bit the same
arrays; it also reads a file the C++ parser gives up on.
"""

from __future__ import annotations

import os

import numpy as np

from paths_tpu_torch import native


class ObjModel:
    def __init__(self):
        self.vertices = None  # (V, 3) f64
        self.faces = None  # (F, 3) i64
        self.texcoords = None  # (V, 2) or None
        self.diffuse = None  # (3,) material Kd or None (obj.rs:24-27)


def _parse_mtl(path: str) -> dict[str, np.ndarray]:
    mats: dict[str, np.ndarray] = {}
    cur = None
    try:
        with open(path, errors="replace") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "newmtl" and len(parts) > 1:
                    cur = parts[1]
                    mats[cur] = np.array([1.0, 1.0, 1.0])
                elif parts[0] == "Kd" and cur is not None and len(parts) >= 4:
                    mats[cur] = np.array([float(parts[1]), float(parts[2]), float(parts[3])])
    except OSError:
        pass
    return mats


def load_obj_file(path: str, use_native: bool = True) -> list[ObjModel]:
    """Parse an OBJ file into one or more models (split on o/g): with the
    C++ parser (use_native, the default) unless it gives up on the file,
    else with the pure-Python path."""
    if use_native:
        parsed = native.load_obj_native(path)
        if parsed is not None:
            models = []
            for d in parsed:
                m = ObjModel()
                m.vertices = d["vertices"]
                m.faces = d["faces"]
                m.texcoords = d["texcoords"]
                m.diffuse = d["diffuse"]
                models.append(m)
            return models
    positions: list[list[float]] = []
    texcoords: list[list[float]] = []
    mtl: dict[str, np.ndarray] = {}

    # Per current model state.
    models: list[ObjModel] = []
    cur_faces: list[tuple[int, int, int]] = []
    cur_face_uvs: list[tuple[int, int, int]] = []
    cur_mtl_name: str | None = None

    def flush():
        nonlocal cur_faces, cur_face_uvs, cur_mtl_name
        if not cur_faces:
            return
        m = ObjModel()
        faces = np.asarray(cur_faces, dtype=np.int64)
        # Re-index: keep only vertices referenced by this model (tobj packs
        # per-model vertex buffers).
        used, inverse = np.unique(faces.reshape(-1), return_inverse=True)
        m.vertices = np.asarray(positions, dtype=np.float64)[used]
        m.faces = inverse.reshape(-1, 3)
        if texcoords and cur_face_uvs and all(u >= 0 for tri in cur_face_uvs for u in tri):
            # Per-vertex texcoords only when the mapping is consistent.
            tc = np.zeros((len(used), 2))
            uv_arr = np.asarray(texcoords, dtype=np.float64)
            fuv = np.asarray(cur_face_uvs, dtype=np.int64)
            tc[inverse.reshape(-1, 3).reshape(-1)] = uv_arr[fuv.reshape(-1)]
            m.texcoords = tc
        if cur_mtl_name is not None and cur_mtl_name in mtl:
            m.diffuse = mtl[cur_mtl_name]
        models.append(m)
        cur_faces = []
        cur_face_uvs = []

    def resolve_index(tok: str, count: int) -> int:
        i = int(tok)
        return i - 1 if i > 0 else count + i

    with open(path, errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vt":
                texcoords.append([float(parts[1]), float(parts[2])])
            elif tag == "f":
                idx = []
                uvi = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    idx.append(resolve_index(comps[0], len(positions)))
                    if len(comps) > 1 and comps[1]:
                        uvi.append(resolve_index(comps[1], len(texcoords)))
                    else:
                        uvi.append(-1)
                # Fan triangulation (tobj triangulate=true).
                for k in range(1, len(idx) - 1):
                    cur_faces.append((idx[0], idx[k], idx[k + 1]))
                    cur_face_uvs.append((uvi[0], uvi[k], uvi[k + 1]))
            elif tag in ("o", "g"):
                flush()
            elif tag == "usemtl" and len(parts) > 1:
                cur_mtl_name = parts[1]
            elif tag == "mtllib" and len(parts) > 1:
                mtl.update(_parse_mtl(os.path.join(os.path.dirname(path), parts[1])))
    flush()
    return models
