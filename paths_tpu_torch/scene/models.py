"""Model library: lazy named mesh registry with normal/colour attributes.

Reference: src/model.rs.  Models hold f64 numpy arrays on host; everything is
vectorised (no per-face Python loops) since dragon-class meshes run to ~1M
faces.
"""

from __future__ import annotations

import os

import numpy as np

from paths_tpu_torch.scene.obj_loader import load_obj_file
from paths_tpu_torch.scene.ply_loader import load_ply_file


class Model:
    """model.rs:105-128."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self.vertices = np.asarray(vertices, np.float64)  # (V, 3)
        self.faces = np.asarray(faces, np.int64)  # (F, 3)
        self.face_normals = _face_normals(self.vertices, self.faces)
        self.vertex_normals: np.ndarray | None = None
        self.vertex_colours: np.ndarray | None = None
        self.texture_coords: np.ndarray | None = None
        self.diffuse: np.ndarray | None = None  # OBJ material Kd

    def compute_vertex_normals(self):
        """Area-unweighted average of adjacent face normals, skipping
        degenerate (NaN-normal) faces (model.rs:194-224)."""
        if self.vertex_normals is not None:
            return
        sums = np.zeros_like(self.vertices)
        counts = np.zeros(len(self.vertices), np.float64)
        n = self.face_normals
        ok = ~np.isnan(n).any(axis=1)
        f = self.faces[ok]
        nok = n[ok]
        for col in range(3):
            np.add.at(sums, f[:, col], nok)
            np.add.at(counts, f[:, col], 1.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            self.vertex_normals = sums / counts[:, None]


def _face_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """model.rs:226-249: normalize((v2-v1) x (v3-v1)); degenerate faces retry
    with (v2-v1) x (v3-v2), possibly staying NaN."""
    v1 = vertices[faces[:, 0]]
    v2 = vertices[faces[:, 1]]
    v3 = vertices[faces[:, 2]]
    s1, s2, s3 = v2 - v1, v3 - v1, v3 - v2
    with np.errstate(invalid="ignore", divide="ignore"):
        n = np.cross(s1, s2)
        n = n / np.linalg.norm(n, axis=1, keepdims=True)
        bad = np.isnan(n).any(axis=1)
        if bad.any():
            n2 = np.cross(s1[bad], s3[bad])
            n2 = n2 / np.linalg.norm(n2, axis=1, keepdims=True)
            n[bad] = n2
    return n


class ModelLibrary:
    """model.rs:37-103: declare by name, load lazily, fetch by index."""

    def __init__(self, search_dirs: list[str] | None = None):
        self.declarations: dict[str, str] = {}
        self.loaded: dict[str, list[int]] = {}
        self.models: list[Model] = []
        self.search_dirs = search_dirs or ["."]

    def declare(self, name: str, filepath: str):
        self.declarations[name] = filepath

    def _resolve_path(self, filepath: str) -> str:
        if os.path.isabs(filepath) and os.path.exists(filepath):
            return filepath
        for d in self.search_dirs:
            cand = os.path.join(d, filepath)
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(
            f"Model file '{filepath}' not found in {self.search_dirs}"
        )

    def load(self, name: str) -> list[int]:
        if name in self.loaded:
            return self.loaded[name]
        if name not in self.declarations:
            raise KeyError(f"Attempt to load model '{name}' before declaration")
        path = self._resolve_path(self.declarations[name])
        ext = os.path.splitext(path)[1].lower()
        indices: list[int] = []
        if ext == ".obj":
            for om in load_obj_file(path):
                m = Model(om.vertices, om.faces)
                m.texture_coords = om.texcoords
                m.diffuse = om.diffuse
                indices.append(len(self.models))
                self.models.append(m)
        elif ext == ".ply":
            pm = load_ply_file(path)
            m = Model(pm.vertices, pm.faces)
            m.vertex_colours = pm.vertex_colours
            indices.append(len(self.models))
            self.models.append(m)
        else:
            raise ValueError(f"Unknown model file extension: {ext}")
        self.loaded[name] = indices
        return indices

    def get(self, ix: int) -> Model:
        return self.models[ix]
