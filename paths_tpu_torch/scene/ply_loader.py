"""PLY loader (ascii and binary little/big endian; port of
``paths_tpu/scene/ply_loader.py``).

Replaces the reference's ply-rs dependency (src/ply.rs:11-74): reads vertex
positions, triangular faces, and optional uchar vertex colours (red/green/
blue scaled by 1/255 per ply.rs:62-68).  As in the reference, the C++ parser
(``csrc/mesh_io.cc``, through ``native.load_ply_native``) reads the file by
default, and the pure-numpy path below (``use_native=False``) is the
semantics reference; it also reads a file the C++ parser gives up on, and
raises the reference's error on a malformed one.  The two return the same
arrays bit for bit but the uchar colours: the C++ parser scales by 1/255,
the numpy path divides by 255, one ulp apart in f64 and equal in f32.
"""

from __future__ import annotations

import numpy as np

from paths_tpu_torch import native

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


class PlyModel:
    def __init__(self):
        self.vertices = None  # (V, 3) f64
        self.faces = None  # (F, 3) i64
        self.vertex_colours = None  # (V, 3) f64 in [0,1] or None


def load_ply_file(path: str, use_native: bool = True) -> PlyModel:
    """Parse a PLY file: with the C++ parser (use_native, the default) unless
    it gives up on the file, else with the pure-Python path."""
    if use_native:
        parsed = native.load_ply_native(path)
        if parsed is not None:
            m = PlyModel()
            m.vertices = parsed["vertices"]
            m.faces = parsed["faces"]
            m.vertex_colours = parsed["vertex_colours"]
            return m
    with open(path, "rb") as f:
        data = f.read()

    # ---- header ----
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    nl = data.find(b"\n", end)
    header = data[:nl].decode("ascii", errors="replace")
    body = data[nl + 1:]

    fmt = "ascii"
    elements: list[tuple[str, int, list]] = []  # (name, count, [props])
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                # (is_list, count_type, item_type, name)
                elements[-1][2].append((True, _PLY_TYPES[parts[2]], _PLY_TYPES[parts[3]], parts[4]))
            else:
                elements[-1][2].append((False, _PLY_TYPES[parts[1]], None, parts[2]))

    endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
    model = PlyModel()

    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                row = {}
                for is_list, ctype, itype, pname in props:
                    if is_list:
                        n = int(tokens[pos]); pos += 1
                        row[pname] = [float(tokens[pos + k]) for k in range(n)]
                        pos += n
                    else:
                        row[pname] = float(tokens[pos]); pos += 1
                rows.append(row)
            _assign(model, name, rows)
    else:
        off = 0
        for name, count, props in elements:
            has_list = any(p[0] for p in props)
            if not has_list:
                dt = np.dtype([(p[3], endian + p[1]) for p in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
                off += dt.itemsize * count
                rows = arr  # structured array
                _assign(model, name, rows, structured=True)
            else:
                rows = []
                for _ in range(count):
                    row = {}
                    for is_list, ctype, itype, pname in props:
                        if is_list:
                            cdt = np.dtype(endian + ctype)
                            n = int(np.frombuffer(body, cdt, 1, off)[0])
                            off += cdt.itemsize
                            idt = np.dtype(endian + itype)
                            row[pname] = np.frombuffer(body, idt, n, off).tolist()
                            off += idt.itemsize * n
                        else:
                            pdt = np.dtype(endian + ctype)
                            row[pname] = float(np.frombuffer(body, pdt, 1, off)[0])
                            off += pdt.itemsize
                    rows.append(row)
                _assign(model, name, rows)
    return model


def _assign(model: PlyModel, name: str, rows, structured: bool = False):
    if name == "vertex":
        if structured:
            names = rows.dtype.names
            model.vertices = np.stack(
                [rows["x"], rows["y"], rows["z"]], axis=-1
            ).astype(np.float64)
            if "red" in names and "green" in names and "blue" in names:
                model.vertex_colours = (
                    np.stack([rows["red"], rows["green"], rows["blue"]], axis=-1).astype(np.float64)
                    / 255.0
                )
        else:
            model.vertices = np.array(
                [[r["x"], r["y"], r["z"]] for r in rows], dtype=np.float64
            )
            if rows and all(k in rows[0] for k in ("red", "green", "blue")):
                model.vertex_colours = (
                    np.array([[r["red"], r["green"], r["blue"]] for r in rows]) / 255.0
                )
    elif name == "face":
        key = None
        sample = rows[0] if len(rows) else {}
        for k in ("vertex_indices", "vertex_index"):
            if k in sample:
                key = k
        if key is None:
            raise ValueError("PLY face element lacks vertex_indices")
        tris = []
        for r in rows:
            vi = r[key]
            # Fan-triangulate polygons; reference assumes pure triangles
            # (ply.rs:49-52) but real scans occasionally contain quads.
            for k in range(1, len(vi) - 1):
                tris.append((int(vi[0]), int(vi[k]), int(vi[k + 1])))
        model.faces = np.asarray(tris, dtype=np.int64)
