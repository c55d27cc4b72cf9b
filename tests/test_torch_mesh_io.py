"""The port's C++ mesh parsers (``csrc/mesh_io.cc`` through
``native.load_{obj,ply}_native``), the loaders' default:

(a) bit for bit the reference's C++ parser (``paths_tpu.native``) on the two
    in-repo standins and on synthetic files written from a seed (the cases of
    ``tests/test_mesh_io.py``, copied here): PLY binary little- and
    big-endian and ascii, uchar, float and no colours, with and without a
    quad face; OBJ with several models on o/g, negative indices, quads,
    texcoords on some faces only and .mtl Kd;
(b) the port's pure-Python path (``use_native=False``) on the same files:
    bit for bit but the uchar colours, which the C++ parser scales by 1/255
    and the Python path divides by 255 (one ulp apart in f64, equal in f32),
    and float colours, which the C++ parser keeps and the Python path
    divides by 255, as the reference's two parsers do;
(c) a malformed PLY and a missing file raise the same exception type in
    both packages, with either parser;
(d) ``build_scene`` on doom_standin gives every ``SceneArrays`` tensor bit
    for bit the same with either parser, and the pure-parsed build equals
    the reference's build;
(e) a failed build of the parsers raises: the default path never parses in
    Python because the library could not be built.
"""

import itertools
import os
import struct

import numpy as np
import pytest
import torch

from paths_tpu import native as JN
from paths_tpu.scene.build import build_scene as jax_build
from paths_tpu.scene.obj_loader import load_obj_file as jax_obj
from paths_tpu.scene.ply_loader import load_ply_file as jax_ply
from paths_tpu.scene.yaml_loader import load_scene_description as jax_yaml_scene

from paths_tpu_torch import native
from paths_tpu_torch.scene import build as TB
from paths_tpu_torch.scene import models as TM
from paths_tpu_torch.scene.obj_loader import load_obj_file
from paths_tpu_torch.scene.ply_loader import load_ply_file
from paths_tpu_torch.scene.yaml_loader import load_scene_description
from tests.test_torch_meshes import _check_build

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STANDINS = ["doom_standin.ply", "dragon_standin.ply"]
PLY_FORMATS = ["binary_little_endian", "binary_big_endian", "ascii"]
COLOURS = [None, "uchar", "float"]
PLY_CASES = [f"{fmt}-{col or 'nocol'}-{'quad' if quad else 'tri'}"
             for fmt, col, quad in itertools.product(PLY_FORMATS, COLOURS, (False, True))]
OBJ_CASES = ["fixed", "seeded"]
PLY_FIELDS = ("vertices", "faces", "vertex_colours")
OBJ_FIELDS = ("vertices", "faces", "texcoords", "diffuse")


def _same_bits(got, want, what):
    """Both None, or the same dtype, shape and bytes."""
    assert (got is None) == (want is None), what
    if got is not None:
        assert got.dtype == want.dtype and got.shape == want.shape, what
        assert got.tobytes() == want.tobytes(), what


def _reference_parser():
    if not JN.available():
        pytest.skip("the reference's C++ parser is unavailable (no toolchain)")


# ---------------------------------------------------------------- files

def _write_ply(path, fmt, colours, quad, seed=0):
    """A PLY of 40 vertices (x, y, z, nx and optional red/green/blue of type
    `colours`) and 30 triangles, one of them a quad when `quad`, written
    from `seed`.  Returns the colours as written (or None)."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-1, 1, (40, 4)).astype(np.float32)
    faces = [list(f) for f in rng.integers(0, 40, (30, 3))]
    if quad:
        faces[7] = [3, 9, 27, 14]
    cols = None
    props = ["x", "y", "z", "nx"]
    vtypes = "ffff"
    if colours == "uchar":
        cols = rng.integers(0, 256, (40, 3)).astype(np.uint8)
        vtypes += "BBB"
    elif colours == "float":
        cols = rng.uniform(0, 1, (40, 3)).astype(np.float32)
        vtypes += "fff"
    if cols is not None:
        props += ["red", "green", "blue"]
    ptype = {"f": "float", "B": "uchar"}
    lines = ["ply", f"format {fmt} 1.0", "comment written from a seed",
             f"element vertex {len(verts)}"]
    lines += [f"property {ptype[t]} {p}" for t, p in zip(vtypes, props)]
    lines += [f"element face {len(faces)}", "property list uchar int vertex_indices",
              "end_header"]
    rows = [list(v) + ([] if cols is None else list(cols[i])) for i, v in enumerate(verts)]
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode())
        if fmt == "ascii":
            text = [" ".join(repr(float(x)) if t == "f" else str(int(x))
                             for t, x in zip(vtypes, r)) for r in rows]
            text += [" ".join(str(int(x)) for x in [len(fc), *fc]) for fc in faces]
            f.write(("\n".join(text) + "\n").encode())
        else:
            e = "<" if fmt == "binary_little_endian" else ">"
            for r in rows:
                f.write(struct.pack(e + vtypes, *r))
            for fc in faces:
                f.write(struct.pack(f"{e}B{len(fc)}i", len(fc), *(int(x) for x in fc)))
    return cols


def _ply_case(tmp_path, case):
    fmt, col, shape = case.split("-")
    path = str(tmp_path / f"{case}.ply")
    cols = _write_ply(path, fmt, None if col == "nocol" else col, shape == "quad")
    return path, col, cols


_FIXED_OBJ = (
    "mtllib m.mtl\n"
    "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
    "o quad\nusemtl red\nf 1 2 3 4\n"
    "v 2 0 0\nv 3 0 0\nv 3 1 0\n"
    "o tri\nusemtl blu\nf -3 -2 -1\n"
)
_FIXED_MTL = "newmtl red\nKd 0.9 0.1 0.2\nnewmtl blu\nKd 0.1 0.2 0.9\n"


def _seeded_obj(seed=3):
    """Five models on o and g lines over 60 positions and 25 texcoords:
    triangles, quads and pentagons with positive and negative indices; a
    model whose every corner has a texcoord, one where only some faces do,
    one with v//vn corners; materials from the .mtl, one named but not
    defined, and none."""
    rng = np.random.default_rng(seed)
    out = ["# written from a seed", "mtllib seeded.mtl"]
    n_v = n_t = 0

    def positions(k):
        nonlocal n_v
        n_v += k
        return ["v " + " ".join(repr(float(x)) for x in p)
                for p in rng.uniform(-2, 2, (k, 3))]

    def texcoords(k):
        nonlocal n_t
        n_t += k
        return ["vt " + " ".join(repr(float(x)) for x in p)
                for p in rng.uniform(0, 1, (k, 2))]

    def corner(uv):
        i = int(rng.integers(1, n_v + 1))
        i = i if rng.random() < 0.5 else i - n_v - 1  # -1 is the last position
        if uv == "vt":
            t = int(rng.integers(1, n_t + 1))
            return f"{i}/{t if rng.random() < 0.5 else t - n_t - 1}"
        return f"{i}//1" if uv == "vn" else str(i)

    def faces(k, uv):
        return ["f " + " ".join(corner(uv(j) if callable(uv) else uv)
                                for _ in range(int(rng.integers(3, 6))))
                for j in range(k)]

    out += positions(30) + texcoords(25) + ["vn 0 0 1"]
    out += ["o all_uv", "usemtl red"] + faces(12, "vt")
    out += ["g some_uv", "usemtl green"] + faces(10, lambda j: "vt" if j % 2 else None)
    out += positions(30)
    out += ["o normals_only", "usemtl undefined"] + faces(8, "vn")
    out += ["g", "usemtl blue"] + faces(6, None)
    out += ["o empty", "o last"] + faces(5, "vt")
    mtl = ("newmtl red\nKd 0.8 0.1 0.1\nnewmtl green\nKd 0.1 0.7 0.2\n"
           "newmtl blue\nKd 0.125 0.25 0.9\n")
    return "\n".join(out) + "\n", mtl


def _obj_case(tmp_path, case):
    if case == "fixed":
        text, mtl, mtl_name = _FIXED_OBJ, _FIXED_MTL, "m.mtl"
    else:
        (text, mtl), mtl_name = _seeded_obj(), "seeded.mtl"
    (tmp_path / mtl_name).write_text(mtl)
    path = tmp_path / f"{case}.obj"
    path.write_text(text)
    return str(path)


def _asset(name):
    return os.path.join(REPO, "scenes", "assets", name)


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("name", STANDINS)
def test_standin_matches_reference_parser(name):
    _reference_parser()
    got, want = load_ply_file(_asset(name)), JN.load_ply_native(_asset(name))
    assert got.faces.shape[0] == {"doom": 95922, "dragon": 200000}[name.split("_")[0]]
    for f in PLY_FIELDS:
        _same_bits(getattr(got, f), want[f], f)


@pytest.mark.parametrize("case", PLY_CASES)
def test_ply_matches_reference_parser(tmp_path, case):
    _reference_parser()
    path, _, _ = _ply_case(tmp_path, case)
    got, want = native.load_ply_native(path), JN.load_ply_native(path)
    assert got is not None and want is not None
    assert got["faces"].shape == ((31, 3) if case.endswith("quad") else (30, 3))
    for f in PLY_FIELDS:
        _same_bits(got[f], want[f], f)


@pytest.mark.parametrize("case", OBJ_CASES)
def test_obj_matches_reference_parser(tmp_path, case):
    _reference_parser()
    path = _obj_case(tmp_path, case)
    got, want = load_obj_file(path), JN.load_obj_native(path)
    assert len(got) == len(want) == {"fixed": 2, "seeded": 5}[case]
    for g, w in zip(got, want):
        for f in OBJ_FIELDS:
            _same_bits(getattr(g, f), w[f], f)


# ---------------------------------------------------------------- (b)

def _hold_colours(native_cols, pure_cols, kind, written):
    """uchar colours: within one ulp in f64 and equal in f32; float colours:
    the C++ parser keeps the file's values, the Python path divides them by
    255 (both as in the reference)."""
    if kind == "float":
        _same_bits(native_cols, written.astype(np.float64), "colours as written")
        _same_bits(pure_cols, written.astype(np.float64) / 255.0, "colours / 255")
        return
    np.testing.assert_array_max_ulp(native_cols, pure_cols, maxulp=1)
    _same_bits(native_cols.astype(np.float32), pure_cols.astype(np.float32), "f32")


@pytest.mark.parametrize("name", STANDINS)
def test_standin_native_matches_pure_path(name):
    got = load_ply_file(_asset(name))
    want = load_ply_file(_asset(name), use_native=False)
    _same_bits(got.vertices, want.vertices, "vertices")
    _same_bits(got.faces, want.faces, "faces")
    if name.startswith("doom"):
        _hold_colours(got.vertex_colours, want.vertex_colours, "uchar", None)
        assert (got.vertex_colours != want.vertex_colours).any()  # the ulp is real
    else:
        assert got.vertex_colours is None and want.vertex_colours is None


@pytest.mark.parametrize("case", PLY_CASES)
def test_ply_native_matches_pure_path(tmp_path, case):
    path, kind, written = _ply_case(tmp_path, case)
    got, want = load_ply_file(path), load_ply_file(path, use_native=False)
    _same_bits(got.vertices, want.vertices, "vertices")
    _same_bits(got.faces, want.faces, "faces")
    assert (got.vertex_colours is None) == (kind == "nocol") == (want.vertex_colours is None)
    if kind != "nocol":
        _hold_colours(got.vertex_colours, want.vertex_colours, kind, written)


@pytest.mark.parametrize("case", OBJ_CASES)
def test_obj_native_matches_pure_path(tmp_path, case):
    path = _obj_case(tmp_path, case)
    got, want = load_obj_file(path), load_obj_file(path, use_native=False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in OBJ_FIELDS:
            _same_bits(getattr(g, f), getattr(w, f), f)
    if case == "fixed":
        assert got[0].faces.shape == (2, 3)  # the quad, fan-triangulated
        _same_bits(got[1].diffuse, np.array([0.1, 0.2, 0.9]), "Kd")
    else:
        uv = [m.texcoords is not None for m in got]
        kd = [m.diffuse is not None for m in got]
        # usemtl holds across models: "last" keeps "blue".
        assert uv == [True, False, False, False, True]
        assert kd == [True, True, False, True, True]


# ---------------------------------------------------------------- (c)

def _no_end_header(tmp_path):
    path = tmp_path / "no_header.ply"
    path.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 1\nproperty float x\n")
    return str(path)


def _truncated(fmt, cut):
    def write(tmp_path):
        path = str(tmp_path / "short.ply")
        _write_ply(path, fmt, "uchar", True)
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:-cut])
        return path
    return write


MALFORMED = {
    "ply-no-end-header": (_no_end_header, load_ply_file, jax_ply),
    "ply-binary-truncated-faces": (_truncated("binary_little_endian", 9),
                                   load_ply_file, jax_ply),
    # 500 bytes: past the faces' 394, into the vertices.
    "ply-binary-truncated-vertices": (_truncated("binary_big_endian", 500),
                                      load_ply_file, jax_ply),
    "ply-ascii-short": (_truncated("ascii", 60), load_ply_file, jax_ply),
    "ply-missing": (lambda p: str(p / "absent.ply"), load_ply_file, jax_ply),
    "obj-missing": (lambda p: str(p / "absent.obj"), load_obj_file, jax_obj),
}


def _raised(fn, path, use_native):
    with pytest.raises(Exception) as info:
        fn(path, use_native=use_native)
    return info.type


@pytest.mark.parametrize("case", list(MALFORMED))
@pytest.mark.parametrize("use_native", [True, False])
def test_malformed_file_raises_as_reference(tmp_path, case, use_native):
    write, port_fn, ref_fn = MALFORMED[case]
    path = write(tmp_path)
    got = _raised(port_fn, path, use_native)
    if not case.endswith("missing"):
        assert getattr(native, f"load_{case[:3]}_native")(path) is None
    assert got is _raised(ref_fn, path, use_native)


# ---------------------------------------------------------------- (e)

@pytest.mark.parametrize("kind", ["ply", "obj"])
def test_failed_build_raises(tmp_path, monkeypatch, kind):
    def refuse(source, *a, **k):
        raise RuntimeError(f"building {source} failed (1)")

    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "load_library", refuse)
    if kind == "ply":
        path, _, _ = _ply_case(tmp_path, PLY_CASES[0])
        load = load_ply_file
    else:
        path, load = _obj_case(tmp_path, "fixed"), load_obj_file
    with pytest.raises(RuntimeError, match="building mesh_io.cc failed"):
        load(path)
    assert load(path, use_native=False) is not None


# ---------------------------------------------------------------- (d)

@pytest.fixture(scope="module")
def doom_builds():
    """doom_standin.yml built on the CPU with each parser: (native, pure)."""
    path = os.path.join(REPO, "scenes", "doom_standin.yml")
    native_build = TB.build_scene(load_scene_description(path), device="cpu")
    pure = lambda p, use_native=True: load_ply_file(p, use_native=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TM, "load_ply_file", pure)
        pure_build = TB.build_scene(load_scene_description(path), device="cpu")
    return native_build, pure_build


def _tensors(scene):
    for name in scene._fields:
        v = getattr(scene, name)
        if isinstance(v, torch.Tensor):
            yield name, v
        elif v is not None:
            for f in v._fields:
                if isinstance(getattr(v, f), torch.Tensor):
                    yield f"{name}.{f}", getattr(v, f)


def test_build_scene_same_with_either_parser(doom_builds):
    (static, scene, cam), (pstatic, pscene, pcam) = doom_builds
    assert static == pstatic and static.n_tris == 95922
    got, want = dict(_tensors(scene)), dict(_tensors(pscene))
    assert got.keys() == want.keys() and {"tri_vc0", "ptris.tris"} <= got.keys()
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    for f in cam._fields:
        assert torch.equal(getattr(cam, f), getattr(pcam, f)), f


def test_pure_parsed_build_matches_reference(doom_builds, monkeypatch):
    """The pure-parsed build against the reference's (which parses with its
    C++ parser): the triangle fields and every other array."""
    path = os.path.join(REPO, "scenes", "doom_standin.yml")
    monkeypatch.setenv("PATHS_TPU_FORCE_PALLAS", "1")
    want = jax_build(jax_yaml_scene(path))
    got = doom_builds[1]
    for k in range(3):
        for f in (f"tri_v{k}", f"tri_vc{k}"):
            g = getattr(got[1], f).numpy()
            np.testing.assert_array_equal(g, np.asarray(getattr(want[1], f)).astype(g.dtype),
                                          err_msg=f)
    _check_build(got, want)
