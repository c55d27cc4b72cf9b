"""Port parity for the mesh path's host modules: the YAML subset parser, the
PLY/OBJ loaders and models, the BVH builders, the triangle packer on a real
mesh, the ray/triangle test and the scene build, held against the reference
package (and the YAML parser against PyYAML).

Integer work and packed tables are held bit for bit; the ray/triangle test
to rtol 1e-5 / atol 1e-5 (XLA contracts its multiply-adds into FMAs, the
port's eager PyTorch does not, and the barycentric areas cancel).
"""

import os

import numpy as np
import pytest
import torch
import yaml
import jax.numpy as jnp

from paths_tpu.bvh.build import build_bvh as jax_bvh
from paths_tpu.geom import triangle as JT
from paths_tpu.ops.pallas_traverse import pack_chunked as jax_pack
from paths_tpu.scene import models as JM
from paths_tpu.scene.build import build_scene as jax_build
from paths_tpu.scene.obj_loader import load_obj_file as jax_obj
from paths_tpu.scene.ply_loader import load_ply_file as jax_ply
from paths_tpu.scene.stress import generate_mixed_scene as jax_mixed
from paths_tpu.scene.yaml_loader import load_scene_description as jax_yaml_scene

from paths_tpu_torch.bvh.build import build_bvh
from paths_tpu_torch.geom import triangle as TG
from paths_tpu_torch.ops import sphere_traverse as ST
from paths_tpu_torch.ops import tri_traverse as TT
from paths_tpu_torch.scene import build as TB
from paths_tpu_torch.scene import models as TM
from paths_tpu_torch.scene.obj_loader import load_obj_file
from paths_tpu_torch.scene.ply_loader import load_ply_file
from paths_tpu_torch.scene.stress import generate_mixed_scene
from paths_tpu_torch.scene.yaml_loader import (
    YamlSubsetError,
    load_scene_description,
    parse_yaml,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ["ct_demo", "doom_standin", "dragon_standin", "env_demo", "env_mesh_demo"]
BVH_FIELDS = ("node_min", "node_max", "hit_link", "miss_link", "prim_start",
              "prim_count", "order")


def _asset(name):
    return os.path.join(REPO, "scenes", "assets", name)


# ---------------------------------------------------------------- YAML

@pytest.mark.parametrize("scene", SCENES)
def test_yaml_parser_matches_safe_load(scene):
    with open(os.path.join(REPO, "scenes", f"{scene}.yml")) as f:
        text = f.read()
    assert parse_yaml(text) == yaml.safe_load(text)


def test_yaml_parser_matches_safe_load_on_the_subset():
    text = """# comment
a: 1            # trailing comment
b: [1, 2.5, x, 'it''s', "q\\"s #", -3., .5, 1e5, 1.0e+3, yes, Off, ~, null]
c:
- 1
- k: v
  j: {a: 1, b: {c: [true]}, d: ''}
- - 2
  - 3
-
  e: f
d:
  list:
  - "x: y"
  nested:
    deeper: -0
empty: []
none:
"""
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text,line", [
    ("a: &anchor 1\n", 1),
    ("a: *alias\n", 1),
    ("a: !!str 1\n", 1),
    ("a: |\n  block\n", 1),
    ("a: >\n  folded\n", 1),
    ("a:\n\t- 1\n", 2),
    ("a: {b: 1\n", 1),
    ("a: [1, 2\n", 1),
    ("a: 1\n  b: 2\n", 2),
    ("---\na: 1\n", 1),
    ("- a\nb: 1\n", 2),
    ("a: b: c\n", 1),
])
def test_yaml_parser_rejects_unsupported_syntax(text, line):
    with pytest.raises(YamlSubsetError, match=f"line {line}"):
        parse_yaml(text)


def test_scene_description_matches_reference():
    path = os.path.join(REPO, "scenes", "doom_standin.yml")
    got, want = load_scene_description(path), jax_yaml_scene(path)
    assert repr(got) == repr(want)


# ---------------------------------------------------------------- loaders

@pytest.mark.parametrize("name", ["doom_standin.ply", "dragon_standin.ply"])
def test_ply_loader_matches_reference(name):
    """Each parser against its counterpart: the pure-Python paths
    (use_native=False) and the defaults (both packages' copies of the C++
    parser), each bit for bit.  The C++ parser scales uchar colours by 1/255
    where the Python path divides by 255, an ulp apart in f64, so neither
    is held to the other's parser here (tests/test_torch_mesh_io.py)."""
    for use_native in (False, True):
        got = load_ply_file(_asset(name), use_native=use_native)
        want = jax_ply(_asset(name), use_native=use_native)
        for f in ("vertices", "faces", "vertex_colours"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None), f
            if g is not None:
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f
        assert (got.vertex_colours is not None) == name.startswith("doom")


_OBJ = """mtllib grid.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 2 0 0
v 3 0 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
o first
usemtl red
f 1/1 2/2 3/3 4/4
g second
usemtl blue
f -5 -2 -1
f 2 5 5
f 2 5 6
"""
_MTL = """newmtl red
Kd 0.8 0.1 0.1
newmtl blue
Kd 0.1 0.2 0.9
"""


def test_obj_loader_and_models_match_reference(tmp_path):
    """A multi-model OBJ (quad fan, negative indices, texcoords, .mtl Kd, a
    degenerate face) and the mixed scene's grid.obj: models, face normals
    (with the degenerate retry) and vertex normals."""
    (tmp_path / "multi.obj").write_text(_OBJ)
    (tmp_path / "grid.mtl").write_text(_MTL)
    generate_mixed_scene(str(tmp_path))
    for name in ("multi.obj", "grid.obj"):
        path = str(tmp_path / name)
        got = load_obj_file(path)
        for want in (jax_obj(path, use_native=False), jax_obj(path)):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for f in ("vertices", "faces", "texcoords", "diffuse"):
                    gv, wv = getattr(g, f), getattr(w, f)
                    assert (gv is None) == (wv is None), f
                    if gv is not None:
                        np.testing.assert_array_equal(gv, wv, err_msg=f)
        for g, w in zip(got, jax_obj(path, use_native=False)):
            gm, wm = TM.Model(g.vertices, g.faces), JM.Model(w.vertices, w.faces)
            gm.compute_vertex_normals()
            wm.compute_vertex_normals()
            np.testing.assert_array_equal(gm.face_normals, wm.face_normals)
            np.testing.assert_array_equal(gm.vertex_normals, wm.vertex_normals)
    multi = load_obj_file(str(tmp_path / "multi.obj"))
    assert np.isnan(TM.Model(multi[1].vertices, multi[1].faces).face_normals).any()


# ---------------------------------------------------------------- BVH, packing

@pytest.fixture(scope="module")
def doom_tris():
    """doom_standin.yml's triangles in world space (f64), BVH-ordered by the
    port, and the reference's BVH over the same boxes."""
    sd = load_scene_description(os.path.join(REPO, "scenes", "doom_standin.yml"))
    mesh = sd.objects[0].mesh
    ply = load_ply_file(_asset("doom_standin.ply"))
    model = TM.Model(ply.vertices, ply.faces)
    tri = TB._mesh_triangles(mesh, model, ent=0)
    lo = np.minimum(np.minimum(tri["v0"], tri["v1"]), tri["v2"])
    hi = np.maximum(np.maximum(tri["v0"], tri["v1"]), tri["v2"])
    return tri, build_bvh(lo, hi), jax_bvh(lo, hi)


def test_native_bvh_matches_reference(doom_tris):
    """More than 512 triangles: the port's copy of the C++ builder."""
    _, got, want = doom_tris
    assert got.n_nodes == want.n_nodes and got.depth == want.depth
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_python_bvh_matches_reference():
    """At most 512 triangles: the Python builder (f64 boxes)."""
    rng = np.random.default_rng(2)
    c = rng.uniform(-1, 1, (300, 3))
    lo, hi = c - rng.uniform(0, 0.2, (300, 3)), c + rng.uniform(0, 0.2, (300, 3))
    got, want = build_bvh(lo, hi), jax_bvh(lo, hi, use_native=False)
    assert got.n_nodes == want.n_nodes and got.depth == want.depth
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("rows", [TT.ROWS_PER_CHUNK, TT.ROWS_PER_CHUNK_LARGE])
def test_pack_doom_bit_exact(doom_tris, rows):
    tri, flat, _ = doom_tris
    v = [tri[k][flat.order] for k in ("v0", "v1", "v2", "n")]
    ent = np.arange(len(v[0])) % 5
    want, wn = jax_pack(flat, *v, ent=ent, rows_per_chunk=rows)
    got, gn = TT.pack_chunked(flat, *v, ent=ent, rows_per_chunk=rows)
    assert gn == wn
    for f in TT.REFERENCE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


# ---------------------------------------------------------------- geometry

def test_triangle_intersect_matches_reference():
    rng = np.random.default_rng(4)
    n_rays = 4096
    v0, v1, v2 = (rng.uniform(-1, 1, (n_rays, 3)) for _ in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    o = rng.uniform(-3, 3, (n_rays, 3))
    w = rng.dirichlet((1, 1, 1), n_rays) * 1.2 - 0.1  # some outside
    d = w[:, :1] * v0 + w[:, 1:2] * v1 + w[:, 2:] * v2 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:64] = np.cross(n[:64], rng.normal(size=(64, 3)))  # parallel-ish
    args = [a.astype(np.float32) for a in (o, d, v0, v1, v2, n)]
    got = TG.intersect(*(torch.from_numpy(a) for a in args))
    want = JT.intersect(*(jnp.asarray(a) for a in args))
    hit_g, hit_w = got[1].numpy(), np.asarray(want[1])
    assert (hit_g == hit_w).mean() > 0.999 and hit_w.sum() > n_rays // 2
    both = hit_g & hit_w
    for name, g, w in zip(("t", "bx", "by", "bz", "cos"),
                          (got[0], *got[2:]), (want[0], *want[2:])):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g[both], w[both], rtol=1e-5, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------- scene build

def _check_build(got, want):
    (static, scene, cam), (jstatic, jscene, jcam) = got, want
    assert static.tri_chunks == jstatic.pallas_tri_chunks > 0
    assert static.tri_rows == jstatic.pallas_tri_rows
    assert static.sph_chunks == jstatic.pallas_sph_chunks
    for f in ("n_spheres", "n_tris", "n_lights", "n_entities", "sky_type",
              "has_fresnel", "n_sph_big"):
        assert getattr(static, f) == getattr(jstatic, f), f
    for name in scene._fields:
        g, w = getattr(scene, name), getattr(jscene, name, None)
        if name == "sky":
            pairs = [(g.colour_a, w.colour_a), (g.colour_b, w.colour_b)]
        elif name == "sph_center_lo":  # the port's own: the reference keeps float32 centres
            assert static.sph_lo == bool(g.any())
            pairs = []
        elif name in ("psph", "ptris"):
            assert (g is None) == (w is None), name
            fields = TT.REFERENCE_FIELDS if name == "ptris" else ST.REFERENCE_FIELDS
            pairs = [] if g is None else [(getattr(g, f), getattr(w, f)) for f in fields]
        elif name == "pbvh":  # the K6 table: the BVH route's only
            assert g is None and jscene.bvh is None
            pairs = []
        else:
            pairs = [(g, w)]
        for a, b in pairs:
            a = a.numpy()
            np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype), err_msg=name)
    for f in cam._fields:
        np.testing.assert_array_equal(getattr(cam, f).numpy(),
                                      np.asarray(getattr(jcam, f)), err_msg=f)


def test_build_mixed_scene_matches_reference(tmp_path, monkeypatch):
    got = TB.build_scene(generate_mixed_scene(str(tmp_path), n_spheres=40), device="cpu")
    monkeypatch.setenv("PATHS_TPU_FORCE_PALLAS", "1")
    _check_build(got, jax_build(jax_mixed(str(tmp_path), n_spheres=40)))


def test_build_doom_matches_reference(monkeypatch):
    path = os.path.join(REPO, "scenes", "doom_standin.yml")
    got = TB.build_scene(load_scene_description(path), device="cpu")
    monkeypatch.setenv("PATHS_TPU_FORCE_PALLAS", "1")
    want = jax_build(jax_yaml_scene(path))
    _check_build(got, want)
    static, scene, _ = got
    assert static.n_tris == 95922 and static.tri_rows == TT.ROWS_PER_CHUNK
    assert bool(scene.mat_albedo_vertex[0])  # albedo {type: Vertex}
    assert not static.sph_lo  # the ground at y -1000140 is a float32 number


def test_build_dragon_matches_reference(monkeypatch):
    """200,000 triangles: past REPACK_BYTES at 8 rows, so both packages
    repack at 20 rows per chunk."""
    path = os.path.join(REPO, "scenes", "dragon_standin.yml")
    got = TB.build_scene(load_scene_description(path), device="cpu")
    monkeypatch.setenv("PATHS_TPU_FORCE_PALLAS", "1")
    _check_build(got, jax_build(jax_yaml_scene(path)))
    static, scene, _ = got
    assert static.n_tris == 200000 and static.tri_rows == TT.ROWS_PER_CHUNK_LARGE
    assert (static.tri_chunks, scene.ptris.tris.shape[0]) == (1755, 35104)
    # The ground at y -1000002.8: -1000002.8125 in float32, 0.0125 its low part.
    assert static.sph_lo and float(scene.sph_center[0, 1]) == -1000002.8125
    assert scene.sph_center_lo[0].tolist() == [0.0, np.float32(0.0125), 0.0]
    assert not scene.sph_center_lo[1:].any()
