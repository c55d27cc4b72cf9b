"""Port parity on the mesh routes other than the mixed scene's: one
path_step and whole render waves of paths_tpu_torch on the CPU against
paths_tpu built with PATHS_TPU_FORCE_PALLAS=1, as tests/test_torch_render.py
holds the mixed scene (same inputs, 16x16, 3 bounces, relative MSE < 1e-4).

- tri_table_only: the mixed scene with 3 spheres and the light (no sphere
  table) and its 128-triangle grid in a table.  This is the route of
  doom_standin and dragon_standin: the port sends shadow rays to the
  double-single sphere scan and the triangle any-hit kernel, where the
  reference derives occlusion from the closest hit.
- tri_scan: a 32-triangle grid, at most 64 triangles, so no table at all:
  the unrolled triangle scan, as in the reference.

The BVH route is held the same way, against the reference's CPU build: the
mixed scene with 8 spheres (no sphere table) and its 128-triangle grid, both
packages built with bvh_threshold=64 and PATHS_TPU_FORCE_PALLAS unset, so
the triangles take the skip-link BVH (the reference's XLA walk
paths_tpu/bvh/traverse.py::closest_hit_bvh; in the port K6's plain version
over the K6 table, which the port packs from the reference's BVH arrays)
and shadow rays take occlusion from the closest hit.  One path_step and one
render wave; then whole renders of doom_standin and dragon_standin on the
BVH route (the reference's CPU default, bvh_threshold=32768), both packages
on the CPU, at 32x24, 1 spp and tests/make_goldens.py's mesh settings
otherwise (4 bounces, seed 0), held to relative MSE < 1e-4.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from paths_tpu import camera as JC
from paths_tpu import render as JR
from paths_tpu.scene.build import build_scene as jax_build
from paths_tpu.scene.stress import generate_mixed_scene as jax_mixed
from paths_tpu.scene.yaml_loader import load_scene_description as jax_yaml_scene

from paths_tpu_torch import camera as TC
from paths_tpu_torch import integrator as TI
from paths_tpu_torch import render as TR
from paths_tpu_torch.ops import packet_traverse as PK
from paths_tpu_torch.scene import build as TB
from paths_tpu_torch.scene.stress import generate_mixed_scene
from paths_tpu_torch.scene.yaml_loader import load_scene_description

from test_torch_render import REPO, _path_step_parity, _rel_mse, _render_wave_parity

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["tri_table_only", "tri_scan"])
def mixed_route(request, tmp_path_factory):
    """The reference's forced-Pallas build of the mixed scene cut to one
    route (see the module docstring)."""
    asset_dir = str(tmp_path_factory.mktemp(request.param))
    kw = dict(n_spheres=3) if request.param == "tri_table_only" else dict(grid_n=5)
    mp = pytest.MonkeyPatch()
    mp.setenv("PATHS_TPU_FORCE_PALLAS", "1")
    try:
        jstatic, jscene, jcam = jax_build(jax_mixed(asset_dir, **kw))
    finally:
        mp.undo()
    assert jstatic.pallas_sph_chunks == 0
    assert (jstatic.pallas_tri_chunks > 0) == (request.param == "tri_table_only")
    return jstatic, jscene, jcam


def test_path_step_mixed_routes_match_reference(mixed_route):
    static, scene, o, d = _path_step_parity(*mixed_route)
    assert static.sph_chunks == 0
    assert (static.tri_chunks > 0) == (static.n_tris > TB.KERNEL_MIN_TRIS)
    none = torch.zeros(o.shape[0], dtype=torch.int32)
    kind = TI.intersect_brief(static, scene, o, d, none, none)[1]
    assert int((kind == TI.KIND_TRI).sum()) > 20  # the camera sees the mesh


def test_render_wave_mixed_routes_match_reference(mixed_route):
    _render_wave_parity(*mixed_route)


# ---- the BVH route: build_scene(..., bvh_threshold=...) ----

@pytest.fixture(scope="module")
def bvh_route(tmp_path_factory):
    """(port build, reference build) of the mixed scene with 8 spheres on
    the BVH route (see the module docstring)."""
    asset_dir = str(tmp_path_factory.mktemp("bvh_route"))
    mp = pytest.MonkeyPatch()
    mp.delenv("PATHS_TPU_FORCE_PALLAS", raising=False)
    try:
        want = jax_build(jax_mixed(asset_dir, n_spheres=8), bvh_threshold=64)
    finally:
        mp.undo()
    got = TB.build_scene(generate_mixed_scene(asset_dir, n_spheres=8),
                         device="cpu", bvh_threshold=64)
    return got, want


def test_bvh_route_build_matches_reference(bvh_route):
    """The same route, BVH and triangle order: every scene array equal to
    the reference's, and the K6 table, packed on the CPU too, holding the
    reference's BVH arrays (boxes, links, leaf counts)."""
    (static, scene, _), (jstatic, jscene, _) = bvh_route
    assert static.use_bvh and jstatic.use_bvh
    assert static.tri_chunks == jstatic.pallas_tri_chunks == 0
    assert static.sph_chunks == jstatic.pallas_sph_chunks == 0
    assert static.n_tris == jstatic.n_tris == 128
    assert scene.ptris is None and scene.pbvh is not None  # K6's table, every device
    for name in scene._fields:
        g, w = getattr(scene, name), getattr(jscene, name, None)
        if name == "sky":
            pairs = [(g.colour_a, w.colour_a), (g.colour_b, w.colour_b)]
        elif name == "pbvh":
            nodes, bvh = g.nodes[: len(jscene.bvh.node_min)], jscene.bvh
            pairs = [(nodes[:, 0:3], bvh.node_min), (nodes[:, 3:6], bvh.node_max),
                     (nodes[:, 6], bvh.hit_link), (nodes[:, 7], bvh.miss_link),
                     (nodes[:, 9], bvh.prim_count)]
        elif g is None:
            continue
        else:
            pairs = [(g, w)]
        for a, b in pairs:
            a = a.numpy()
            np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype), err_msg=name)


def test_bvh_threshold_none_keeps_the_kernel_route(tmp_path):
    """bvh_threshold=None (the default) packs the triangle table as before;
    a threshold at or above the triangle count takes the scan."""
    sd = generate_mixed_scene(str(tmp_path), n_spheres=8)
    static, scene, _ = TB.build_scene(sd, device="cpu")
    assert static.tri_chunks > 0 and not static.use_bvh
    assert scene.ptris is not None and scene.pbvh is None
    static, scene, _ = TB.build_scene(sd, device="cpu", bvh_threshold=128)
    assert static.tri_chunks == 0 and not static.use_bvh and scene.pbvh is None


def test_path_step_bvh_route_matches_reference(bvh_route):
    static, scene, o, d = _path_step_parity(*bvh_route[1])
    assert static.use_bvh and static.tri_chunks == 0
    none = torch.zeros(o.shape[0], dtype=torch.int32)
    kind = TI.intersect_brief(static, scene, o, d, none, none)[1]
    assert int((kind == TI.KIND_TRI).sum()) > 20  # the camera sees the mesh


def test_render_wave_bvh_route_matches_reference(bvh_route):
    _render_wave_parity(*bvh_route[1], n_waves=1)


@pytest.mark.parametrize("name", ["doom_standin", "dragon_standin"])
def test_bvh_route_render_matches_reference(name, monkeypatch):
    """A whole mesh render on the BVH route, the port (K6's plain version)
    against the reference (its XLA walk), both on the CPU: 32x24, 1 spp, 4
    bounces, seed 0, relative MSE < 1e-4."""
    monkeypatch.delenv("PATHS_TPU_FORCE_PALLAS", raising=False)
    path = os.path.join(REPO, "scenes", f"{name}.yml")
    W, H = 32, 24
    jstatic, jscene, jcam = jax_build(jax_yaml_scene(path), bvh_threshold=32768)
    assert jstatic.use_bvh
    jstatic = dataclasses.replace(jstatic, max_bounces=4)
    want = np.asarray(JR.render_image(jstatic, jscene, JC.resize(jcam, W, H), W, H,
                                      spp=1, seed=0))
    calls = {"k6": 0}
    k6 = PK.closest_hit_packet

    def count(*args):
        calls["k6"] += 1
        return k6(*args)

    monkeypatch.setattr(PK, "closest_hit_packet", count)
    static, scene, cam = TB.build_scene(load_scene_description(path), device="cpu",
                                        bvh_threshold=32768)
    assert static.use_bvh and scene.pbvh is not None
    static = dataclasses.replace(static, max_bounces=4)
    got = TR.render_image(static, scene, TC.resize(cam, W, H), W, H, spp=1, seed=0)
    assert got.shape == want.shape and np.isfinite(got).all() and got.max() > 0
    assert calls["k6"] > 0
    assert _rel_mse(got, want) < 1e-4
