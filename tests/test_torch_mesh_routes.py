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
the triangles take the skip-link BVH (bvh/traverse.py::closest_hit_bvh on
the CPU, in both packages) and shadow rays take occlusion from the closest
hit.  One path_step and one render wave.
"""

import numpy as np
import pytest
import torch

from paths_tpu.scene.build import build_scene as jax_build
from paths_tpu.scene.stress import generate_mixed_scene as jax_mixed

from paths_tpu_torch import integrator as TI
from paths_tpu_torch.scene import build as TB
from paths_tpu_torch.scene.stress import generate_mixed_scene

from test_torch_render import _path_step_parity, _render_wave_parity

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
    """The same route, BVH and triangle order: every scene array, the BVH
    arrays included, equal to the reference's."""
    (static, scene, _), (jstatic, jscene, _) = bvh_route
    assert static.use_bvh and jstatic.use_bvh
    assert static.tri_chunks == jstatic.pallas_tri_chunks == 0
    assert static.sph_chunks == jstatic.pallas_sph_chunks == 0
    assert static.n_tris == jstatic.n_tris == 128
    assert scene.ptris is None and scene.pbvh is None  # K6's table: card only
    for name in scene._fields:
        g, w = getattr(scene, name), getattr(jscene, name, None)
        if name == "sky":
            pairs = [(g.colour_a, w.colour_a), (g.colour_b, w.colour_b)]
        elif name == "bvh":
            pairs = [(getattr(g, f), getattr(w, f)) for f in g._fields]
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
    assert scene.ptris is not None and scene.bvh is None
    static, scene, _ = TB.build_scene(sd, device="cpu", bvh_threshold=128)
    assert static.tri_chunks == 0 and not static.use_bvh and scene.bvh is None


def test_path_step_bvh_route_matches_reference(bvh_route):
    static, scene, o, d = _path_step_parity(*bvh_route[1])
    assert static.use_bvh and static.tri_chunks == 0
    none = torch.zeros(o.shape[0], dtype=torch.int32)
    kind = TI.intersect_brief(static, scene, o, d, none, none)[1]
    assert int((kind == TI.KIND_TRI).sum()) > 20  # the camera sees the mesh


def test_render_wave_bvh_route_matches_reference(bvh_route):
    _render_wave_parity(*bvh_route[1], n_waves=1)
