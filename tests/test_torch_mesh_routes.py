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
"""

import pytest
import torch

from paths_tpu.scene.build import build_scene as jax_build
from paths_tpu.scene.stress import generate_mixed_scene as jax_mixed

from paths_tpu_torch import integrator as TI
from paths_tpu_torch.scene import build as TB

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
