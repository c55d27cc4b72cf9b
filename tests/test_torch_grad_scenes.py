"""Pixel gradients of the port on the CPU through the triangle kernels'
plain versions (the kernel route):

- parity on the mixed sphere + mesh scene (tests/test_grad.py's
  test_forced_pallas_grads_match_xla; 256 lanes, 3 bounces, every parameter
  field to rtol 2e-3 and atol 1e-5, ``torch_grad_cases.py``): the reference
  built with PATHS_TPU_FORCE_PALLAS=1, so its triangles take the Pallas
  kernels in interpret mode and the port's the plain versions of K3/K4 on
  the same table.  Per-entity fields are compared directly; ``tri_vc*`` row
  by row, as the port runs on the reference's own arrays (no permutation),
  which is stricter than tests/test_grad.py's sums;
- the vertex-colour gradient, which the mixed scene's mesh does not read:
  the same scene with the mesh's albedo taken from its vertex colours, the
  directional derivative ``sum(g * tri_vc0)`` against a central difference
  of the mean radiance with every colour of ``tri_vc0`` scaled by 1 +- eps
  (the check chip_smoke.py makes on doom_standin on the card).
"""

import dataclasses

import numpy as np
import pytest
import torch

from paths_tpu.scene.build import build_scene as jax_build
from paths_tpu.scene.stress import generate_mixed_scene as jax_mixed

from paths_tpu_torch import camera as TC
from paths_tpu_torch import grad as G
from paths_tpu_torch.sampling import hashing as TH
from paths_tpu_torch.scene import desc as TD
from paths_tpu_torch.scene.build import build_scene
from paths_tpu_torch.scene.stress import generate_mixed_scene
from torch_grad_cases import assert_grads_match, both_loss_and_grad, lanes

torch.set_num_threads(2)


def test_loss_and_grad_mixed_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHS_TPU_FORCE_PALLAS", "1")
    jstatic, jscene, jcam = jax_build(jax_mixed(str(tmp_path)))
    monkeypatch.delenv("PATHS_TPU_FORCE_PALLAS")
    assert jstatic.pallas_tri_chunks > 0 and jstatic.pallas_interpret
    jstatic = dataclasses.replace(jstatic, max_bounces=3)
    loss, grads, jloss, jgrads = both_loss_and_grad(jstatic, jscene, jcam)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-4)
    assert assert_grads_match(grads, jgrads, jscene) > 10


def test_fd_vertex_colour_kernel_route(tmp_path):
    sd = generate_mixed_scene(str(tmp_path))
    sd.objects[0].material.albedo = TD.MaterialColourD(is_vertex=True)
    sd.objects[0].mesh.smooth_normals = False  # its vertex normals face away
    static, scene, cam = build_scene(sd, device="cpu")
    assert static.tri_chunks > 0  # the kernel route (plain K3/K4 here)
    static = dataclasses.replace(static, max_bounces=3)
    px, py, pix, sid = lanes()
    cam = TC.resize(cam, 16, 16)
    args = (cam, torch.from_numpy(px), torch.from_numpy(py), TH.as_u32(pix),
            TH.as_u32(sid), 0)
    g = G.pixel_gradient(static, scene, *args, "tri_vc0")
    directional = float((g * scene.tri_vc0).sum())

    def mean_radiance(scale):
        params = G.get_params(scene)
        params["tri_vc0"] = params["tri_vc0"] * scale
        with torch.no_grad():
            return float(G.render_with_params(static, scene, params, *args).mean())

    eps = 1e-2
    fd = (mean_radiance(1 + eps) - mean_radiance(1 - eps)) / (2 * eps)
    assert directional > 0  # brighter vertices -> brighter pixels
    np.testing.assert_allclose(directional, fd, rtol=2e-2)
