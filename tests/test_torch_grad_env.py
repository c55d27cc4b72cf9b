"""Pixel-gradient parity of the port against the reference on the CPU under
the HDRI sky: env_demo with environment NEE (256 lanes, 3 bounces, every
parameter field to rtol 2e-3 and atol 1e-5, ``torch_grad_cases.py``), so the
gradient reaches ``sky.image``, the map's texels, through both the miss
lookup and ``sample_env``'s radiance."""

import dataclasses
import os

import numpy as np
import torch

from paths_tpu.scene.build import build_scene as jax_build
from paths_tpu.scene.yaml_loader import load_scene_description as jax_load

from torch_grad_cases import assert_grads_match, both_loss_and_grad

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_loss_and_grad_env_nee_matches_reference():
    jstatic, jscene, jcam = jax_build(jax_load(os.path.join(REPO, "scenes", "env_demo.yml")))
    assert jstatic.sky_type == 2
    jstatic = dataclasses.replace(jstatic, max_bounces=3, env_nee=True)
    loss, grads, jloss, jgrads = both_loss_and_grad(jstatic, jscene, jcam)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-4)
    assert assert_grads_match(grads, jgrads, jscene) > 20
    assert int((grads["sky"]["image"] != 0).sum()) > 10  # texels reached
