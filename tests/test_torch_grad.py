"""Pixel gradients of the port (``paths_tpu_torch.grad``) on the CPU.

- Parity: the port's ``loss_and_grad`` against the reference's on the same
  scene arrays, lanes and seed (256 lanes, 3 bounces), every parameter field
  to rtol 2e-3 and atol 1e-5 (``torch_grad_cases.py``), on the lit sphere
  and the 8-sphere stress scene of tests/test_grad.py.  The mixed scene and
  env_demo are in test_torch_grad_scenes.py.
- The finite-difference checks and the inverse-rendering loop of
  tests/test_grad.py, on the port alone: central differences with common
  random numbers follow the same paths as autograd, so they are tight.

The gradient cut at the traversal wrappers is held on both devices by
test_torch_grad_cut.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from paths_tpu.scene import desc as JD
from paths_tpu.scene.build import build_scene as jax_build
from paths_tpu.scene.stress import generate_stress_scene as jax_stress

from paths_tpu_torch import camera as TC
from paths_tpu_torch import grad as G
from paths_tpu_torch.sampling import hashing as TH
from paths_tpu_torch.scene import desc as TD
from paths_tpu_torch.scene.build import build_scene
from paths_tpu_torch.scene.stress import generate_stress_scene
from torch_grad_cases import assert_grads_match, both_loss_and_grad, lanes

torch.set_num_threads(2)


def _lit_sphere(D):
    """tests/test_grad.py's lit sphere, in either package's desc module D."""
    sd = D.SceneDescription()
    sd.skybox = D.SkyboxD(kind="gradient",
                          overhead_colour=D.ColourD(0.2, 0.3, 0.5),
                          horizon_colour=D.ColourD(0.8, 0.7, 0.6))
    mat = D.MaterialD(kind="lambertian")
    mat.albedo = D.MaterialColourD(colour=D.ColourD(0.5, 0.4, 0.3))
    sd.objects = [D.ObjectD(shape_kind="sphere",
                            sphere=D.SphereD(D.Vec3D(0, 0, 3), 1.0),
                            material=mat)]
    sd.lights = [D.LightD(kind="sphere", position=D.Vec3D(3, 3, 0), radius=0.5,
                          colour=D.ColourD(1.0, 0.9, 0.8), intensity=2.0)]
    return sd


@pytest.fixture(scope="module")
def lit_sphere():
    """The port's own build of the lit sphere, 3 bounces."""
    static, scene, cam = build_scene(_lit_sphere(TD), device="cpu")
    return dataclasses.replace(static, max_bounces=3), scene, cam


def test_loss_and_grad_lit_sphere_matches_reference():
    jstatic, jscene, jcam = jax_build(_lit_sphere(JD))
    jstatic = dataclasses.replace(jstatic, max_bounces=3)
    loss, grads, jloss, jgrads = both_loss_and_grad(jstatic, jscene, jcam)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-4)
    assert assert_grads_match(grads, jgrads, jscene) > 5
    assert float(grads["mat_albedo"][0].min()) > 0


def test_loss_and_grad_stress8_matches_reference():
    jstatic, jscene, jcam = jax_build(jax_stress(8, seed=2))
    jstatic = dataclasses.replace(jstatic, max_bounces=3)
    loss, grads, jloss, jgrads = both_loss_and_grad(jstatic, jscene, jcam)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-4)
    assert assert_grads_match(grads, jgrads, jscene) > 0


# ---- finite differences (tests/test_grad.py's _fd_check, on the port) ----

def _wave(cam, n=256, W=16):
    px, py, pix, sid = lanes(n, W)
    return (TC.resize(cam, W, max(1, n // W)), torch.from_numpy(px),
            torch.from_numpy(py), TH.as_u32(pix), TH.as_u32(sid))


def _fd_check(static, scene, cam, field, index, rel_tol, eps=2e-3, sky=False):
    cam, px, py, pid, sid = _wave(cam)
    g = G.pixel_gradient(static, scene, cam, px, py, pid, sid, 0, field)
    g_val = float(g[index])

    def with_delta(delta):
        params = G.leaf_params(G.get_params(scene), ())
        x = params["sky"][field] if sky else params[field]
        x[index] += delta
        col = G.render_with_params(static, scene, params, cam, px, py, pid, sid, 0)
        return float(torch.mean(col))

    fd = (with_delta(eps) - with_delta(-eps)) / (2 * eps)
    assert np.isfinite(g_val)
    np.testing.assert_allclose(g_val, fd, rtol=rel_tol, atol=1e-5)
    return g_val


@pytest.mark.parametrize("field,index,sky,positive", [
    ("mat_albedo", (0, 0), False, True),
    ("light_intensity", (0,), False, True),
    ("light_colour", (0, 1), False, False),
    ("colour_a", (2,), True, True),
])
def test_fd_lit_sphere(lit_sphere, field, index, sky, positive):
    g = _fd_check(*lit_sphere, field, index, rel_tol=5e-3, sky=sky)
    if positive:
        assert g > 0  # brighter parameter -> brighter pixel


def test_fd_stress_scene_albedo():
    """Gradients through the multi-material stress scene (gloss, mirror and
    Lambertian, Russian roulette active)."""
    static, scene, cam = build_scene(generate_stress_scene(8, seed=2), device="cpu")
    static = dataclasses.replace(static, max_bounces=3)
    for e in range(3):
        _fd_check(static, scene, cam, "mat_albedo", (e, 0), rel_tol=2e-2)


def test_inverse_rendering_recovers_albedo(lit_sphere):
    """Gradient descent on the l2 loss recovers a perturbed albedo."""
    static, scene, cam = lit_sphere
    cam, px, py, pid, sid = _wave(cam, n=512)
    target_params = G.get_params(scene)
    with torch.no_grad():
        target = G.render_with_params(static, scene, target_params, cam, px, py, pid, sid, 0)
    start = target_params["mat_albedo"].clone()
    start[0] = torch.tensor([0.9, 0.1, 0.9])
    scene = scene._replace(mat_albedo=start)

    losses = []
    for _ in range(40):
        loss, g = G.loss_and_grad(static, scene, cam, px, py, pid, sid, 0, target)
        losses.append(float(loss))
        scene = scene._replace(mat_albedo=scene.mat_albedo - 2.0 * g["mat_albedo"])
    with torch.no_grad():
        losses.append(float(G.l2_loss(static, G.get_params(scene), scene, cam, px, py,
                                      pid, sid, 0, target)))
    assert losses[-1] < losses[0] * 1e-2
    np.testing.assert_allclose(scene.mat_albedo[0].numpy(),
                               target_params["mat_albedo"][0].numpy(), atol=0.05)
