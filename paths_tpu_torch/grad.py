"""Differentiable rendering: pixel gradients to scene parameters (port of
``paths_tpu/grad.py``).

The radiance estimate of ``integrator.trace_rays`` is eager PyTorch over the
``SceneArrays`` tensors, so gradients with respect to the *continuous* scene
parameters -- material albedos, reflectance, metalness, roughness and
emission, light colour and intensity, sky colours and HDRI texels,
per-vertex colours -- flow through ``torch.autograd`` directly.  Everything
here goes through the fixed-schedule ``render.render_wave`` (one sample per
lane, every bounce of ``trace_rays``), never the regenerating
``render_samples``, as the reference does.

Estimator notes (as the reference's):
  - randomness is counter-based and independent of the parameters, so
    autograd computes the pathwise (fixed-decisions) derivative; finite
    differences with common random numbers (the same seed) measure the same
    quantity, which makes finite-difference checks tight, not statistical;
  - discrete path decisions (lobe choice, Russian roulette, light pick)
    depend on the parameters only through measure-zero branch boundaries;
  - visibility discontinuities are not handled (no edge sampling).

The gradient cut is the reference's: every traversal wrapper of ``ops/``
(K1-K9) detaches its rays and seeds, so the traversal is a discrete
selector whose outputs (t, primitive, entity) carry no gradient, on the
card and on the CPU alike (``ops/sphere_traverse.py``).  The parameters
below enter only through shading, which the integrator recomputes at the
returned hit, so their gradients run through the card's forward kernels with
no backward kernel.  Geometry derivatives through a kernel's hit distance
vanish there, as on the reference's Pallas path; the eager scans
(double-single spheres, small meshes) stay differentiable, as its XLA scans.

The backward pass keeps every bounce's tensors of the wave: a caller whose
wave would not fit in memory splits it into tiles and weights each tile's
gradient by its share of the lanes (the loss is a mean).
"""

from __future__ import annotations

import numpy as np
import torch

from paths_tpu_torch.render import render_wave
from paths_tpu_torch.scene.types import SceneArrays

# SceneArrays fields exposed as differentiable parameters.
PARAM_FIELDS = (
    "mat_albedo",
    "mat_emit",
    "mat_r0",
    "mat_metalness",
    "mat_roughness",
    "light_colour",
    "light_intensity",
    "ent_light_emission",
    "tri_vc0",
    "tri_vc1",
    "tri_vc2",
)
SKY_PARAM_FIELDS = ("colour_a", "colour_b", "image")


def get_params(scene: SceneArrays) -> dict:
    """The differentiable parameters: {field: tensor, "sky": {field:
    tensor}}, the scene's own tensors (set ``requires_grad`` on copies, as
    ``loss_and_grad`` does)."""
    p = {f: getattr(scene, f) for f in PARAM_FIELDS}
    p["sky"] = {f: getattr(scene.sky, f) for f in SKY_PARAM_FIELDS}
    return p


def with_params(scene: SceneArrays, params: dict) -> SceneArrays:
    """The scene with the parameters substituted."""
    kw = {f: params[f] for f in PARAM_FIELDS}
    kw["sky"] = scene.sky._replace(**params["sky"])
    return scene._replace(**kw)


def params_from_numpy(arrays: dict, device) -> dict:
    """The port's parameters on `device` from the reference package's
    ``get_params`` dict given as numpy arrays (f32 copies)."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    p = {f: t(arrays[f]) for f in PARAM_FIELDS}
    p["sky"] = {f: t(arrays["sky"][f]) for f in SKY_PARAM_FIELDS}
    return p


def _flat(params: dict) -> list:
    return [params[f] for f in PARAM_FIELDS] + [params["sky"][f] for f in SKY_PARAM_FIELDS]


def _unflat(leaves) -> dict:
    n = len(PARAM_FIELDS)
    p = dict(zip(PARAM_FIELDS, leaves[:n]))
    p["sky"] = dict(zip(SKY_PARAM_FIELDS, leaves[n:]))
    return p


def leaf_params(params: dict, fields=None) -> dict:
    """Leaf copies of the parameters, with ``requires_grad`` set on those
    named in `fields` (every field when None; a sky field by its own name)."""
    names = list(PARAM_FIELDS) + list(SKY_PARAM_FIELDS)
    return _unflat([x.detach().clone().requires_grad_(fields is None or name in fields)
                    for name, x in zip(names, _flat(params))])


def render_with_params(static, scene, params, cam, px, py, pixel_id, sample_id, seed):
    return render_wave(static, with_params(scene, params), cam, px, py, pixel_id,
                       sample_id, seed)


def l2_loss(static, params, scene, cam, px, py, pixel_id, sample_id, seed, target):
    """Mean squared error between a rendered wave and target radiance."""
    col = render_with_params(static, scene, params, cam, px, py, pixel_id, sample_id, seed)
    return torch.mean((col - target) ** 2)


def _grads(out, params: dict) -> dict:
    """d(out)/d(every parameter), zeros where a parameter does not reach
    `out`, in the parameters' structure."""
    leaves = _flat(params)
    wanted = [x for x in leaves if x.requires_grad]
    got = iter(torch.autograd.grad(out, wanted, allow_unused=True))
    grads = []
    for x in leaves:
        g = next(got) if x.requires_grad else None
        grads.append(torch.zeros_like(x) if g is None else g)
    return _unflat(grads)


def loss_and_grad(static, scene, cam, px, py, pixel_id, sample_id, seed, target):
    """(loss, grads) for one sample wave: the l2 loss against `target` (N,
    3) and its gradient with respect to every parameter, in the parameters'
    structure, through ``torch.autograd.grad`` on leaf copies of them."""
    params = leaf_params(get_params(scene))
    loss = l2_loss(static, params, scene, cam, px, py, pixel_id, sample_id, seed, target)
    return loss.detach(), _grads(loss, params)


def pixel_gradient(static, scene, cam, px, py, pixel_id, sample_id, seed, param_field):
    """d(mean pixel radiance)/d(param_field) for one sample wave: the probe
    the finite-difference checks use."""
    params = leaf_params(get_params(scene), (param_field,))
    col = render_with_params(static, scene, params, cam, px, py, pixel_id, sample_id, seed)
    g = _grads(torch.mean(col), params)
    return g[param_field] if param_field in g else g["sky"][param_field]
