"""Shared cases of the port's gradient tests (tests/test_torch_grad*.py):
one sample wave through the reference's ``loss_and_grad`` and the port's on
the same scene arrays, camera, lanes and seed, and the comparison of the two
gradient structures.

The reference's gradients carry NaN in two places where the port's are
finite, both the where-NaN trap of a branch that a lane does not take
(0 * inf or 0 * NaN in the backward pass):

- ``mat_roughness`` of entities whose shading never reads roughness (every
  material but Cook-Torrance): the port's gradient there is exactly 0, the
  true derivative;
- ``tri_vc*`` of meshes whose material does not read vertex colours (on
  the mixed scene every row: lanes off triangles gather a triangle's
  colours with NaN barycentrics, a dead lane's far origin, and the backward
  pass scatters NaN onto the rows); the port zeroes those lanes'
  barycentrics (``integrator.intersect_full``), and its gradient there is
  exactly 0, the true derivative.

Everywhere else the two must agree to the reference's own bound between its
backends (tests/test_grad.py, rtol 2e-3, atol 1e-5).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paths_tpu import camera as JC
from paths_tpu import grad as JG
from paths_tpu_torch import camera as TC
from paths_tpu_torch import grad as G
from paths_tpu_torch import materials as TM
from paths_tpu_torch.sampling import hashing as TH
from paths_tpu_torch.scene.types import scene_from_numpy
from test_torch_render import _as_numpy

RTOL = 2e-3
ATOL = 1e-5


def lanes(n=256, W=16):
    """(px, py, pixel_id, sample_id) of an n-lane wave over a W-wide image,
    as numpy (tests/test_grad.py::_wave_args)."""
    H = max(1, n // W)
    pix = np.arange(n, dtype=np.uint32)
    return ((pix % W).astype(np.int32), (pix // W % H).astype(np.int32), pix,
            np.zeros(n, np.uint32))


def port_scene(jstatic, jscene, jcam, W, H):
    """The port's (static, scene, camera) on the CPU from the reference's,
    its parameters fed through ``grad.params_from_numpy``."""
    static, scene = scene_from_numpy(dataclasses.asdict(jstatic), _as_numpy(jscene), "cpu")
    params = G.params_from_numpy(jax.tree.map(np.asarray, JG.get_params(jscene)), "cpu")
    cam = TC.Camera(*[torch.tensor(np.asarray(x)) for x in JC.resize(jcam, W, H)])
    return static, G.with_params(scene, params), cam


def both_loss_and_grad(jstatic, jscene, jcam, n=256, W=16, seed=0):
    """(port loss, port grads, reference loss, reference grads as numpy) for
    one wave against a zero target."""
    px, py, pix, sid = lanes(n, W)
    H = max(1, n // W)
    target = np.zeros((n, 3), np.float32)
    jl, jg = jax.jit(partial(JG.loss_and_grad, jstatic))(
        jscene, JC.resize(jcam, W, H), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(pix), jnp.asarray(sid), seed, jnp.asarray(target))
    static, scene, cam = port_scene(jstatic, jscene, jcam, W, H)
    loss, grads = G.loss_and_grad(static, scene, cam, torch.from_numpy(px),
                                  torch.from_numpy(py), TH.as_u32(pix),
                                  TH.as_u32(sid), seed, torch.from_numpy(target))
    return loss, grads, float(jl), jax.tree.map(np.asarray, jg)


def _field(grads, name):
    return grads["sky"][name] if name in G.SKY_PARAM_FIELDS else grads[name]


def assert_grads_match(grads, ref, jscene):
    """Every port gradient finite; equal to the reference's where that is
    finite, field by field and row by row (the port runs on the
    reference's own arrays, so no primitive is permuted); where it is not,
    only the two traps of the module docstring, where the port's is 0.
    ``jscene``: the reference's SceneArrays.  Returns the number of compared
    values that are not zero."""
    mtype = np.asarray(jscene.mat_mtype)
    vertex = np.asarray(jscene.mat_albedo_vertex)[np.asarray(jscene.tri_ent)]
    nonzero = 0
    for name in G.PARAM_FIELDS + G.SKY_PARAM_FIELDS:
        got, want = _field(grads, name).numpy(), _field(ref, name)
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), f"non-finite port gradient in {name}"
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL,
                                   err_msg=f"grad mismatch for {name}")
        nonzero += int((want[fin] != 0).sum())
        if fin.all():
            continue
        if name == "mat_roughness":
            assert not (mtype[~fin] == TM.COOK_TORRANCE).any(), name
        elif name.startswith("tri_vc"):
            assert not vertex[~fin.all(axis=1)].any(), name
        else:
            raise AssertionError(f"non-finite reference gradient in {name}")
        np.testing.assert_array_equal(got[~fin], 0.0, err_msg=name)
    return nonzero
