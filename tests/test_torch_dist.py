"""Data-parallel rendering and training in the port (``paths_tpu_torch.dist``
and ``render_image(mesh=...)``) on the CPU: two gloo ranks on a file store
(tests/torch_dist_worker.py), held against the port's single-process
results bit for bit and against the reference's at tests/test_dist.py's
bounds.  The ranks' lanes are contiguous shards and every lane's result is a
function of its own (pixel, sample) alone, so the shards put together are
the single-process output exactly; the estimator's shares are disjoint, so
their all-reduced sum is exact too.
"""

import dataclasses
import os
from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from paths_tpu import camera as JC
from paths_tpu import render as JR
from paths_tpu.scene.build import build_scene as jax_build
from paths_tpu.scene.stress import generate_stress_scene as jax_stress

import torch_dist_worker as WK
from paths_tpu_torch import dist
from paths_tpu_torch import grad as G
from paths_tpu_torch.render import render_image, render_samples, render_wave

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results and printed output."""
    tmp = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = WK.start_ranks(
        lambda r: ["tests/torch_dist_worker.py", str(r), str(WORLD), str(tmp / "store"),
                   str(tmp)], WORLD, env=lambda r: env)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], outs


def joined(ranks, key):
    return torch.cat([r[key] for r in ranks[0]])


@pytest.fixture(scope="module")
def single():
    """The port's single-process outputs of the worker's cases."""
    static, scene, cam = WK.tiny()
    px, py, pid, sid = WK.lanes(WK.W, WK.H)
    return dict(
        static=static, scene=scene, cam=cam, lanes=(px, py, pid, sid),
        wave=render_wave(static, scene, cam, px, py, pid, sid, 0),
        samples=render_samples(static, scene, cam, px, py, pid, 0, 2, 0),
        image=render_image(static, scene, cam, WK.W, WK.H, spp=2, seed=3))


@pytest.fixture(scope="module")
def reference():
    """The reference's render_wave and render_samples of the same frame."""
    jstatic, jscene, jcam = jax_build(jax_stress(8, seed=0))
    jstatic = dataclasses.replace(jstatic, max_bounces=2)
    jcam = JC.resize(jcam, WK.W, WK.H)
    px, py, pid, sid = (jnp.asarray(x.numpy().astype(d)) for x, d in zip(
        WK.lanes(WK.W, WK.H), (np.int32, np.int32, np.uint32, np.uint32)))
    wave = jax.jit(partial(JR.render_wave, jstatic))(jscene, jcam, px, py, pid, sid, 0)
    samples = jax.jit(partial(JR.render_samples, jstatic), static_argnums=(6,))(
        jscene, jcam, px, py, pid, jnp.uint32(0), 2, 0)
    return np.asarray(wave), np.asarray(samples)


def test_each_rank_reports_its_backend_and_device(ranks):
    results, outs = ranks
    for r, (res, out) in enumerate(zip(results, outs)):
        assert res["mesh"] == (r, WORLD, "cpu", "dp")
        assert f"[dist] rank {r} of {WORLD}: backend gloo, device cpu" in out


def test_shards_are_equal_and_not_gathered(ranks):
    for key in ("wave", "samples", "mixed_samples", "deep_samples"):
        shapes = {tuple(r[key].shape) for r in ranks[0]}
        assert len(shapes) == 1, (key, shapes)


@pytest.mark.parametrize("fn", ["wave", "samples"])
def test_sharded_render_matches_single_process(ranks, single, fn):
    assert torch.equal(joined(ranks, fn), single[fn])


@pytest.mark.parametrize("fn", ["wave", "samples"])
def test_sharded_render_matches_reference(ranks, reference, fn):
    want = reference[0] if fn == "wave" else reference[1]
    # tests/test_dist.py's sharded-vs-local bound.
    np.testing.assert_allclose(joined(ranks, fn).numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tile", WK.TILES)
def test_render_image_mesh_matches_single_process(ranks, single, tile):
    """With tiles of 101 pixels (102 on two ranks) the last tile is mostly
    padding, all on rank 1, which must drop it."""
    for res in ranks[0]:
        np.testing.assert_array_equal(res[f"image_tile{tile}"], single["image"])


def test_dp_resumed_render_matches_whole(ranks, single, tmp_path):
    """A dp render resumed from a checkpoint loaded on every rank counts the
    checkpoint once, and equals the single-process whole render with the
    same batches bit for bit; on_batch fires on rank 0 alone."""
    static, scene, cam = single["static"], single["scene"], single["cam"]
    whole = render_image(static, scene, cam, WK.W, WK.H, spp=2, seed=3, sample_batch=1)
    assert np.array_equal(WK.resumed_part(static, scene, cam, str(tmp_path / "ck.npz")),
                          whole)
    for res in ranks[0]:
        np.testing.assert_array_equal(res["resumed"], whole)
    assert [r["on_batch_calls"] for r in ranks[0]] == [[2], []]


def test_sharded_train_step_matches_local_grads(ranks, single):
    """The mean of the shards' losses and gradients is the whole wave's
    (tests/test_dist.py's bounds), and every rank holds the same update."""
    static, scene, cam = single["static"], single["scene"], single["cam"]
    target = torch.zeros((WK.W * WK.H, 3))
    loss, grads = G.loss_and_grad(static, scene, cam, *single["lanes"], 0, target)
    want = [p - 0.05 * g for p, g in zip(G.flatten_params(G.get_params(scene)),
                                         G.flatten_params(grads))]
    for res in ranks[0]:
        np.testing.assert_allclose(float(res["train_loss"]), float(loss), rtol=1e-5)
        for got, exp in zip(G.flatten_params(res["train_params"]), want):
            np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=1e-4, atol=1e-6)
    a, b = (G.flatten_params(r["train_params"]) for r in ranks[0])
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_sharded_train_step_loss_matches_reference(ranks, reference):
    """The l2 loss against a zero target is the mean square of the wave
    (grad.py l2_loss in both packages): the reference's, from its
    render_wave, at test_torch_grad.py's bound."""
    want = float(np.mean(reference[0].astype(np.float64) ** 2))
    for res in ranks[0]:
        np.testing.assert_allclose(float(res["train_loss"]), want, rtol=1e-4)


def test_mixed_scene_sharded_matches_single_process(ranks, tmp_path):
    """K1-K4's wrappers (their plain versions here) on each rank's shard."""
    static, scene, cam = WK.mixed(str(tmp_path))
    px, py, pid, _ = WK.lanes(WK.MIXED_W, WK.MIXED_H)
    want = render_samples(static, scene, cam, px, py, pid, 0, 2, 0)
    got = joined(ranks, "mixed_samples")
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def test_full_depth_sharded_matches_single_process(ranks, single):
    """max_bounces=10, the reference's trace.rs:14 cap (tests/test_dist.py's
    full-depth case)."""
    static, scene, cam = WK.tiny(max_bounces=10)
    px, py, pid, _ = single["lanes"]
    want = render_samples(static, scene, cam, px, py, pid, 0, 1, 0)
    got = joined(ranks, "deep_samples")
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def test_lanes_must_divide_over_the_ranks(single):
    mesh = dist.Mesh(group=None, rank=0, size=3, device=torch.device("cpu"))
    fwd = dist.sharded_render_wave(single["static"], mesh)
    with pytest.raises(ValueError, match="do not divide"):
        fwd(single["scene"], single["cam"], *single["lanes"], 0)


@pytest.mark.parametrize("device_type, local_ranks, cards, want", [
    ("cpu", 2, 0, "gloo"),
    ("cuda", 2, 1, "gloo"),  # two ranks would share the one card
    ("cuda", 1, 1, "cpu:gloo,cuda:nccl"),
    ("cuda", 4, 4, "cpu:gloo,cuda:nccl"),
])
def test_choose_backend(monkeypatch, device_type, local_ranks, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert dist.choose_backend(device_type, local_ranks) == want
