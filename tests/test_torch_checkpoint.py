"""Checkpoint and resume in the port (``paths_tpu_torch.checkpoint``, the
resume arguments of ``render.render_image`` and the CLI's --checkpoint), on
the CPU: a render interrupted, checkpointed and resumed must be bit-identical
to an uninterrupted one (tests/test_checkpoint.py's tests, ported), and a
checkpoint file written by either package loads in the other."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from paths_tpu import checkpoint as JCK
from paths_tpu import render as JR

from paths_tpu_torch import camera as C
from paths_tpu_torch import cli
from paths_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from paths_tpu_torch.render import Estimator, render_image
from paths_tpu_torch.scene.build import build_scene
from paths_tpu_torch.scene.stress import generate_stress_scene

torch.set_num_threads(2)

W, H = 24, 16


@pytest.fixture(scope="module")
def small_scene():
    static, scene, cam = build_scene(generate_stress_scene(8, seed=1), device="cpu")
    static = dataclasses.replace(static, max_bounces=3)
    return static, scene, C.resize(cam, W, H)


def _random_estimator(estimator_cls, seed=0):
    est = estimator_cls(7, 5)
    rng = np.random.default_rng(seed)
    est.sum[:] = rng.uniform(size=(5, 7, 3))
    est.count[:] = rng.integers(0, 100, (5, 7))
    return est


def test_checkpoint_round_trip(tmp_path):
    est = _random_estimator(Estimator)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, est, next_sample=12, seed=42)
    est2, next_sample, seed = load_checkpoint(p)
    assert (next_sample, seed) == (12, 42)
    np.testing.assert_array_equal(est2.sum, est.sum)
    np.testing.assert_array_equal(est2.count, est.count)
    assert os.listdir(tmp_path) == ["ck.npz"]  # the temp file was renamed


def test_checkpoint_rejects_foreign_file(tmp_path):
    p = str(tmp_path / "bogus.npz")
    np.savez(p, a=np.zeros(3))
    with pytest.raises(ValueError):
        load_checkpoint(p)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_files_load_in_both_packages(tmp_path, writer):
    """One layout and one magic: a file written by either package loads in
    the other with the same estimator, next sample and seed."""
    save, load = ((save_checkpoint, JCK.load_checkpoint) if writer == "port"
                  else (JCK.save_checkpoint, load_checkpoint))
    est = _random_estimator(Estimator if writer == "port" else JR.Estimator, seed=3)
    p = str(tmp_path / "ck.npz")
    save(p, est, next_sample=24, seed=7)
    est2, next_sample, seed = load(p)
    assert (next_sample, seed, est2.width, est2.height) == (24, 7, 7, 5)
    np.testing.assert_array_equal(est2.sum, est.sum)
    np.testing.assert_array_equal(est2.count, est.count)


def test_resumed_render_bit_identical(tmp_path, small_scene):
    static, scene, cam = small_scene
    img_full = render_image(static, scene, cam, W, H, spp=8, seed=3, sample_batch=4)

    # Interrupted after 4 samples, checkpointed, resumed from the file.
    p = str(tmp_path / "ck.npz")
    est = Estimator(W, H)
    seen = []
    render_image(static, scene, cam, W, H, spp=4, seed=3, est=est, sample_batch=4,
                 on_batch=lambda e, s: seen.append((e is est, s)))
    assert seen == [(True, 4)]
    save_checkpoint(p, est, next_sample=4, seed=3)

    est2, start, seed = load_checkpoint(p)
    img_resumed = render_image(static, scene, cam, W, H, spp=8, seed=seed, est=est2,
                               start_sample=start, sample_batch=4)
    np.testing.assert_array_equal(img_resumed, img_full)


def _cli(tmp_path, *args):
    return cli.main(["--cpu", "--stress", "40", "--size", f"{W}x{H}", "--max-bounces",
                     "3", "-o", str(tmp_path / "out.png"), *args])


def test_cli_checkpoint_resumes_bit_identically(tmp_path, capsys):
    """--checkpoint: a render stopped at 8 samples and started again at 16
    resumes from the file and equals one uninterrupted 16-sample render (the
    same 8-sample batches)."""
    ck = str(tmp_path / "ck.npz")
    whole = _cli(tmp_path, "--spp", "16", "--check")
    first = _cli(tmp_path, "--spp", "8", "--checkpoint", ck)
    assert load_checkpoint(ck)[1] == 8
    resumed = _cli(tmp_path, "--spp", "16", "--checkpoint", ck, "--check")
    out = capsys.readouterr().out
    assert f"resumed {ck} at sample 8" in out and "[check] samples=384 nan=0" in out
    assert load_checkpoint(ck)[1] == 16
    np.testing.assert_array_equal(resumed, whole)
    assert not np.array_equal(first, whole)


@pytest.mark.parametrize("other", [["--seed", "1"], ["--size", "16x16"]])
def test_cli_refuses_checkpoint_of_other_settings(tmp_path, other):
    ck = str(tmp_path / "ck.npz")
    _cli(tmp_path, "--spp", "2", "--checkpoint", ck)
    with pytest.raises(SystemExit, match="was taken with different render settings"):
        _cli(tmp_path, "--spp", "4", "--checkpoint", ck, *other)
