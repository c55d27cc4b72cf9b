"""The port's progressive runtime, viewer and radiance check on the CPU
(``paths_tpu_torch.progressive``, ``.viewer``, ``.debug``), held against the
reference package where it has the same function: the ANSI frame encoder on
the same bytes, the epoch seed fold, a preview frame of the same scene, and
``validate_radiance``'s report.  The pipelined pump's stale-epoch rule is
tests/test_viewer.py's test, ported."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paths_tpu import debug as JDBG
from paths_tpu import progressive as JP
from paths_tpu import viewer as JV
from paths_tpu.scene.build import build_scene as jax_build
from paths_tpu.scene.stress import generate_stress_scene as jax_stress

from paths_tpu_torch import camera as C
from paths_tpu_torch import debug as DBG
from paths_tpu_torch import progressive as P
from paths_tpu_torch import viewer as V
from paths_tpu_torch.scene.build import build_scene
from paths_tpu_torch.scene.stress import generate_stress_scene
from paths_tpu_torch.scene.types import scene_from_numpy
from test_torch_render import _as_numpy
from test_viewer import _naive_ansi

torch.set_num_threads(2)

W, H = 24, 12


def test_frame_to_ansi_matches_naive():
    rng = np.random.default_rng(0)
    for h, w in [(8, 5), (7, 3), (2, 1), (10, 16)]:
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        # Exercise the digit-count edge values.
        img.reshape(-1)[::7] = 0
        img.reshape(-1)[1::11] = 255
        got = V._frame_to_ansi(img)
        assert got == _naive_ansi(img) == JV._frame_to_ansi(img), (h, w)


@pytest.fixture(scope="module")
def small():
    static, scene, cam = build_scene(generate_stress_scene(4, seed=0), device="cpu")
    return dataclasses.replace(static, max_bounces=2), scene, C.resize(cam, W, H)


def test_pipelined_pump_drops_stale_epoch(small):
    """A camera move while a wave is in flight must drop that wave: the
    estimator may only contain post-reset samples."""
    static, scene, cam = small
    r = P.ProgressiveRenderer(static, scene, cam, W, H)
    r.pump()  # dispatch the preview wave (nothing accumulated yet: pipelined)
    assert r.estimator.count.sum() == 0
    r.set_camera(cam.location.numpy() + [0.1, 0, 0], cam.rot.numpy())
    epoch_after_move = r.epoch
    r.pump()  # the stale wave arrives and is dropped; a new preview dispatched
    assert r.estimator.count.sum() == 0, "stale-epoch wave leaked"
    r.pump()  # the post-move preview lands
    n_preview = len(r._prev_idx)
    assert r.estimator.count.sum() == n_preview
    assert r.epoch == epoch_after_move
    r.pump()  # a full wave of the new epoch lands
    assert r.estimator.count.sum() == n_preview + W * H
    assert np.isfinite(r.frame()).all()


@pytest.fixture(scope="module")
def reference_small():
    jstatic, jscene, jcam = jax_build(jax_stress(4, seed=0))
    jstatic = dataclasses.replace(jstatic, max_bounces=2)
    return jstatic, jscene, JP.C.resize(jcam, W, H)


def test_epoch_seed_matches_reference(reference_small, monkeypatch):
    """The epoch fold seed + epoch * 0x9E3779B9 mod 2^32, as masked Python
    ints, equals the seed the reference's pump passes for epochs 0-5."""
    seeds = []

    def spy(static, scene, cam, px, py, pid, start, n_samples, seed):
        seeds.append(int(seed))
        return jnp.zeros((px.shape[0], 3))

    monkeypatch.setattr(JP, "_render_samples_jit", spy)
    for base in (0, 12345, 0xFFFFFFFF):
        r = JP.ProgressiveRenderer(*reference_small, W, H, seed=base)
        for epoch in range(6):
            r.epoch = epoch
            r._dispatch()
        assert seeds[-6:] == [P.epoch_seed(base, e) for e in range(6)], base
    assert len(set(seeds)) == 18


def test_preview_frame_matches_reference(reference_small):
    """frame() after the preview wave has landed (two pumps: the preview is
    collected, the first full wave dispatched), on the same scene arrays:
    the preview grid filled in from 1/36 of the lanes, to the image
    tolerance of test_torch_render.py (relative MSE < 1e-4)."""
    jstatic, jscene, jcam = reference_small
    static, scene = scene_from_numpy(dataclasses.asdict(jstatic), _as_numpy(jscene), "cpu")
    cam = C.Camera(*[torch.tensor(np.asarray(x)) for x in jcam])
    frames = []
    for r in (P.ProgressiveRenderer(static, scene, cam, W, H, seed=5),
              JP.ProgressiveRenderer(jstatic, jscene, jcam, W, H, seed=5)):
        r.pump()
        r.pump()
        assert r.estimator.count.sum() == len(r._prev_idx)
        frames.append(r.frame())
    got, want = frames
    assert np.isfinite(got).all() and got.max() > 0
    rel = np.mean((got - want) ** 2) / (np.mean(want ** 2) + 1e-12)
    assert rel < 1e-4


def test_validate_radiance_matches_reference():
    rng = np.random.default_rng(1)
    c = rng.uniform(-0.1, 2.0, (500, 3)).astype(np.float32)
    c[::37, 1] = np.nan
    c[5::41, 2] = np.inf
    c[7::53, 0] = -np.inf
    got, want = DBG.validate_radiance(torch.from_numpy(c)), JDBG.validate_radiance(c)
    assert (got.n, got.n_nan, got.n_inf, got.n_negative) == (
        want.n, want.n_nan, want.n_inf, want.n_negative)
    assert got.n_nan and got.n_inf and got.n_negative and not got.ok
    assert str(got) == str(want)
    with pytest.raises(FloatingPointError):
        DBG.validate_radiance(c, strict=True)
    assert DBG.validate_radiance(np.abs(np.nan_to_num(c, posinf=1.0, neginf=1.0))).ok


def test_viewer_runs_headless(capsys):
    """The viewer's entry point on the CPU, no terminal: it pumps, draws
    ANSI frames and returns after --seconds."""
    r = V.main(["--cpu", "--stress", "4", "--size", "24x12", "--seconds", "0.2"])
    out = capsys.readouterr().out
    assert "\x1b[38;2;" in out and "fps" in out
    assert r.estimator.count.sum() > 0 and np.isfinite(r.frame()).all()
