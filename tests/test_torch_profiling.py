"""The port's profiling utilities and debug scope on the CPU (the
counterparts of tests/test_debug_profiling.py): ``debug.debug_checks`` turns
on autograd's anomaly detection with NaN checks and the output checks of the
renderer's entry points, and restores both; ``profiling.trace`` and the
CLI's --profile."""

import dataclasses
import glob
import json

import numpy as np
import pytest
import torch

from paths_tpu_torch import camera as C
from paths_tpu_torch import cli
from paths_tpu_torch import debug
from paths_tpu_torch import grad as G
from paths_tpu_torch.debug import debug_checks
from paths_tpu_torch.profiling import trace
from paths_tpu_torch.render import render_image, render_wave
from paths_tpu_torch.scene.build import build_scene
from paths_tpu_torch.scene.stress import generate_lit_stress_scene, generate_mixed_scene

torch.set_num_threads(2)

W, H = 32, 8


@pytest.fixture(scope="module")
def lit():
    """The lit 8-sphere stress scene, 3 bounces, at 32x8, with its wave."""
    return _at_32x8(*build_scene(generate_lit_stress_scene(8, seed=0), device="cpu"))


def _at_32x8(static, scene, cam):
    """3 bounces at 32x8, with the frame's wave (sample 0)."""
    pix = torch.arange(W * H, dtype=torch.int64)
    lanes = ((pix % W).to(torch.int32), (pix // W).to(torch.int32), pix,
             torch.zeros_like(pix))
    return dataclasses.replace(static, max_bounces=3), scene, C.resize(cam, W, H), lanes


def _settings():
    return (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled(),
            debug.CHECK_OUTPUTS)


def test_debug_checks_sets_and_restores():
    before = _settings()
    with debug_checks():
        assert _settings() == (True, True, True)
    assert _settings() == before


def test_debug_checks_restores_on_exception():
    before = _settings()
    with pytest.raises(KeyError):
        with debug_checks():
            raise KeyError("inside")
    assert _settings() == before


def _nan_sky(scene):
    """A copy of the scene with a NaN sky colour.  (A NaN albedo never
    reaches an output: a path whose throughput is not finite ends,
    integrator.path_step, as the reference's energy check ends it.)"""
    colour = scene.sky.colour_a.clone()
    colour[0] = float("nan")
    return scene._replace(sky=scene.sky._replace(colour_a=colour))


def test_nan_render_raises_inside_debug_checks(lit):
    static, scene, cam, _ = lit
    bad = _nan_sky(scene)
    with debug_checks():
        with pytest.raises(FloatingPointError, match="render_samples"):
            render_image(static, bad, cam, W, H, spp=1)


def test_nan_wave_raises_inside_debug_checks(lit):
    static, scene, cam, lanes = lit
    with debug_checks():
        with pytest.raises(FloatingPointError, match="render_wave"):
            render_wave(static, _nan_sky(scene), cam, *lanes, 0)


def test_nan_render_passes_outside_debug_checks(lit):
    static, scene, cam, _ = lit
    img = render_image(static, _nan_sky(scene), cam, W, H, spp=1)
    assert np.isnan(img).any()


def _mixed(tmp):
    """The mixed scene (40 spheres on the walk route, the 128-triangle grid
    on the kernel route), 3 bounces, at 32x8, with its wave."""
    return _at_32x8(*build_scene(generate_mixed_scene(tmp, n_spheres=40), device="cpu"))


@pytest.mark.parametrize("scene_name", ["lit stress-8", "mixed"])
def test_clean_render_and_gradient_pass_debug_checks(lit, tmp_path, scene_name):
    """No false alarm: the outputs of a clean render and every node of a
    clean backward are finite (the where-NaN trap would fail here: lanes
    that miss or are dead hold NaN and infinities in the double-single
    sphere test and the barycentrics unless they are kept finite)."""
    static, scene, cam, lanes = lit if scene_name != "mixed" else _mixed(str(tmp_path))
    with debug_checks():
        img = render_image(static, scene, cam, W, H, spp=2)
        loss, grads = G.loss_and_grad(static, scene, cam, *lanes, 0,
                                      torch.zeros((W * H, 3)))
    assert np.isfinite(img).all() and bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in G.flatten_params(grads))


def _trace_names(logdir):
    (path,) = glob.glob(str(logdir / "*.pt.trace.json"))
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_names_the_renderer(lit, tmp_path):
    static, scene, cam, lanes = lit
    with trace(str(tmp_path), device="cpu") as prof:
        render_wave(static, scene, cam, *lanes, 0)
    names = _trace_names(tmp_path)
    assert "paths_tpu_torch.render_wave" in names
    assert any(e.key == "paths_tpu_torch.render_wave" for e in prof.key_averages())


def test_cli_profile_writes_a_trace(tmp_path):
    cli.main(["--cpu", "--stress", "8", "--size", "16x8", "--spp", "1",
              "--profile", str(tmp_path / "prof"), "-o", str(tmp_path / "p.png")])
    assert "paths_tpu_torch.render_samples" in _trace_names(tmp_path / "prof")
