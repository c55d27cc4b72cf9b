"""The port's spans, units of work and counters on the CPU
(``paths_tpu_torch.profiling``): off by default and recording nothing, the
renderer's results unchanged by the recorder, every bounce iteration's span
with its random draws and host sync under its wave, the gradient's backward
after its forward in one step, the progressive loop's preview dispatches and
stale lane-samples, the library loads' totals, and the spans on the
profiler's own clock."""

import dataclasses
import glob
import json
import shutil

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from paths_tpu_torch import camera as C
from paths_tpu_torch import grad as G
from paths_tpu_torch import integrator as I
from paths_tpu_torch import native
from paths_tpu_torch import profiling as P
from paths_tpu_torch import render as R
from paths_tpu_torch import sky as SK
from paths_tpu_torch.progressive import ProgressiveRenderer
from paths_tpu_torch.scene.build import build_scene
from paths_tpu_torch.scene.stress import generate_lit_stress_scene
from paths_tpu_torch.scene.yaml_loader import load_scene_description

torch.set_num_threads(2)

W, H = 16, 8
PATH_STEP = "paths_tpu_torch.path_step"
SYNC = "paths_tpu_torch.wavefront_sync"
RNG = "paths_tpu_torch.rng"
SAMPLES = "paths_tpu_torch.render_samples"
WAVE = "paths_tpu_torch.render_wave"
BACKWARD = "paths_tpu_torch.grad_backward"
DISPATCH = "paths_tpu_torch.dispatch"
ENV_NEE = "paths_tpu_torch.env_nee"
# Draws a bounce of the lit scene makes: the light's pick, u and v, the
# lobe, the BSDF's u and v, Russian roulette.
DRAWS_PER_STEP = 7


@pytest.fixture(scope="module")
def lit():
    """The lit 8-sphere stress scene, 3 bounces, at 16x8, with its wave."""
    static, scene, cam = build_scene(generate_lit_stress_scene(8, seed=0), device="cpu")
    pix = torch.arange(W * H, dtype=torch.int64)
    lanes = ((pix % W).to(torch.int32), (pix // W).to(torch.int32), pix,
             torch.zeros_like(pix))
    return dataclasses.replace(static, max_bounces=3), scene, C.resize(cam, W, H), lanes


@pytest.fixture(scope="module")
def env_demo():
    """scenes/env_demo.yml (three spheres on a ground sphere under the
    256x128 sunrise HDRI, no light), 3 bounces, at 16x8."""
    static, scene, cam = build_scene(load_scene_description("scenes/env_demo.yml"), device="cpu")
    return dataclasses.replace(static, max_bounces=3), scene, C.resize(cam, W, H)


def _render(lit, spp=2):
    static, scene, cam, _ = lit
    return R.render_image(static, scene, cam, W, H, spp=spp, seed=5, tile_pixels=48)


def _step(lit):
    static, scene, cam, lanes = lit
    return G.loss_and_grad(static, scene, cam, *lanes, 3, torch.full((W * H, 3), 0.25))


def _named(rec, name):
    return [s for s in rec.spans if s.name == name]


def test_recorder_off_by_default_records_nothing(lit):
    assert P._record is None
    _render(lit, spp=1)
    P.count("stale_lane_samples", 5)  # no record on: nothing to add to
    with P.record() as rec:
        pass
    assert rec.spans == [] and rec.counts == {} and P._record is None
    with P.record():
        with pytest.raises(RuntimeError, match="already on"):
            with P.record():
                pass
    assert P._record is None


def test_render_identical_with_recorder_on(lit):
    off = _render(lit)
    with P.record() as rec:
        on = _render(lit)
    assert _named(rec, PATH_STEP)
    np.testing.assert_array_equal(on, off)


def test_loss_and_grad_identical_with_recorder_on(lit):
    loss_off, g_off = _step(lit)
    with P.record() as rec:
        loss_on, g_on = _step(lit)
    assert _named(rec, BACKWARD)
    assert torch.equal(loss_on, loss_off)
    for a, b in zip(G.flatten_params(g_on), G.flatten_params(g_off)):
        assert torch.equal(a, b)


def test_path_step_spans_under_their_wave(lit, monkeypatch):
    """One path_step span a call; a wavefront_sync before each iteration
    and one after the last; each under its render_samples span, in its
    wave's unit."""
    calls = []
    orig = I.path_step
    monkeypatch.setattr(I, "path_step", lambda *a: calls.append(1) or orig(*a))
    with P.record() as rec:
        _render(lit)
    waves = _named(rec, SAMPLES)
    steps = _named(rec, PATH_STEP)
    syncs = _named(rec, SYNC)
    assert len(waves) == 3  # 128 pixels in tiles of 48
    assert len(steps) == len(calls) > len(waves)
    assert len(syncs) == len(steps) + len(waves)
    units = {s.unit for s in waves}
    assert len(units) == len(waves) and None not in units
    for s in steps + syncs:
        parent = rec.spans[s.parent]
        assert parent.name == SAMPLES and s.unit == parent.unit
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    for w in waves:
        mine = [s for s in steps if s.unit == w.unit]
        assert len([s for s in syncs if s.unit == w.unit]) == len(mine) + 1


def test_rng_spans_in_path_step_and_regeneration(lit):
    with P.record() as rec:
        _render(lit, spp=1)
    by_parent = {}
    for s in _named(rec, RNG):
        by_parent.setdefault(s.parent, []).append(s)
        assert rec.spans[s.parent].unit == s.unit
    parents = {rec.spans[i].name for i in by_parent}
    assert parents == {PATH_STEP, SAMPLES}
    for i, draws in by_parent.items():
        if rec.spans[i].name == PATH_STEP:
            assert len(draws) == DRAWS_PER_STEP
    # The regeneration hashes once before the loop and once an iteration.
    for i, w in enumerate(rec.spans):
        if w.name == SAMPLES:
            steps = [s for s in _named(rec, PATH_STEP) if s.unit == w.unit]
            assert len(by_parent[i]) == len(steps) + 1


def test_grad_backward_after_forward_in_one_step(lit):
    with P.record() as rec:
        _step(lit)
        _step(lit)
    forwards, backwards = _named(rec, WAVE), _named(rec, BACKWARD)
    assert len(forwards) == len(backwards) == 2
    assert forwards[0].unit != forwards[1].unit
    for f, b in zip(forwards, backwards):
        assert f.unit == b.unit is not None
        assert f.end_ns <= b.start_ns <= b.end_ns
        assert b.parent is None
    # The forward's bounce iterations belong to the step too.
    steps = _named(rec, PATH_STEP)
    assert steps and {s.unit for s in steps} == {f.unit for f in forwards}


def test_progressive_counts_as_the_probes_count(lit, monkeypatch):
    """A scripted fly-cam: pumps, moves while a wave is in flight.  The
    counters equal the benchmark probes' rule (``portbench/probes.py``):
    every dispatched record's lanes times its samples is sent; a pending
    record of an older epoch, collected by pump, is stale."""
    static, scene, cam, _ = lit
    r = ProgressiveRenderer(static, scene, cam, W, H)
    seen = {"sent": 0, "stale": 0, "preview": 0}
    dispatch, pump = ProgressiveRenderer._dispatch, ProgressiveRenderer.pump

    def counted_dispatch(self):
        seen["preview"] += self._preview_pending
        rec = dispatch(self)
        seen["sent"] += rec[3].shape[0] * rec[2]
        return rec

    def counted_pump(self):
        pending = self._pending
        out = pump(self)
        if pending is not None and pending[0] != self.epoch:
            seen["stale"] += pending[3].shape[0] * pending[2]
        return out

    monkeypatch.setattr(ProgressiveRenderer, "_dispatch", counted_dispatch)
    monkeypatch.setattr(ProgressiveRenderer, "pump", counted_pump)
    loc, rot = cam.location.numpy(), cam.rot.numpy()
    with P.record() as rec:
        for frame in range(7):
            if frame in (2, 3, 5):
                r.set_camera(loc + [0.1 * frame, 0, 0], rot)
            r.pump()
    dispatches = _named(rec, DISPATCH)
    assert len(dispatches) == 7
    assert sum(s.attrs["preview"] for s in dispatches) == seen["preview"] == 4
    assert rec.counts["sent_lane_samples"] == seen["sent"] > 0
    assert rec.counts["stale_lane_samples"] == seen["stale"] > 0
    for d in dispatches:
        (wave,) = [s for s in _named(rec, SAMPLES) if rec.spans[s.parent] is d]
        assert wave.unit == d.unit is not None


def test_native_loads_counted(tmp_path, monkeypatch):
    """The mesh parser's library, built by g++ into an empty folder, then
    found built: seconds both times, one compile."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the mesh parser")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    key = "mesh_io.cc"
    s0, b0 = P.NATIVE_LOAD_S.get(key, 0.0), P.NATIVE_BUILDS.get(key, 0)
    native.library(key)
    s1, b1 = P.NATIVE_LOAD_S[key], P.NATIVE_BUILDS[key]
    assert b1 == b0 + 1 and s1 > s0
    monkeypatch.setattr(native, "_libs", {})
    native.library(key)
    assert P.NATIVE_BUILDS[key] == b1 and P.NATIVE_LOAD_S[key] > s1


def test_units_nest_into_the_outermost():
    with P.record() as rec:
        with P.span("paths_tpu_torch.a"):
            pass
        with P.unit(), P.span("paths_tpu_torch.b", k=1):
            with P.unit(), P.span("paths_tpu_torch.c"):
                P.count("n", 2)
        with P.unit():
            P.span("paths_tpu_torch.d")(lambda: None)()
    a, b, c, d = rec.spans
    assert a.unit is None and a.parent is None
    assert b.unit == c.unit == 0 and c.parent == 1 and b.attrs == {"k": 1}
    assert d.unit == 1 and rec.counts == {"n": 2}
    assert all(s.end_ns >= s.start_ns > 0 for s in rec.spans)


def test_spans_on_the_profilers_clock(lit):
    """Under the CPU profiler each recorded span lies inside its own
    record_function range, within 2 ms at each end: the span is stamped
    after the range opens and before it closes, on the range's clock."""
    tol = 2_000_000
    with P.record() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _render(lit, spp=1)
            _step(lit)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("paths_tpu_torch."):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    names = {s.name for s in rec.spans}
    assert {PATH_STEP, SYNC, RNG, SAMPLES, WAVE, BACKWARD} <= names
    for name in names:
        spans = _named(rec, name)
        got = sorted(ranges[name])
        assert len(got) == len(spans), name
        for s, (lo, hi) in zip(spans, got):
            assert 0 <= s.start_ns - lo <= tol and 0 <= hi - s.end_ns <= tol, name


def test_trace_holds_the_spans(lit, tmp_path):
    """The CLI's --profile trace: each span is a range while the profiler
    runs, with no recorder on."""
    with P.trace(str(tmp_path), device="cpu"):
        _render(lit, spp=1)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {SAMPLES, PATH_STEP, SYNC, RNG} <= names


def _lanes_per_step(monkeypatch):
    """Wraps integrator.path_step: the list of each call's lane count."""
    lanes = []
    orig = I.path_step
    monkeypatch.setattr(I, "path_step",
                        lambda *a: lanes.append(a[3][0].shape[0]) or orig(*a))
    return lanes


@pytest.mark.parametrize("case", ["hdri_env_nee", "hdri", "gradient_env_nee"])
def test_env_spans_only_with_env_nee_on_an_hdri_sky(env_demo, monkeypatch, case):
    """An ``env_nee`` span in every bounce iteration with environment NEE on
    an HDRI sky, and none otherwise, each inside its ``path_step`` span."""
    static, scene, cam = env_demo
    if case == "gradient_env_nee":
        static = dataclasses.replace(static, sky_type=SK.GRADIENT)
    static = dataclasses.replace(static, env_nee=case.endswith("env_nee"))
    lanes = _lanes_per_step(monkeypatch)
    with P.record() as rec:
        R.render_image(static, scene, cam, W, H, spp=2, seed=5, tile_pixels=48)
    steps = _named(rec, PATH_STEP)
    assert len(steps) == len(lanes) > 3
    envs = _named(rec, ENV_NEE)
    assert len(envs) == (len(steps) if case == "hdri_env_nee" else 0)
    for s in envs:
        parent = rec.spans[s.parent]
        assert parent.name == PATH_STEP and s.unit == parent.unit is not None
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_env_nee_span_once_a_step_under_the_profiler(env_demo, monkeypatch):
    """Under a profiler too, the env_nee span opens once a path_step call
    (three tiles of 48 lanes, the last padded), as a range of the trace."""
    static, scene, cam = env_demo
    static = dataclasses.replace(static, env_nee=True)
    lanes = _lanes_per_step(monkeypatch)
    with P.record() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            R.render_image(static, scene, cam, W, H, spp=1, seed=9, tile_pixels=48)
    assert set(lanes) == {48}
    assert len(_named(rec, ENV_NEE)) == len(lanes)
    ranges = [e for e in prof.events() if e.name == ENV_NEE]
    assert len(ranges) == len(lanes)


def test_env_spans_off_make_nothing(env_demo, monkeypatch):
    """With the recorder and the profiler off, the environment light's span
    opens no range and records nothing."""
    static, scene, cam = env_demo
    static = dataclasses.replace(static, env_nee=True)

    def fail(*a, **k):
        raise AssertionError("a span or range was made")

    monkeypatch.setattr(P, "Span", fail)
    monkeypatch.setattr(torch.profiler, "record_function", fail)
    assert P._record is None
    img = R.render_image(static, scene, cam, W, H, spp=1, seed=9, tile_pixels=48)
    assert np.isfinite(img).all() and P._record is None
