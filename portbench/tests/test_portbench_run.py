"""Whole runs of small cells on the CPU (the program's plain versions of its
kernels): the result line's keys, the traced run's per-layer metrics, the
reference against the program where both are sound, and the refusal
without a card."""

import json
import os
import subprocess
import sys
import tempfile

import pytest

from portbench import harness
from portbench.tests import small

ROOT = os.path.dirname(harness.BENCH_DIR)
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.fixture(scope="module")
def mesh_dir():
    with tempfile.TemporaryDirectory() as d:
        yield d


def small_cell(name, mesh_dir):
    """(config, mix, limits) of a BENCHMARK.json cell at a CPU test's size:
    the cell's mix with smaller tiles and its own limits."""
    cell = {c["name"]: c for c in BENCH["workloads"]}[name]
    mix = dict(harness.load_mix(cell["traffic"]))
    if mix["kind"] == "render":
        mix["tile_pixels"] = 512
    if mix["kind"] == "grad":
        mix["tile_pixels"] = 300
        mix["target_grid"] = [3, 4]
    cfg = small.small_mesh(mesh_dir) if cell["config"] == "doom" else small.small_stress()
    return cfg, mix, harness.load_limits(name)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["workloads"]])
def test_small_cell_is_correct(name, mesh_dir):
    cfg, mix, limits = small_cell(name, mesh_dir)
    r = small.run(cfg, mix, limits, seconds=0.6)
    assert list(r)[:len(KEYS) - 1] == KEYS[:-1] and list(r)[-2:] == ["compared", "setup_s"]
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    (e2e, unit), = [small.E2E[mix["kind"]]]
    assert r["metrics"][e2e]["value"] > 0 and r["metrics"][e2e]["unit"] == unit
    assert set(r["compared"]) == set(limits)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["workloads"]])
def test_small_cell_traced(name, mesh_dir):
    cfg, mix, limits = small_cell(name, mesh_dir)
    per_layer = harness.cell_metrics(BENCH, name, "per_layer")
    bench = small.bench_for(mix["kind"], per_layer)
    r = small.run(cfg, mix, limits, seconds=1.0, trace=True, bench=bench, name=name)
    assert r["correct"]
    assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r
    got = set(r["metrics"])
    # On the CPU nothing runs on a device: the device-trace metrics stay
    # silent, the host's are read.
    host = {m["name"] for m in per_layer if m["source"] != "device_trace"}
    if mix["kind"] == "interactive":
        host.discard("stale_pct.interactive")  # a short window may drop nothing
    assert host <= got <= {m["name"] for m in per_layer}


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "doom.grad",
                          "--seed", str(2**40 + 1), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_result_line_is_json_with_compared_last(mesh_dir):
    cfg, mix, limits = small_cell("stress500.render", mesh_dir)
    r = small.run(cfg, mix, limits, seconds=0.3)
    r.pop("setup_s")
    line = json.loads(json.dumps(r))
    assert list(line)[-1] == "compared"
    assert all(set(v) == {"value", "limit"} for v in line["compared"].values())


class UnitsReader:
    """A per-layer metric of its own probe: install() counts the program's
    path_step calls; read() takes the median frame time and the peak that
    the harness puts into obs after the window."""

    def install(self, ctx):
        from paths_tpu_torch import integrator

        orig = integrator.path_step

        def call(*args, **kwargs):
            ctx.obs.count("own_probe")
            return orig(*args, **kwargs)

        integrator.path_step = call

        def undo():
            integrator.path_step = orig
        return [undo]

    def read(self, obs):
        units = sorted(obs.spans.get("unit", []))
        if not units or not obs.counts.get("own_probe"):
            return None
        assert "memory_peak_bytes" in obs.values
        return 1e3 * units[len(units) // 2]


def test_metric_file_sets_its_own_probe(mesh_dir, monkeypatch):
    from paths_tpu_torch import integrator

    orig = integrator.path_step
    load = harness.load_metric
    monkeypatch.setattr(harness, "load_metric",
                        lambda name: UnitsReader() if name == "frame_ms_median" else load(name))
    cfg, mix, limits = small_cell("stress500.render", mesh_dir)
    metric = {"name": "frame_ms_median", "unit": "ms", "source": "host_clock",
              "layer": "wavefront", "moves": "pixel_samples_per_s"}
    r = small.run(cfg, mix, limits, seconds=0.5, trace=True,
                  bench=small.bench_for("render", [metric]))
    assert r["metrics"]["frame_ms_median"]["value"] > 0
    assert integrator.path_step is orig


def test_flycam_script_outlasts_its_first_part(mesh_dir, monkeypatch):
    """A window that shows more frames than set-up made ready draws the
    rest of the script as it goes, and the check replays them all."""
    cfg, mix, limits = small_cell("stress500.interactive", mesh_dir)
    kind = harness.load_kind("interactive")
    monkeypatch.setattr(kind, "SCRIPT_FRAMES", 3)
    monkeypatch.setattr(harness, "load_kind", lambda name: kind)
    r = small.run(cfg, mix, limits, seconds=1.5)
    assert r["attempted"] > 3 and r["correct"], (r["attempted"], r["compared"])


def test_reference_rows_match_triangles_by_vertices():
    import numpy as np

    grad = harness.load_kind("grad")
    v = np.random.default_rng(5).random((50, 9)).astype(np.float32)
    perm = np.random.default_rng(6).permutation(50)
    rows = grad.reference_rows(v[perm], v)
    assert (v[perm][rows] == v).all()
    w = v.copy()
    w[7, 4] += 1e-3
    assert grad.reference_rows(v[perm], w) is None
