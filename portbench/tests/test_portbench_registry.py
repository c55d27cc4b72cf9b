"""The harness finds every configuration, mix, kind, metric and limit that
BENCHMARK.json names, by name, and the file keeps to the benchmark's
contract as far as a file can show it."""

import json
import os
import re

import pytest

from portbench import harness

ROOT = os.path.dirname(harness.BENCH_DIR)
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    data = harness.load_config(cfg["name"])
    assert data["source"].startswith("https://") and len(data["source"]) <= 200
    assert data["reduced"] == cfg["reduced"] == []
    assert "assumed" in data and "scene" in data
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    mix = harness.load_mix(cell["traffic"])
    kind = harness.load_kind(mix["kind"])
    for fn in ("setup", "window", "check", "control"):
        assert callable(getattr(kind, fn))
    limits = harness.load_limits(cell["name"])
    assert limits and all(v > 0 for v in limits.values())
    e2e = harness.cell_metrics(BENCH, cell["name"], "end_to_end")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell["name"], "per_layer")


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        for c in metric.get("workloads", cells):
            assert c in e2e[metric["moves"]].get("workloads", cells)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_and_silent_without_data(metric):
    reader = harness.load_metric(metric["name"])
    assert reader.read(harness.Obs()) is None


def test_layers_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert set(layers) == {"scene build", "wavefront", "shading step", "traversal kernels",
                           "gradients", "progressive", "device"}
