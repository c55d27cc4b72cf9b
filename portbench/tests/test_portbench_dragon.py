"""The dragon room's cell at a CPU test's size (the program's plain versions
of its kernels): the configuration's six radius-1e6 walls, its ceiling light
and its metal gold Gloss on ``small.write_grid_ply``'s 128-triangle grid
(more than 64 triangles: the kernel route) in place of the 200,000-triangle
mesh, at 48x32 with ``render4``'s mix at 512-lane tiles, run whole and
traced through the harness against the reference; the bfloat16 control and
the faults of ``test_portbench_faults.py``; the configuration against
the repo's scene file and its mesh; and the device rows that
``ds_device_pct.render`` reads."""

import copy
import hashlib
import os
import re
import tempfile

import pytest
import torch

from paths_tpu_torch.scene.yaml_loader import parse_yaml
from portbench import harness
from portbench.tests import small
from portbench.tests.test_portbench_faults import _half_samples, _patch_wave, _shifted, \
    unchanged_step

ROOT = os.path.dirname(harness.BENCH_DIR)
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELL = "dragon.render"
SEED = 2**35 + 23


@pytest.fixture(scope="module")
def room():
    """The configuration with the grid, 8 units across and 1.2 high, lying
    inside the room's walls in the mesh's place, and a 48x32 camera."""
    with tempfile.TemporaryDirectory() as d:
        small.write_grid_ply(os.path.join(d, "grid.ply"))
        cfg = copy.deepcopy(harness.load_config("dragon"))
        cfg["scene"]["models"] = {"dragon": {"file": "grid.ply"}}
        mesh = cfg["scene"]["objects"][0]["shape"]
        mesh.update(translation={"x": 0.0, "y": -1.0, "z": 0.0},
                    rotation={"pitch": 0.0, "yaw": 0.0, "roll": 0.0}, scale=0.02)
        cfg["scene"]["camera"].update(image_width=48, image_height=32)
        cfg["base_dir"] = d
        yield cfg


def _mix():
    return dict(harness.load_mix("render4"), tile_pixels=512)


def test_small_room_is_correct(room):
    r = small.run(room, _mix(), harness.load_limits(CELL), seed=SEED, seconds=0.6, name=CELL)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["metrics"]["pixel_samples_per_s"]["value"] > 0


def test_small_room_traced(room):
    """The cell's per-layer metrics that the host reads are read; the
    wavefront's live share lies in (0, 100]."""
    per_layer = harness.cell_metrics(BENCH, CELL, "per_layer")
    r = small.run(room, _mix(), harness.load_limits(CELL), seed=SEED + 1, seconds=1.0,
                  trace=True, bench=small.bench_for("render", per_layer), name=CELL)
    assert r["correct"], r["compared"]
    got = set(r["metrics"])
    host = {m["name"] for m in per_layer if m["source"] != "device_trace"}
    assert "live_lane_pct.render" in host and host <= got
    assert 0.0 < r["metrics"]["live_lane_pct.render"]["value"] <= 100.0


def test_small_room_control_fails(room):
    ctx = harness.Ctx(device=torch.device("cpu"), config_name="dragon", config=room,
                      mix=_mix(), seed=SEED + 2)
    got = harness.load_kind("render").control(ctx, "bf16")
    limits = harness.load_limits(CELL)
    assert any(not (v <= limits[k]) for k, v in got.items()), got


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_small_room_fault_is_caught(room, fault, monkeypatch):
    if fault == "state_unchanged":
        monkeypatch.setattr("paths_tpu_torch.integrator.path_step", unchanged_step)
    else:
        _patch_wave(monkeypatch, "paths_tpu_torch.render",
                    _half_samples if fault == "half_batch" else _shifted)
    r = small.run(room, _mix(), harness.load_limits(CELL), seed=SEED + 3, seconds=0.6,
                  name=CELL)
    assert not r["correct"], r["compared"]


def test_config_is_the_repo_scene_but_for_the_mesh_file():
    with open(os.path.join(ROOT, "scenes", "dragon_standin.yml")) as f:
        want = parse_yaml(f.read())
    want["models"]["dragon"]["file"] = "environment/dragon_standin.ply"
    cfg = harness.load_config("dragon")
    assert cfg["scene"] == want
    assert cfg["reduced"] == [] and cfg["source"].endswith("/scenes/dragon.yml")


def test_mesh_is_the_frozen_stand_in():
    cfg = harness.load_config("dragon")
    path = os.path.join(harness.BENCH_DIR, "configs", cfg["scene"]["models"]["dragon"]["file"])
    with open(path, "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == cfg["assumed"]["mesh_sha256"]
    assert b"element vertex 100000\n" in data and b"element face 200000\n" in data


def test_ds_prefix_names_sphere_ds_kernels_only():
    """``ds_device_pct.render`` takes the device rows whose names hold its
    prefix: every kernel of ``sphere_ds.cu`` has it, and no other CUDA
    source of the port holds it."""
    prefix = harness.load_metric("ds_device_pct.render").PREFIX
    csrc = os.path.join(ROOT, "paths_tpu_torch", "csrc")
    for f in sorted(os.listdir(csrc)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, f)) as fh:
                text = fh.read()
            if f == "sphere_ds.cu":
                kernels = re.findall(r"__global__\s+void\s+(\w+)", text)
                assert len(kernels) == 3 and all(k.startswith(prefix) for k in kernels)
            else:
                assert prefix not in text, f


def test_ds_share_of_device_rows():
    """The share sums the matched rows' device time over every device
    event's in the profiled span; None where no double-single kernel ran."""
    from portbench import devtrace
    from portbench import spans as S

    reader = harness.load_metric("ds_device_pct.render")
    ev = lambda name, s, e: devtrace.Ev(name, s, e, 0, 0, 0)
    t = S.Trace(0, 1000, device=[
        ev("(anonymous namespace)::sphere_ds_closest_kernel(float const*)", 10, 40),
        ev("_ZN12_GLOBAL__N_124sphere_ds_any_hit_kernelEPKf", 50, 60),
        ev("void (anonymous namespace)::tri_traverse<false>(float const*)", 100, 160),
        ev("(anonymous namespace)::sphere_ds_intersect_kernel(float const*)", 2000, 2100)])
    obs = harness.Obs()
    assert reader.read(obs) is None
    obs.program = S.Program(trace=t)
    assert reader.read(obs) == pytest.approx(100.0 * 40 / 100)
    t.device = t.device[2:3]
    assert reader.read(obs) is None
