"""The environment cell at a CPU test's size (the program's plain versions
of its kernels): the configuration with 2,000 triangles of its mesh and a
64x32 map, run whole and traced through the harness, and its readers."""

import copy
import os
import sys

import numpy as np
import pytest

from portbench import env_light as EL
from portbench import env_map, harness
from portbench.reference import scene as RS
from portbench.tests import small

ROOT = os.path.dirname(harness.BENCH_DIR)
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELL = "environment.render"


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    sys.path.insert(0, os.path.join(ROOT, "scenes"))
    import make_assets as MA
    from paths_tpu_torch.scene.hdr_loader import write_hdr_rle

    tmp = str(tmp_path_factory.mktemp("env_cell"))
    v, f, _ = RS.read_ply(os.path.join(harness.BENCH_DIR, "configs", "environment",
                                       "dragon_standin.ply"))
    used, inv = np.unique(f[np.r_[0:1000, 100000:101000]], return_inverse=True)
    MA.write_ply_binary(os.path.join(tmp, "rings.ply"), v[used], inv.reshape(-1, 3))
    write_hdr_rle(os.path.join(tmp, "sun.hdr"), env_map.sunrise(32, 64))
    cfg = copy.deepcopy(harness.load_config("environment"))
    cfg["scene"]["models"] = {"dragon": {"file": "rings.ply"}}
    cfg["scene"]["skybox"] = {"type": "Hdri", "filename": "sun.hdr"}
    cfg["scene"]["camera"].update(image_width=24, image_height=16)
    cfg["base_dir"] = tmp
    return cfg


def _mix():
    return dict(harness.load_mix("render2_env"), tile_pixels=256)


def _bench(per_layer=()):
    return {"workloads": [], "per_layer": list(per_layer),
            "end_to_end": [{"name": "pixel_samples_per_s", "unit": "pixel-samples/s"},
                           {"name": "setup_s", "unit": "s"}]}


def test_small_environment_cell_is_correct(config):
    r = small.run(config, _mix(), harness.load_limits(CELL), seconds=0.6, bench=_bench(),
                  name=CELL)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["metrics"]["pixel_samples_per_s"]["value"] > 0


def test_small_environment_cell_traced(config):
    """On the CPU the device-trace metrics stay silent; the host's spans
    are read after the profiled part (0.3 s here)."""
    per_layer = harness.cell_metrics(BENCH, CELL, "per_layer")
    r = small.run(config, _mix(), harness.load_limits(CELL), seconds=2.0, trace=True,
                  bench=_bench(per_layer), name=CELL)
    assert r["correct"]
    got = set(r["metrics"])
    host = {m["name"] for m in per_layer if m["source"] != "device_trace"}
    assert "env_host_ms_per_iter.render" in host and host <= got
    assert r["metrics"]["env_host_ms_per_iter.render"]["value"] > 0


def test_env_host_metric_reads_zero_without_an_hdri(monkeypatch):
    """The host metric reads 0 where the run's scene runs no environment
    NEE, and None where it does but the program made no env_nee span (a
    program without the span)."""
    from portbench import spans

    reader = harness.load_metric("env_host_ms_per_iter.render")
    monkeypatch.setattr(spans, "after_profile",
                        lambda obs, name: [object()] if name.endswith("path_step") else [])
    obs = harness.Obs()
    obs.values[EL.ACTIVE] = False
    assert reader.read(obs) == 0.0
    obs.values[EL.ACTIVE] = True
    assert reader.read(obs) is None


def test_setup_refuses_a_program_without_centre_low_parts(config, monkeypatch):
    """A program that keeps sphere centres in float32 alone puts the ground
    1.25 cm low: the set-up refuses it before the window."""
    import torch

    kind = harness.load_kind("render_env")
    monkeypatch.setattr(harness.Ctx, "port_scene", lambda self: (None, object(), None))
    ctx = harness.Ctx(device=torch.device("cpu"), config_name="environment", config=config,
                      mix=_mix(), seed=1)
    with pytest.raises(RuntimeError, match="float32 only"):
        kind.setup(ctx)
