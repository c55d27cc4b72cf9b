"""The regenerating wavefront's lane counters on the CPU
(``render._all_done``): while recording, each iteration's sync counts the
wave's lanes and those not yet retired from the one reduction it waits on,
adds no sync of its own and changes no result."""

import copy
import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from paths_tpu_torch import camera as C
from paths_tpu_torch import integrator as I
from paths_tpu_torch import profiling as P
from paths_tpu_torch import render as R
from paths_tpu_torch.scene.build import build_scene
from paths_tpu_torch.scene.yaml_loader import load_scene_description, parse_scene_dict
from portbench import harness
from portbench.tests import small

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP, TILE = 16, 12, 2, 64
SYNC = "paths_tpu_torch.wavefront_sync"
LIVE, LANES = "wave_live_lane_iters", "wave_lane_iters"


def _room_spheres():
    """The dragon room (six radius-1e6 walls, the ceiling light, a black
    sky) with a metal gold Gloss sphere in the mesh's place: no path
    escapes."""
    cfg = copy.deepcopy(harness.load_config("dragon"))
    scene = cfg["scene"]
    scene["models"] = {}
    scene["objects"][0]["shape"] = {"type": "Sphere", "radius": 1.5,
                                    "center": {"x": 0.0, "y": 0.0, "z": 0.0}}
    return build_scene(parse_scene_dict(scene), device="cpu")


def _config(cfg):
    return build_scene(parse_scene_dict(cfg["scene"], base_dir=cfg.get("base_dir", ".")),
                       device="cpu")


def _scene(name, tmp):
    if name == "room":
        return _room_spheres()
    if name == "stress500":
        return _config(small.small_stress())
    if name == "doom":
        return _config(small.small_mesh(tmp))
    static, scene, cam = build_scene(load_scene_description(
        os.path.join(REPO, "scenes", "env_demo.yml")), device="cpu")
    return dataclasses.replace(static, env_nee=True), scene, cam


@pytest.fixture(scope="module")
def scenes():
    with tempfile.TemporaryDirectory() as d:
        yield {n: _scene(n, d) for n in ("room", "stress500", "doom", "env_demo")}


def _render(built, seed=9):
    static, scene, cam = built
    return R.render_image(static, scene, C.resize(cam, W, H), W, H, spp=SPP, seed=seed,
                          tile_pixels=TILE)


def _sync_by_all(done) -> bool:
    """The sync as it was before the counters: ``bool(done.all())``."""
    with P.span(SYNC):
        return bool(done.all())


@pytest.mark.parametrize("name", ["room", "stress500", "doom", "env_demo"])
def test_image_unchanged_by_the_counting_sync(scenes, name, monkeypatch):
    """The render cells' scenes, cut small, and the room: the frame with
    the counting sync equals, bit for bit, the frame with the sync that
    only tested ``done.all()``, with the recorder off and on."""
    now = _render(scenes[name])
    with P.record():
        recorded = _render(scenes[name])
    monkeypatch.setattr(R, "_all_done", _sync_by_all)
    before = _render(scenes[name])
    assert np.isfinite(now).all() and now.mean() > 0
    np.testing.assert_array_equal(now, before)
    np.testing.assert_array_equal(recorded, before)


def _wave(built, seed=5, n=40):
    static, scene, cam = built
    pix = torch.arange(n, dtype=torch.int64)
    return (static, scene, cam, (pix % W).to(torch.int32), (pix // W).to(torch.int32), pix,
            0, 3, seed)


def test_render_samples_bit_for_bit_with_recording(scenes):
    args = _wave(scenes["room"])
    off = R.render_samples(*args)
    with P.record() as rec:
        on = R.render_samples(*args)
    assert rec.counts[LANES] > 0
    assert torch.equal(on, off)


@pytest.mark.parametrize("name", ["room", "stress500"])
def test_counts_equal_a_recount_of_done(scenes, name, monkeypatch):
    """The counts equal the lanes and live lanes of the carry's retired
    flags as each sync sees them, summed over the syncs that go on to
    iterate; the syncs stay one an iteration plus one a wave."""
    seen, steps = [], []
    orig_done, orig_step = R._all_done, I.path_step

    def done_seen(done):
        seen.append(done.clone())
        return orig_done(done)

    monkeypatch.setattr(R, "_all_done", done_seen)
    monkeypatch.setattr(I, "path_step", lambda *a: steps.append(1) or orig_step(*a))
    with P.record() as rec:
        _render(scenes[name])
    going_on = [d for d in seen if not bool(d.all())]
    assert len(going_on) == len(steps) > 0
    assert rec.counts[LANES] == sum(d.numel() for d in going_on)
    assert rec.counts[LIVE] == sum(int((~d).sum()) for d in going_on)
    assert 0 < rec.counts[LIVE] < rec.counts[LANES]
    waves = [s for s in rec.spans if s.name == "paths_tpu_torch.render_samples"]
    syncs = [s for s in rec.spans if s.name == SYNC]
    assert len(syncs) == len(steps) + len(waves) == len(seen)


def test_counts_off_without_a_record(scenes):
    assert P._record is None
    R.render_samples(*_wave(scenes["room"]))
    with P.record() as rec:
        pass
    assert rec.counts == {}


def test_live_share_reads_the_counts():
    reader = harness.load_metric("live_lane_pct.render")
    obs = harness.Obs()
    assert reader.read(obs) is None
    obs.program_counts = {LANES: 400, LIVE: 100}
    assert reader.read(obs) == 25.0

