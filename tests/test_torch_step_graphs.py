"""The shading step's eager stretches as CUDA graphs
(``paths_tpu_torch/step_graphs.py``).

On the CPU: the restructured ``integrator.path_step`` and
``render.render_samples``, their stretches run eagerly, bit for bit the
frozen copy of the code before the change (``frozen_path_step.py``) on a
sphere scene, a mesh with a light, an HDRI sky with environment NEE and the
BVH route; CPU inputs and inputs that require grad never reach the graph
cache; the benchmark's ``graph_replay_pct.render`` reads the program's
counts.  On the card (marker ``cuda``; this file imports no JAX):

    python -m pytest tests/test_torch_step_graphs.py -m cuda --noconftest -o addopts=""

the graphed render bit for bit the frozen eager one across seeds, sample
starts, a camera set between calls and both of the progressive renderer's
lane sets, within one cache entry, and the lane RNG's device-word seed
against the plain hash and CMJ.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import frozen_path_step as FROZEN
from paths_tpu_torch import camera as C
from paths_tpu_torch import grad as G
from paths_tpu_torch import integrator as I
from paths_tpu_torch import profiling as P
from paths_tpu_torch import render as R
from paths_tpu_torch import step_graphs as SG
from paths_tpu_torch.progressive import ProgressiveRenderer
from paths_tpu_torch.sampling import hashing as H
from paths_tpu_torch.scene import desc as D
from paths_tpu_torch.scene.build import build_scene
from paths_tpu_torch.scene.stress import generate_mixed_scene, generate_stress_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUNRISE = os.path.join(REPO, "scenes", "assets", "sunrise.hdr")
W, HT = 16, 12
SEED = 7300000001
COUNTS = ("step_graph_replays", "step_graph_captures", "step_graph_eager")


def make_scene(kind, asset_dir, device):
    """(static, scene, camera at W x HT) of one of the four test scenes."""
    if kind == "spheres":
        static, scene, cam = build_scene(generate_stress_scene(40, seed=2), device=device)
        assert static.sph_chunks > 0 and static.n_lights == 0
    elif kind == "mesh_light":
        static, scene, cam = build_scene(generate_mixed_scene(asset_dir, n_spheres=40),
                                         device=device)
        assert static.tri_chunks > 0 and static.sph_chunks > 0 and static.n_lights > 0
    elif kind == "hdri":
        sd = generate_mixed_scene(asset_dir, n_spheres=40)
        sd.skybox = D.SkyboxD(kind="hdri", filename=SUNRISE)
        static, scene, cam = build_scene(sd, device=device)
        static = dataclasses.replace(static, env_nee=True)
    else:
        static, scene, cam = build_scene(generate_mixed_scene(asset_dir, n_spheres=3),
                                         device=device, bvh_threshold=64)
        assert static.use_bvh
    return static, scene, C.resize(cam, W, HT)


def lanes(device, width=W, height=HT):
    pix = torch.as_tensor(R.tiled_pixel_order(width, height).astype(np.int64), device=device)
    return (pix % width).to(torch.int32), (pix // width).to(torch.int32), pix


def same(a, b) -> bool:
    """Bit for bit, NaNs included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


SCENES = ["spheres", "mesh_light", "hdri", "bvh"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    asset_dir = str(tmp_path_factory.mktemp("step_graphs"))
    return {k: make_scene(k, asset_dir, "cpu") for k in SCENES}


@pytest.mark.parametrize("kind", SCENES)
@pytest.mark.parametrize("bounce_kind", ["lanes", "integer"])
def test_path_step_equals_frozen_copy(scenes, kind, bounce_kind):
    """Four bounces from the camera's rays: every state tensor bit for bit
    the frozen path_step's."""
    static, scene, cam = scenes[kind]
    px, py, pix = lanes("cpu")
    sid = (torch.arange(pix.shape[0]) % 3 + 5).to(torch.int64)
    o, d, _ = R.gen_camera_rays(cam, px, py, pix, sid, SEED)
    got = want = I.fresh_path_state(o, d)
    hits = 0
    for b in range(4):
        bounce = torch.full_like(pix, b) if bounce_kind == "lanes" else b
        got = I.path_step(static, scene, bounce, got, I.lane_uniforms(SEED, pix, sid))
        want = FROZEN.path_step(static, scene, bounce, want,
                                FROZEN.lane_uniforms(SEED, pix, sid))
        for name, g, w in zip(("o", "d", "throughput", "colour", "alive", "last_spec",
                               "excl_kind", "excl_idx"), got, want):
            assert same(g, w), f"{kind}, bounce {b}: {name} differs"
        hits += int(got[4].sum())
    assert hits > 0 and float(got[3].max()) > 0


@pytest.mark.parametrize("kind", SCENES)
def test_render_samples_equals_frozen_copy(scenes, kind):
    """The regenerating wavefront, its start and bank now stretches, bit for
    bit the frozen one; at another seed and sample start, it differs."""
    static, scene, cam = scenes[kind]
    px, py, pix = lanes("cpu")
    got = R.render_samples(static, scene, cam, px, py, pix, 3, 2, SEED)
    want = FROZEN.render_samples(static, scene, cam, px, py, pix, 3, 2, SEED)
    assert same(got, want) and float(got.max()) > 0
    other = R.render_samples(static, scene, cam, px, py, pix, 5, 2, SEED + 1)
    assert not same(other, got)


def test_cpu_and_grad_inputs_never_reach_the_cache(scenes):
    """On the CPU and under autograd every stretch runs eagerly: only
    step_graph_eager counts and the cache stays empty."""
    static, scene, cam = scenes["mesh_light"]
    px, py, pix = lanes("cpu")
    SG.clear()
    with P.record() as rec:
        R.render_samples(static, scene, cam, px, py, pix, 0, 1, SEED)
        eager_render = rec.counts.get("step_graph_eager", 0)
        loss, grads = G.loss_and_grad(static, scene, cam, px, py, pix, torch.zeros_like(pix),
                                      SEED, torch.full((pix.shape[0], 3), 0.25))
    assert eager_render > 0 and rec.counts["step_graph_eager"] > eager_render
    assert set(rec.counts) == {"step_graph_eager"}
    assert SG.entries() == 0
    assert any(float(g.abs().sum()) > 0 for g in G.flatten_params(grads))


def test_graph_inputs_are_decided_from_the_inputs_alone():
    """A Python number among the inputs, a CPU tensor or one that requires
    grad runs eagerly; an eager run makes each request in order."""
    calls = []

    class Mod:
        @staticmethod
        def twice(x):
            calls.append("twice")
            return 2 * x

    def fn(scale, x):
        y = yield SG.Call(Mod, "twice", x * scale)
        yield SG.Enter("paths_tpu_torch.test_span")
        z = yield SG.Call(Mod, "twice", y + 1)
        yield SG.EXIT
        return z, y

    x = torch.arange(4.0)
    SG.clear()
    with P.record() as rec:
        z, y = SG.run(fn, (3,), (x,))
        SG.run(fn, (3,), (x.requires_grad_(),))
        SG.run(SG.single(lambda a, b: a + b), (), (x, 2))
    assert torch.equal(z.detach(), 2 * (2 * x.detach() * 3 + 1)) and calls == ["twice"] * 4
    assert rec.counts == {"step_graph_eager": 5 + 5 + 1}  # stretches: requests + 1
    assert [s.name for s in rec.spans] == ["paths_tpu_torch.test_span"] * 2
    assert SG.entries() == 0


def test_launch_log_holds_what_a_capture_launches():
    """profiling.launched counts a launch; inside launch_log() it also logs
    it, so that a graph's replays can count it again; nested logs restore
    the outer one."""
    counts = {"k": 0, "j": 0}
    P.launched(counts, "k")
    with P.launch_log() as outer:
        P.launched(counts, "k")
        with P.launch_log() as inner:
            P.launched(counts, "j")
        P.launched(counts, "j")
    P.launched(counts, "k")
    assert counts == {"k": 3, "j": 2}
    assert inner == [(counts, "j")] and outer == [(counts, "k"), (counts, "j")]


def _metric():
    path = os.path.join(REPO, "portbench", "metrics", "graph_replay_pct.render.py")
    spec = importlib.util.spec_from_file_location("graph_replay_pct_render", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("counts,want", [
    ({"step_graph_replays": 297, "step_graph_captures": 3}, 99.0),
    ({"step_graph_replays": 0, "step_graph_eager": 40}, 0.0),
    ({"step_graph_replays": 10, "step_graph_captures": 5, "step_graph_eager": 5}, 50.0),
    ({"sent_lane_samples": 12}, None),
    ({}, None),
    (None, None),
])
def test_graph_replay_pct_reads_the_programs_counts(counts, want):
    from portbench.harness import Obs

    obs = Obs()
    if counts is not None:
        obs.program_counts = counts
    got = _metric().read(obs)
    assert got == pytest.approx(want) if want is not None else got is None


def test_graph_replay_pct_installs_on_the_programs_recorder():
    """install() starts the program's recorder (through spans.py) and reads
    its live counts; the undo functions stop it."""
    from portbench.harness import Ctx

    ctx = Ctx(device=torch.device("cpu"), config_name="x", config={}, mix={}, seed=0)
    undo = _metric().install(ctx)
    try:
        P.count("step_graph_replays", 9)
        P.count("step_graph_eager", 1)
    finally:
        for u in reversed(undo):
            u()
    assert _metric().read(ctx.obs) == pytest.approx(90.0)


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frozen(static, scene, cam, lanes_, start, n, seed):
    return FROZEN.render_samples(static, scene, cam, *lanes_, start, n, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["spheres", "mesh_light", "hdri"])
def test_graphed_render_equals_the_eager_one(dev, tmp_path, kind):
    """Within one cache entry: two seeds, two sample starts and a camera
    replaced between calls, each render bit for bit the frozen eager
    wavefront's on the same card; the first call captures, the rest
    replay."""
    static, scene, cam = make_scene(kind, str(tmp_path), dev)
    lanes_ = lanes(dev)
    SG.clear()
    moved = cam._replace(location=cam.location + torch.tensor([0.3, -0.1, 0.2], device=dev))
    cases = [(cam, 0, 2, SEED), (cam, 0, 2, SEED + 1), (cam, 9, 2, SEED + 1),
             (moved, 9, 2, SEED), (cam, 16, 3, 5)]
    with P.record() as rec:
        for i, (c, start, n, seed) in enumerate(cases):
            got = R.render_samples(static, scene, c, *lanes_, start, n, seed)
            if i == 0:
                entries, captures = SG.entries(), rec.counts["step_graph_captures"]
            want = _frozen(static, scene, c, lanes_, start, n, seed)
            assert same(got, want), f"{kind}: case {i} differs from the eager render"
            assert float(got.max()) > 0
    assert SG.entries() == entries == 3  # the start, the step, the bank
    assert rec.counts["step_graph_captures"] == captures
    # Every later call replays its start and at least one iteration.
    assert rec.counts["step_graph_replays"] >= (len(cases) - 1) * captures
    assert "step_graph_eager" not in rec.counts


@pytest.mark.cuda
def test_graphed_progressive_equals_the_eager_one(dev, tmp_path, monkeypatch):
    """The progressive renderer's preview and full lane sets, a camera set
    between pumps: the same estimator as with every stretch eager."""
    static, scene, cam = make_scene("mesh_light", str(tmp_path), dev)
    cam = C.resize(cam, 36, 24)

    def run():
        pr = ProgressiveRenderer(static, scene, cam, 36, 24, seed=SEED)
        for i in range(6):
            if i == 3:
                pr.set_camera(cam.location.cpu().numpy() + [0.2, 0.0, -0.1],
                              cam.rot.cpu().numpy())
            pr.pump()
        return pr.frame(), pr.estimator.count.copy()

    SG.clear()
    with P.record() as rec:
        graphed, counts = run()
    assert SG.entries() == 6  # two lane sets
    assert rec.counts["step_graph_replays"] > rec.counts["step_graph_captures"]
    monkeypatch.setattr(SG, "run", lambda fn, consts, inputs, into=None:
                        SG.eager(fn(*consts, *inputs)))
    eager, counts_e = run()
    np.testing.assert_array_equal(counts, counts_e)
    assert graphed.tobytes() == eager.tobytes() and graphed.max() > 0


@pytest.mark.cuda
def test_grad_on_the_card_runs_eagerly(dev, tmp_path):
    static, scene, cam = make_scene("mesh_light", str(tmp_path), dev)
    px, py, pix = lanes(dev)
    SG.clear()
    with P.record() as rec:
        G.loss_and_grad(static, scene, cam, px, py, pix, torch.zeros_like(pix), SEED,
                        torch.full((pix.shape[0], 3), 0.25, device=dev))
    assert set(rec.counts) == {"step_graph_eager"} and SG.entries() == 0


@pytest.mark.cuda
def test_lane_rng_device_seed_matches_plain(dev):
    """Both kernels with the seed read from a device word, bit for bit the
    plain hash and CMJ, and the by-value launch."""
    from paths_tpu_torch.ops import lane_rng as RNG

    n = 65_536
    g = np.random.default_rng(3)
    pix = torch.as_tensor(g.integers(0, 2**32, n), device=dev)
    sid = torch.as_tensor(g.integers(0, 2**32, n), device=dev)
    bounce = torch.as_tensor(g.integers(0, 12, n), device=dev)
    args = (R.PAT_M, R.PAT_N, R._SQUARE_TAG, R._DISK_TAG)
    for seed in (0, 2**31, 2**32 - 1, SEED):
        word = torch.full((), seed & H.MASK32, dtype=torch.int64, device=dev)
        for b in (bounce, 7):
            for dim in (0, 6, 9):
                got = RNG.shading_uniform(word, pix, sid, b, dim)
                assert same(got, RNG.shading_uniform(seed, pix, sid, b, dim))
                assert same(got.cpu(), RNG.shading_uniform_plain(
                    seed, pix.cpu(), sid.cpu(), b.cpu() if torch.is_tensor(b) else b, dim))
        got = RNG.camera_cmj(word, pix, sid, *args)
        want = RNG.camera_cmj_plain(seed, pix.cpu(), sid.cpu(), *args)
        for gx, wx in zip((*got[0], *got[1]), (*want[0], *want[1])):
            assert same(gx.cpu(), wx)
    with pytest.raises(TypeError):
        RNG.shading_uniform(word.to(torch.int32), pix, sid, 0, 0)
    with pytest.raises(ValueError):
        RNG.shading_uniform(word.cpu(), pix, sid, 0, 0)
    with pytest.raises(ValueError):
        RNG.camera_cmj(torch.zeros(2, dtype=torch.int64, device=dev), pix, sid, *args)


@pytest.mark.cuda
def test_graphed_render_follows_a_scene_swapped_under_the_same_static(dev, tmp_path):
    """Two scenes under one static (the parameters substituted, as
    grad.with_params does), rendered in turns: each render bit for bit the
    frozen eager one of its own scene, never the graphs of the other."""
    static, scene, cam = make_scene("mesh_light", str(tmp_path), dev)
    other = scene._replace(mat_albedo=scene.mat_albedo.flip(0) * 0.5 + 0.25,
                           tri_vc0=scene.tri_vc0 * 0.5)
    lanes_ = lanes(dev)
    SG.clear()
    renders = []
    for i, (sc, seed) in enumerate([(scene, SEED), (other, SEED), (scene, SEED),
                                    (other, SEED + 1), (scene, SEED + 1)]):
        got = R.render_samples(static, sc, cam, *lanes_, 0, 2, seed)
        want = _frozen(static, sc, cam, lanes_, 0, 2, seed)
        assert same(got, want), f"render {i} differs from its scene's eager render"
        renders.append(got)
    assert not same(renders[0], renders[1])


@pytest.mark.cuda
def test_graphed_render_after_eviction(dev, tmp_path):
    """More keys than the cache holds (lane counts of their own), then the
    first again: every render bit for bit the frozen eager one, and the
    cache no larger than MAX_ENTRIES."""
    static, scene, cam = make_scene("spheres", str(tmp_path), dev)
    px, py, pix = lanes(dev)
    sizes = [W * HT - 8 * k for k in range(SG.MAX_ENTRIES // 3 + 2)]
    SG.clear()
    for i, n in enumerate(sizes + sizes[:2]):
        sub = (px[:n], py[:n], pix[:n])
        got = R.render_samples(static, scene, cam, *sub, 3, 2, SEED + i)
        want = _frozen(static, scene, cam, sub, 3, 2, SEED + i)
        assert same(got, want), f"render {i} ({n} lanes) differs from the eager one"
        assert SG.entries() <= SG.MAX_ENTRIES
    assert len(sizes) * 3 > SG.MAX_ENTRIES


@pytest.mark.cuda
def test_lane_rng_launches_count_kernels_run_under_replay(dev, tmp_path, monkeypatch):
    """A render whose stretches all replay counts the lane RNG's launches
    the eager render makes: the replays add what the captures launched."""
    from paths_tpu_torch.ops import lane_rng as RNG

    static, scene, cam = make_scene("spheres", str(tmp_path), dev)
    lanes_ = lanes(dev)
    SG.clear()
    R.render_samples(static, scene, cam, *lanes_, 0, 2, SEED)  # captures
    RNG.reset_launch_counts()
    with P.record() as rec:
        graphed = R.render_samples(static, scene, cam, *lanes_, 0, 2, SEED + 1)
    replayed = dict(RNG.LAUNCHES)
    assert set(rec.counts) == {"step_graph_replays"}
    monkeypatch.setattr(SG, "run", lambda fn, consts, inputs, into=None:
                        SG.eager(fn(*consts, *inputs)))
    RNG.reset_launch_counts()
    eager = R.render_samples(static, scene, cam, *lanes_, 0, 2, SEED + 1)
    assert replayed == RNG.LAUNCHES and min(replayed.values()) > 0
    assert same(graphed, eager)
