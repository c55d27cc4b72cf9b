"""Port parity for the slices as a whole: scene build, one path_step, whole
renders (paths_tpu_torch on the CPU, with the plain versions of the sphere
and triangle kernels, vs paths_tpu).

The reference renders the lit stress scene and the mixed sphere + mesh scene
with PATHS_TPU_FORCE_PALLAS=1, so its traversal runs through the Pallas
sorted-walk kernels in interpret mode (as tests/test_force_pallas.py does);
the unforced CPU path would unroll 41 spheres and take XLA many minutes to
compile.  The flat-sphere route (PATHS_TPU_SPH_FLAT=1, K5) is held the same
way on the mixed scene, and its build choice against the reference's.
Images are held to relative MSE < 1e-4 (the measure of
tests/test_golden.py): the two packages differ
only by float rounding (XLA contracts multiply-adds, transcendentals differ
by an ulp), which moves a rare path decision and nothing else.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paths_tpu import integrator as JI
from paths_tpu import render as JR
from paths_tpu.scene import desc as JD
from paths_tpu.scene.build import build_scene as jax_build
from paths_tpu.scene.stress import generate_mixed_scene as jax_mixed
from paths_tpu.scene.stress import generate_stress_scene as jax_stress

from paths_tpu_torch import camera as TC
from paths_tpu_torch import integrator as TI
from paths_tpu_torch import render as TR
from paths_tpu_torch.ops import chunk_scan as TCS
from paths_tpu_torch.ops import sphere_traverse as TST
from paths_tpu_torch.sampling import hashing as TH
from paths_tpu_torch.scene import desc as TD
from paths_tpu_torch.scene import build as TB
from paths_tpu_torch.scene.stress import (
    STRESS_LIGHT,
    generate_lit_stress_scene,
    generate_mixed_scene,
    generate_stress_scene,
)
from paths_tpu_torch.scene.types import SceneArrays, scene_from_numpy
from paths_tpu_torch.scene.yaml_loader import load_scene_description

torch.set_num_threads(2)

N_SPHERES = 40
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel_mse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / (np.mean(want ** 2) + 1e-12))


def _jax_lit_stress():
    sd = jax_stress(N_SPHERES, seed=0)
    sd.lights.append(JD.LightD(
        kind="sphere", position=JD.Vec3D(*STRESS_LIGHT["position"]),
        radius=STRESS_LIGHT["radius"], intensity=STRESS_LIGHT["intensity"]))
    return sd


def _as_numpy(jscene):
    """The reference scene's arrays as numpy, keyed for scene_from_numpy."""
    out = {}
    for name in SceneArrays._fields:
        if name == "sky":
            for f in jscene.sky._fields:  # the colours, image and tables
                out[f"sky.{f}"] = np.asarray(getattr(jscene.sky, f))
        elif name == "psph":
            if jscene.psph is not None:
                out["psph.tris"] = np.asarray(jscene.psph.tris)
                out["psph.chunk_meta"] = np.asarray(jscene.psph.chunk_meta)
        elif name == "ptris":
            if jscene.ptris is not None:
                for f in ("tris", "chunk_meta", "tri_ent"):
                    out[f"ptris.{f}"] = np.asarray(getattr(jscene.ptris, f))
        elif name == "pbvh":  # packed by scene_from_numpy from the BVH arrays
            if jscene.bvh is not None:
                for f in jscene.bvh._fields:
                    out[f"bvh.{f}"] = np.asarray(getattr(jscene.bvh, f))
        elif name == "sph_center_lo":  # the port's own; scene_from_numpy makes it 0
            continue
        else:
            out[name] = np.asarray(getattr(jscene, name))
    return out


@pytest.fixture(scope="module")
def lit_stress():
    """(reference static, scene, camera) built with the Pallas path forced,
    and the same scene built by the port."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PATHS_TPU_FORCE_PALLAS", "1")
    try:
        jstatic, jscene, jcam = jax_build(_jax_lit_stress())
    finally:
        mp.undo()
    assert jstatic.pallas_sph_chunks > 0 and jstatic.pallas_interpret
    port = TB.build_scene(generate_lit_stress_scene(N_SPHERES, seed=0),
                          device="cpu")
    return (jstatic, jscene, jcam), port


def test_build_scene_matches_reference(lit_stress):
    (jstatic, jscene, jcam), (static, scene, cam) = lit_stress
    assert static.sph_chunks == jstatic.pallas_sph_chunks
    assert static.n_sph_big == jstatic.n_sph_big
    for f in ("n_spheres", "n_lights", "n_entities", "sky_type", "has_fresnel"):
        assert getattr(static, f) == getattr(jstatic, f), f
    # The stress scene's centres are float32 numbers: no low parts.
    assert not static.sph_lo and not scene.sph_center_lo.any()
    want = _as_numpy(jscene)
    got = scene._asdict()
    for name, arr in want.items():
        if name.startswith("sky."):
            g = getattr(scene.sky, name[4:])
        elif name.startswith("psph."):
            g = getattr(scene.psph, name[5:])
        elif name.startswith("ptris."):
            g = getattr(scene.ptris, name[6:])
        else:
            g = got[name]
        np.testing.assert_array_equal(g.numpy(), arr.astype(g.numpy().dtype),
                                      err_msg=name)
    for f in TC.Camera._fields:
        np.testing.assert_array_equal(getattr(cam, f).numpy(),
                                      np.asarray(getattr(jcam, f)), err_msg=f)


def _lanes(W, H):
    pix = np.arange(W * H, dtype=np.uint32)
    return (pix % W).astype(np.int32), (pix // W).astype(np.int32), pix


def _hdri_lit_stress(sd, skybox):
    """Configuration (b): the lit stress scene under the bundled sunrise HDRI
    (``skybox``: either package's SkyboxD class)."""
    sd.skybox = skybox(kind="hdri",
                       filename=os.path.join(REPO, "scenes", "assets", "sunrise.hdr"))
    return sd


@pytest.fixture(scope="module")
def hdri_lit_stress():
    """Configuration (b) at the test size: the reference's build with the
    Pallas path forced and env_nee on."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PATHS_TPU_FORCE_PALLAS", "1")
    try:
        jstatic, jscene, jcam = jax_build(_hdri_lit_stress(_jax_lit_stress(), JD.SkyboxD))
    finally:
        mp.undo()
    assert jstatic.pallas_sph_chunks > 0 and jstatic.sky_type == 2
    return dataclasses.replace(jstatic, env_nee=True), jscene, jcam


def test_build_scene_hdri_matches_reference(hdri_lit_stress):
    """The port's build of configuration (b) carries the reference's HDRI
    image and tables bit for bit."""
    jstatic, jscene, _ = hdri_lit_stress
    static, scene, _ = TB.build_scene(
        _hdri_lit_stress(generate_lit_stress_scene(N_SPHERES, seed=0), TD.SkyboxD),
        device="cpu")
    assert static.sky_type == jstatic.sky_type and not static.env_nee
    for f in jscene.sky._fields:
        np.testing.assert_array_equal(getattr(scene.sky, f).numpy(),
                                      np.asarray(getattr(jscene.sky, f)), err_msg=f)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The mixed sphere + mesh scene (40 spheres, a 128-triangle grid, a
    sphere light): the reference's forced-Pallas build, so every kernel K1-K4
    runs."""
    asset_dir = str(tmp_path_factory.mktemp("mixed"))
    mp = pytest.MonkeyPatch()
    mp.setenv("PATHS_TPU_FORCE_PALLAS", "1")
    try:
        jstatic, jscene, jcam = jax_build(jax_mixed(asset_dir, n_spheres=40))
    finally:
        mp.undo()
    assert jstatic.pallas_tri_chunks > 0 and jstatic.pallas_sph_chunks > 0
    return jstatic, jscene, jcam


def _path_step_parity(jstatic, jscene, jcam):
    """One bounce on identical state: primary rays of a 16x16 wave."""
    static, scene = scene_from_numpy(dataclasses.asdict(jstatic),
                                     _as_numpy(jscene), "cpu")
    W = H = 16
    px, py, pix = _lanes(W, H)
    sid = np.zeros(W * H, np.uint32)
    jcam16 = JR.C.resize(jcam, W, H)
    o, d, _ = JR.gen_camera_rays(jcam16, jnp.asarray(px), jnp.asarray(py),
                                 jnp.asarray(pix), jnp.asarray(sid), jnp.uint32(7))
    o, d = np.array(o), np.array(d)  # writable copies for torch

    def ju(bounce, dim):
        return JR.H.uniform(jnp.uint32(7), jnp.asarray(pix), jnp.asarray(sid),
                            jnp.uint32(bounce * 10 + dim))

    want = JI.path_step(jstatic, jscene, 0,
                        JI.fresh_path_state(jnp.asarray(o), jnp.asarray(d)), ju)
    tu = TI.lane_uniforms(7, TH.as_u32(pix), TH.as_u32(sid))
    got = TI.path_step(static, scene, 0,
                       TI.fresh_path_state(torch.from_numpy(o), torch.from_numpy(d)),
                       tu)
    names = ("o", "d", "throughput", "colour", "alive", "last_spec",
             "excl_kind", "excl_idx")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    assert got[4].numpy().sum() > 0 and got[3].numpy().max() > 0
    return static, scene, torch.from_numpy(o), torch.from_numpy(d)


def test_path_step_matches_reference(lit_stress):
    _path_step_parity(*lit_stress[0])


def test_path_step_env_nee_matches_reference(hdri_lit_stress, monkeypatch):
    """One bounce of configuration (b) with environment NEE: the miss rule
    and the second shadow query (t_max BIG, no entity excluded) through the
    any-hit walk's plain version, against the reference's interpret-mode
    kernels."""
    calls = []
    occludes = TST.occludes_spheres

    def spy(ps, nc, o, d, excl, excl_ent, t_max):
        calls.append((excl_ent.clone(), t_max.clone()))
        return occludes(ps, nc, o, d, excl, excl_ent, t_max)

    monkeypatch.setattr(TST, "occludes_spheres", spy)
    static = _path_step_parity(*hdri_lit_stress)[0]
    assert static.env_nee and static.sky_type == 2
    assert len(calls) == 2  # the light's NEE, then the environment's
    excl_ent, t_max = calls[1]
    assert bool((t_max == TI.BIG).all()) and bool((excl_ent == -1).all())


def test_path_step_mixed_matches_reference(mixed):
    static, scene, o, d = _path_step_parity(*mixed)
    none = torch.zeros(o.shape[0], dtype=torch.int32)
    kind = TI.intersect_brief(static, scene, o, d, none, none)[1]
    assert int((kind == TI.KIND_TRI).sum()) > 20  # the camera sees the mesh


def _render_wave_parity(jstatic, jscene, jcam, n_waves=2):
    """n_waves sample waves of 16x16 pixels, 3 bounces."""
    static, scene = scene_from_numpy(dataclasses.asdict(jstatic),
                                     _as_numpy(jscene), "cpu")
    static = dataclasses.replace(static, max_bounces=3)
    jstatic = dataclasses.replace(jstatic, max_bounces=3)
    W = H = 16
    px, py, pix = _lanes(W, H)
    jcam16 = JR.C.resize(jcam, W, H)
    cam = TC.resize(TC.Camera(*[torch.tensor(np.asarray(x)) for x in jcam]), W, H)
    want, got = [], []
    for s in range(n_waves):
        sid = np.full(W * H, s, np.uint32)
        want.append(np.asarray(JR.render_wave(
            jstatic, jscene, jcam16, jnp.asarray(px), jnp.asarray(py),
            jnp.asarray(pix), jnp.asarray(sid), 7)))
        got.append(TR.render_wave(
            static, scene, cam, torch.from_numpy(px), torch.from_numpy(py),
            TH.as_u32(pix), TH.as_u32(sid), 7).numpy())
    want, got = np.stack(want), np.stack(got)
    assert np.isfinite(got).all() and got.max() > 0
    assert _rel_mse(got, want) < 1e-4


def test_render_wave_lit_stress_matches_reference(lit_stress):
    _render_wave_parity(*lit_stress[0])


def test_render_wave_mixed_matches_reference(mixed):
    _render_wave_parity(*mixed)


# ---- the flat sphere route (K5): PATHS_TPU_SPH_FLAT=1 at build ----

@pytest.mark.parametrize("n_spheres,rows,flat", [(500, 32, True), (1100, 72, False)])
def test_flat_route_build_matches_reference(monkeypatch, n_spheres, rows, flat):
    """The flat kernel is chosen as the reference chooses it: a table of at
    most 64 rows (stress-500: 32) takes it, a larger one (72) keeps the
    walk."""
    monkeypatch.setenv("PATHS_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("PATHS_TPU_SPH_FLAT", "1")
    jstatic, jscene, _ = jax_build(jax_stress(n_spheres, seed=0))
    static, scene, _ = TB.build_scene(generate_stress_scene(n_spheres, seed=0),
                                      device="cpu")
    assert scene.psph.tris.shape[0] == np.asarray(jscene.psph.tris).shape[0] == rows
    assert static.sph_flat == jstatic.pallas_sph_flat == flat
    monkeypatch.delenv("PATHS_TPU_SPH_FLAT")
    assert not TB.build_scene(generate_stress_scene(n_spheres, seed=0),
                              device="cpu")[0].sph_flat


@pytest.fixture(scope="module")
def mixed_flat(tmp_path_factory):
    """The mixed scene built by the reference with the Pallas path forced
    and the flat sphere kernel chosen (PATHS_TPU_SPH_FLAT=1)."""
    asset_dir = str(tmp_path_factory.mktemp("mixed_flat"))
    mp = pytest.MonkeyPatch()
    mp.setenv("PATHS_TPU_FORCE_PALLAS", "1")
    mp.setenv("PATHS_TPU_SPH_FLAT", "1")
    try:
        jstatic, jscene, jcam = jax_build(jax_mixed(asset_dir, n_spheres=40))
    finally:
        mp.undo()
    assert jstatic.pallas_sph_flat and jstatic.pallas_tri_chunks > 0
    return jstatic, jscene, jcam


def _flat_route_only(monkeypatch):
    """Count the flat wrappers' calls by form; fail on any call of the
    walk's sphere wrappers."""
    calls = {"closest": 0, "any": 0}

    def spy(form, wrapper):
        def call(*args):
            calls[form] += 1
            return wrapper(*args)
        return call

    def walk(*args, **kw):
        raise AssertionError("the walk's sphere kernel was called on the flat route")

    monkeypatch.setattr(TCS, "flat_closest_hit", spy("closest", TCS.flat_closest_hit))
    monkeypatch.setattr(TCS, "flat_occludes", spy("any", TCS.flat_occludes))
    monkeypatch.setattr(TST, "closest_hit_spheres", walk)
    monkeypatch.setattr(TST, "occludes_spheres", walk)
    return calls


def test_path_step_mixed_flat_matches_reference(mixed_flat, monkeypatch):
    calls = _flat_route_only(monkeypatch)
    static = _path_step_parity(*mixed_flat)[0]
    assert static.sph_flat
    assert calls["closest"] > 0 and calls["any"] > 0


def test_render_wave_mixed_flat_matches_reference(mixed_flat, monkeypatch):
    """One wave: each eager wave of the reference re-lowers its interpret-mode
    flat kernel, and a second wave would run the same kernels as the first."""
    calls = _flat_route_only(monkeypatch)
    _render_wave_parity(*mixed_flat, n_waves=1)
    assert calls["closest"] > 0 and calls["any"] > 0


def test_render_samples_equals_sum_of_waves():
    """The regenerating wavefront == the sum of fixed-schedule waves (same
    paths and decisions; only the float addition order differs)."""
    static, scene, cam = TB.build_scene(generate_lit_stress_scene(N_SPHERES),
                                        device="cpu")
    static = dataclasses.replace(static, max_bounces=4)
    W, H = 24, 16
    cam = TC.resize(cam, W, H)
    px, py, pix = (torch.from_numpy(a) for a in _lanes(W, H))
    pix = TH.as_u32(pix)
    start, n_samples, seed = 1, 3, 5
    total = TR.render_samples(static, scene, cam, px, py, pix, start,
                              n_samples, seed)
    waves = sum(
        TR.render_wave(static, scene, cam, px, py, pix,
                       torch.full_like(pix, start + s), seed)
        for s in range(n_samples)
    )
    np.testing.assert_allclose(total.numpy(), waves.numpy(), rtol=1e-4, atol=1e-6)
    assert total.numpy().max() > 0


def test_ct_demo_golden():
    """scenes/ct_demo.yml at the golden settings (tests/make_goldens.py:
    72x48, 2 spp, max_bounces 4, seed 0) vs the committed reference golden:
    the radius-1e6 ground sphere's double-single path, CookTorrance, Fresnel
    and a sphere light."""
    want = np.load(os.path.join(REPO, "tests", "goldens", "ct_demo.npz"))["img"]
    sd = load_scene_description(os.path.join(REPO, "scenes", "ct_demo.yml"))
    static, scene, cam = TB.build_scene(sd, device="cpu")
    assert static.sph_chunks == 0 and static.has_fresnel
    static = dataclasses.replace(static, max_bounces=4)
    W, H = 72, 48
    cam = TC.resize(cam, W, H)
    got = TR.render_image(static, scene, cam, W, H, spp=2, seed=0)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_mse(got, want) < 1e-4


def test_env_demo_golden():
    """scenes/env_demo.yml at the golden settings (tests/make_goldens.py:
    72x48, 2 spp, max_bounces 4, seed 0) vs the committed reference golden:
    the HDRI sky read from scenes/assets/sunrise.hdr and looked up on every
    miss."""
    want = np.load(os.path.join(REPO, "tests", "goldens", "env_demo.npz"))["img"]
    sd = load_scene_description(os.path.join(REPO, "scenes", "env_demo.yml"))
    static, scene, cam = TB.build_scene(sd, device="cpu")
    assert static.sky_type == 2 and scene.sky.image.shape == (128, 256, 3)
    static = dataclasses.replace(static, max_bounces=4)
    W, H = 72, 48
    got = TR.render_image(static, scene, TC.resize(cam, W, H), W, H, spp=2, seed=0)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_mse(got, want) < 1e-4


def test_cli_env_nee_writes_png(tmp_path):
    """The CLI takes --env-nee: scenes/env_demo.yml on the CPU at 24x16,
    1 spp writes a PNG of a finite image, and environment NEE changes the
    image against the same render without it."""
    from paths_tpu_torch import cli

    scene = os.path.join(REPO, "scenes", "env_demo.yml")
    args = [scene, "--cpu", "--size", "24x16", "--spp", "1"]
    out = str(tmp_path / "env.png")
    img = cli.main(args + ["--env-nee", "-o", out])
    assert img.shape == (16, 24, 3) and np.isfinite(img).all() and img.max() > 0
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    plain = cli.main(args + ["-o", str(tmp_path / "plain.png")])
    assert not np.array_equal(img, plain)


def test_mixed_pallas_golden(tmp_path):
    """tests/goldens/mixed_pallas.npz (tests/make_goldens.py: the mixed
    scene with 40 spheres through the reference's kernels, 72x48, 2 spp,
    max_bounces 3, seed 0): all four kernels' plain versions."""
    want = np.load(os.path.join(REPO, "tests", "goldens", "mixed_pallas.npz"))["img"]
    static, scene, cam = TB.build_scene(
        generate_mixed_scene(str(tmp_path), n_spheres=40), device="cpu")
    assert static.tri_chunks > 0 and static.sph_chunks > 0
    static = dataclasses.replace(static, max_bounces=3)
    W, H = 72, 48
    got = TR.render_image(static, scene, TC.resize(cam, W, H), W, H, spp=2, seed=0)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_mse(got, want) < 1e-4


def test_build_rejects_meshes_and_requires_a_device(tmp_path):
    """Meshes build (since slice 2: the mixed scene's grid takes the
    triangle kernels); without a CUDA device the default device raises."""
    static, scene, _ = TB.build_scene(generate_mixed_scene(str(tmp_path)),
                                      device="cpu")
    assert static.n_tris == 128 and static.tri_chunks > 0
    assert scene.ptris.tris.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TB.build_scene(generate_lit_stress_scene(4))
