"""Port parity for the slice as a whole: scene build, one path_step, whole
renders (paths_tpu_torch on the CPU, with the plain versions of the sphere
kernels, vs paths_tpu).

The reference renders the lit stress scene with PATHS_TPU_FORCE_PALLAS=1, so
its traversal runs through the Pallas sorted-walk kernels in interpret mode
(as tests/test_force_pallas.py does); the unforced CPU path would unroll 41
spheres and take XLA many minutes to compile.  Images are held to relative
MSE < 1e-4 (the measure of tests/test_golden.py): the two packages differ
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
from paths_tpu.scene.stress import generate_stress_scene as jax_stress

from paths_tpu_torch import camera as TC
from paths_tpu_torch import integrator as TI
from paths_tpu_torch import render as TR
from paths_tpu_torch.sampling import hashing as TH
from paths_tpu_torch.scene import build as TB
from paths_tpu_torch.scene.stress import STRESS_LIGHT, generate_lit_stress_scene
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
            out["sky.colour_a"] = np.asarray(jscene.sky.colour_a)
            out["sky.colour_b"] = np.asarray(jscene.sky.colour_b)
        elif name == "psph":
            if jscene.psph is not None:
                out["psph.tris"] = np.asarray(jscene.psph.tris)
                out["psph.chunk_meta"] = np.asarray(jscene.psph.chunk_meta)
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
    want = _as_numpy(jscene)
    got = scene._asdict()
    for name, arr in want.items():
        if name.startswith("sky."):
            g = getattr(scene.sky, name[4:])
        elif name.startswith("psph."):
            g = getattr(scene.psph, name[5:])
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


def test_path_step_matches_reference(lit_stress):
    """One bounce on identical state: primary rays of a 16x16 wave."""
    (jstatic, jscene, jcam), (_, _, cam) = lit_stress
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


def test_render_wave_lit_stress_matches_reference(lit_stress):
    (jstatic, jscene, jcam), _ = lit_stress
    static, scene = scene_from_numpy(dataclasses.asdict(jstatic),
                                     _as_numpy(jscene), "cpu")
    static = dataclasses.replace(static, max_bounces=3)
    jstatic = dataclasses.replace(jstatic, max_bounces=3)
    W = H = 16
    px, py, pix = _lanes(W, H)
    jcam16 = JR.C.resize(jcam, W, H)
    cam = TC.resize(TC.Camera(*[torch.tensor(np.asarray(x)) for x in jcam]), W, H)
    want, got = [], []
    for s in range(2):
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


def test_build_rejects_meshes_and_requires_a_device():
    sd = generate_lit_stress_scene(4)
    sd.objects[0].shape_kind = "mesh"
    with pytest.raises(NotImplementedError, match="slice 2"):
        TB.build_scene(sd, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TB.build_scene(generate_lit_stress_scene(4))
