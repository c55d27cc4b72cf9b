"""Port parity for the HDRI sky and environment NEE: the port's own HDR
loader (``paths_tpu_torch/scene/hdr_loader.py``), ``sky.hdri``'s
importance-sampling tables, ``sky.sample_env`` and the HDRI
``ambient_light`` against ``paths_tpu``'s, on the CPU, and the port's copy
of the reference's constant-sky estimator test (tests/test_env.py).

The reference's lookups run jnp's arccos/atan2/sin/cos and the port's
torch's: they agree to an ulp or so, so a direction within rounding of a
texel edge may land in the neighbouring texel.  Those lanes are counted and
stated, never hidden.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import torch

from paths_tpu import sky as JS
from paths_tpu.scene.hdr_loader import load_hdr as jax_load_hdr
from paths_tpu.scene.hdr_loader import write_hdr as jax_write_hdr

from paths_tpu_torch import integrator as TI
from paths_tpu_torch import sky as TS
from paths_tpu_torch.sampling import hashing as TH
from paths_tpu_torch.scene import desc as D
from paths_tpu_torch.scene.build import build_scene
from paths_tpu_torch.scene.hdr_loader import load_hdr, write_hdr

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUNRISE = os.path.join(REPO, "scenes", "assets", "sunrise.hdr")
N = 4096


def _index_sky(sky, backend):
    """The sky with its image replaced by each texel's flat index (in all
    three channels), so that a lookup returns the texel it chose."""
    h, w = sky.image.shape[0], sky.image.shape[1]
    idx = np.repeat(np.arange(h * w, dtype=np.float32).reshape(h, w, 1), 3, -1)
    return sky._replace(image=backend(idx))


def test_load_hdr_and_round_trip_match_reference(tmp_path):
    """load_hdr of the bundled sunrise.hdr (RLE scanlines) and a write_hdr ->
    load_hdr round trip (flat scanlines) equal the reference's bit for bit,
    file bytes included."""
    img = load_hdr(SUNRISE)
    want = jax_load_hdr(SUNRISE)
    assert img.shape == (128, 256, 3) and img.dtype == np.float32
    np.testing.assert_array_equal(img, want)
    rng = np.random.default_rng(0)
    rand = rng.uniform(0.0, 50.0, (8, 12, 3)).astype(np.float32)
    rand[0, 0] = 0.0  # a black texel: exponent 0
    for name, src in (("sunrise", img), ("random", rand)):
        a, b = str(tmp_path / f"{name}_port.hdr"), str(tmp_path / f"{name}_ref.hdr")
        write_hdr(a, src)
        jax_write_hdr(b, src)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        np.testing.assert_array_equal(load_hdr(a), jax_load_hdr(b))


def test_hdri_tables_match_reference():
    """hdri's image, env_cdf and env_inv_pdf equal the reference's bit for
    bit on sunrise.hdr and on an all-black map (the sin-latitude fallback)."""
    for img in (load_hdr(SUNRISE), np.zeros((4, 8, 3), np.float32)):
        jt, jsky = JS.hdri(img)
        tt, tsky = TS.hdri(img, "cpu")
        assert tt == jt == TS.HDRI
        for f in ("image", "env_cdf", "env_inv_pdf"):
            got, want = getattr(tsky, f), np.asarray(getattr(jsky, f))
            assert got.dtype == torch.float32 and got.shape == want.shape, f
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


def test_sample_env_matches_reference():
    """sample_env on seeded uniforms: the same texel on every lane, the same
    radiance and inv_pdf bit for bit, in_dir within atol 1e-6."""
    img = load_hdr(SUNRISE)
    _, jsky = JS.hdri(img)
    _, tsky = TS.hdri(img, "cpu")
    rng = np.random.default_rng(3)
    u = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(3)]
    u[0][:4] = [0.0, 1.0 - 2.0 ** -24, float(np.asarray(jsky.env_cdf)[1000]), 0.5]
    ju = [jnp.asarray(x) for x in u]
    tu = [torch.from_numpy(x) for x in u]
    j_dir, j_inv, j_rad = (np.asarray(x) for x in JS.sample_env(jsky, *ju))
    t_dir, t_inv, t_rad = TS.sample_env(tsky, *tu)
    j_idx = np.asarray(JS.sample_env(_index_sky(jsky, jnp.asarray), *ju)[2])
    t_idx = TS.sample_env(_index_sky(tsky, torch.from_numpy), *tu)[2]
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    np.testing.assert_array_equal(t_rad.numpy(), j_rad)
    np.testing.assert_array_equal(t_inv.numpy(), j_inv)
    np.testing.assert_allclose(t_dir.numpy(), j_dir, rtol=0, atol=1e-6)
    # The sun dominates the samples, and each sample's lookup is its texel.
    assert len(np.unique(j_idx[:, 0])) > 100
    look = TS.ambient_light(TS.HDRI, tsky, t_dir)
    assert float((look == t_rad).all(-1).float().mean()) > 0.99


def test_hdri_ambient_light_matches_reference_texel():
    """The HDRI lookup on 4,096 seeded directions picks the reference's
    texel on every lane, or, where it does not, the lane's x or y lies
    within 1e-4 of a texel edge.  On this seed no lane parts (0 such lanes);
    the 1,024 last lanes are aimed at texel corners and centres, where
    rounding decides the edge lanes."""
    img = load_hdr(SUNRISE)
    h, w = img.shape[:2]
    _, jsky = JS.hdri(img)
    _, tsky = TS.hdri(img, "cpu")
    rng = np.random.default_rng(4)
    dirs = rng.normal(size=(N, 3))
    # The last 1,024 lanes at texel corners (even) and centres (odd).
    k = np.arange(1024)
    tx = rng.integers(0, w, 1024) + np.where(k % 2 == 0, 0.0, 0.5)
    ty = rng.integers(1, h, 1024) + np.where(k % 2 == 0, 0.0, 0.5)
    long, lat = np.pi * (2.0 * tx / w - 1.0), np.pi * (1.0 - ty / h)
    dirs[-1024:] = np.stack([np.sin(lat) * np.cos(long), np.cos(lat),
                             np.sin(lat) * np.sin(long)], -1)
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    want = np.asarray(JS.ambient_light(JS.HDRI, _index_sky(jsky, jnp.asarray),
                                       jnp.asarray(dirs)))[:, 0]
    got = TS.ambient_light(TS.HDRI, _index_sky(tsky, torch.from_numpy),
                           torch.from_numpy(dirs))[:, 0].numpy()
    d64 = dirs.astype(np.float64)
    x = (w / 2.0) * (np.arctan2(d64[:, 2], d64[:, 0]) / np.pi) + w / 2.0
    y = h * (1.0 - np.arccos(np.clip(d64[:, 1], -1, 1)) / np.pi)
    edge = (np.abs(x - np.rint(x)) < 1e-4) | (np.abs(y - np.rint(y)) < 1e-4)
    parted = got != want
    assert not (parted & ~edge).any()
    assert int(parted.sum()) == 0, f"{int(parted.sum())} lanes at a texel edge parted"
    assert int(edge.sum()) >= 400  # the corner lanes are there
    np.testing.assert_array_equal(
        TS.ambient_light(TS.HDRI, tsky, torch.from_numpy(dirs)).numpy(),
        np.asarray(JS.ambient_light(JS.HDRI, jsky, jnp.asarray(dirs))))


def _hdri_sphere_scene(tmp_path, img, env_nee):
    """A 0.5-albedo Lambertian unit sphere at the origin under the HDRI
    image (the reference test's scene, built by the port)."""
    hdr_path = str(tmp_path / "env.hdr")
    write_hdr(hdr_path, img)
    sd = D.SceneDescription()
    sd.skybox = D.SkyboxD(kind="hdri", filename=hdr_path)
    mat = D.MaterialD(kind="lambertian")
    mat.albedo = D.MaterialColourD(colour=D.ColourD(0.5, 0.5, 0.5))
    sd.objects = [D.ObjectD(shape_kind="sphere",
                            sphere=D.SphereD(D.Vec3D(0, 0, 0), 1.0),
                            material=mat)]
    static, scene, _ = build_scene(sd, device="cpu")
    return dataclasses.replace(static, env_nee=env_nee, max_bounces=4), scene


def test_env_nee_matches_plain_path_tracing(tmp_path):
    """A Lambertian sphere under a constant HDRI: env NEE and plain
    skybox-on-miss agree, and both converge to albedo x sky = 0.5 for the
    head-on view (the reference's tests/test_env.py estimator test)."""
    img = np.full((8, 16, 3), 1.0, np.float32)
    n = 2048
    o = torch.tensor([[0.0, 0.0, -5.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    pid = TH.as_u32(np.arange(n, dtype=np.uint32))
    sid = TH.as_u32(np.zeros(n, np.uint32))
    results = {}
    for nee in (False, True):
        static, scene = _hdri_sphere_scene(tmp_path, img, nee)
        assert static.sky_type == TS.HDRI and static.env_nee == nee
        col = TI.trace_rays(static, scene, o, d, pid, sid, 0).numpy()
        assert np.isfinite(col).all()
        results[nee] = col.mean(axis=0)
    np.testing.assert_allclose(results[True], results[False], rtol=0.1)
    np.testing.assert_allclose(results[True], 0.5, rtol=0.1)
