"""Port parity: double-single arithmetic, the counter hash, CMJ sampling and
the thin-lens camera (paths_tpu_torch vs paths_tpu on the same inputs).

Integer work (hash, CMJ patterns, uniforms) and the double-single error-free
transforms must match bit for bit.  Camera rays are held to atol 1e-6: the
lens sample's sin/cos may differ by an ulp between XLA and PyTorch.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paths_tpu import camera as JC
from paths_tpu import render as JR
from paths_tpu.math import ds as jds
from paths_tpu.sampling import cmj as jcmj
from paths_tpu.sampling import hashing as jh

from paths_tpu_torch import camera as TC
from paths_tpu_torch import render as TR
from paths_tpu_torch.math import ds as tds
from paths_tpu_torch.sampling import cmj as tcmj
from paths_tpu_torch.sampling import hashing as th

torch.set_num_threads(2)


def _words(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("n_keys", [1, 3, 5])
def test_hash_u32_bit_exact(n_keys):
    rng = np.random.default_rng(n_keys)
    keys = [_words(rng, 4096) for _ in range(n_keys)]
    keys[0][:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(jh.hash_u32(*[jnp.asarray(k) for k in keys]))
    got = th.hash_u32(*[_t(k) for k in keys]).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_uniform_bit_exact():
    rng = np.random.default_rng(7)
    seed, pix, sid = 12345, _words(rng, 4096), _words(rng, 4096)
    ctr = rng.integers(0, 110, 4096).astype(np.uint32)
    want = np.asarray(jh.uniform(seed, jnp.asarray(pix), jnp.asarray(sid),
                                 jnp.asarray(ctr)))
    got = th.uniform(seed, _t(pix), _t(sid), _t(ctr)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    lane_key, bounce = _words(rng, 4096), rng.integers(0, 11, 4096)
    want = np.asarray(jh.shading_uniform(seed, jnp.asarray(lane_key),
                                         jnp.asarray(bounce), 6))
    got = th.shading_uniform(seed, _t(lane_key), _t(bounce), 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_cmj_bit_exact():
    rng = np.random.default_rng(3)
    s = rng.integers(0, 16, 4096).astype(np.uint32)
    p = _words(rng, 4096)
    jx, jy = jcmj.cmj(jnp.asarray(s), 4, 4, jnp.asarray(p))
    tx, ty = tcmj.cmj(_t(s), 4, 4, _t(p))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    dx, dy = jcmj.cmj_disk(jnp.asarray(s), 4, 4, jnp.asarray(p))
    ex, ey = tcmj.cmj_disk(_t(s), 4, 4, _t(p))
    np.testing.assert_allclose(ex.numpy(), np.asarray(dx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ey.numpy(), np.asarray(dy), rtol=0, atol=1e-6)


def test_ds_transforms_bit_exact():
    rng = np.random.default_rng(5)
    a = (rng.normal(size=8192) * 10.0 ** rng.integers(-6, 7, 8192)).astype(np.float32)
    b = (rng.normal(size=8192) * 10.0 ** rng.integers(-6, 7, 8192)).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for jf, tf in ((jds.two_sum, tds.two_sum), (jds.two_prod, tds.two_prod)):
        for jv, tv in zip(jf(ja, jb), tf(ta, tb)):
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    hi = np.abs(a)
    lo = (hi * rng.uniform(-1e-8, 1e-8, hi.shape)).astype(np.float32)
    for jv, tv in zip(jds.sqrt((jnp.asarray(hi), jnp.asarray(lo))),
                      tds.sqrt((torch.from_numpy(hi), torch.from_numpy(lo)))):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


_CAMERAS = {
    "stress": dict(width=720, height=480, location=(0.0, -5.0, -13.0),
                   orientation=(0.0, 0.0, -0.3), sensor_width=0.036,
                   sensor_height=0.024, focal_length=0.05,
                   focus_distance=10.0, aperture=8.0),
    "ct_demo": dict(width=72, height=48, location=(0.0, 1.2, -6.0),
                    orientation=(-0.12, 0.0, 0.0), sensor_width=0.036,
                    sensor_height=0.024, focal_length=0.05,
                    focus_distance=6.0, aperture=16.0),
}


@pytest.mark.parametrize("name", sorted(_CAMERAS))
def test_camera_rays(name):
    kw = _CAMERAS[name]
    jcam = JC.make_camera(**kw)
    tcam = TC.make_camera(**kw, device="cpu")
    for f in JC.Camera._fields:
        np.testing.assert_array_equal(getattr(tcam, f).numpy(),
                                      np.asarray(getattr(jcam, f)))
    W, H = kw["width"], kw["height"]
    pix = np.arange(W * H, dtype=np.uint32)[::7]
    px, py = (pix % W).astype(np.int32), (pix // W).astype(np.int32)
    sid = (pix % 37).astype(np.uint32)
    want = JR.gen_camera_rays(jcam, jnp.asarray(px), jnp.asarray(py),
                              jnp.asarray(pix), jnp.asarray(sid), jnp.uint32(9))
    got = TR.gen_camera_rays(tcam, torch.from_numpy(px), torch.from_numpy(py),
                             _t(pix), _t(sid), 9)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
