"""Port parity per function: materials, lights, sky and the double-single
ray/sphere test (paths_tpu_torch vs paths_tpu on the same numpy inputs).

Tolerance rtol 1e-5, atol 1e-6: the two packages round transcendental
functions (sin, cos, exp, log) differently by an ulp or so, and the reference
runs op by op here, so nothing else differs.  Integer and boolean outputs
(specular flags) must match exactly.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paths_tpu import lights as JL
from paths_tpu import materials as JM
from paths_tpu import sky as JS
from paths_tpu.geom import sphere as JG

from paths_tpu_torch import lights as TL
from paths_tpu_torch import materials as TM
from paths_tpu_torch import sky as TS
from paths_tpu_torch.geom import sphere as TG

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
N = 2048


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _material(rng, fresnel: bool):
    """A random per-lane material record over every material id."""
    f = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    mat = dict(
        mtype=rng.integers(0, 5 if fresnel else 4, N).astype(np.int32),
        albedo=f(N, 3), emit=f(N, 3) * (rng.uniform(size=(N, 1)) < 0.2),
        r0=(f(N) * 1.5).astype(np.float32), metalness=f(N),
        roughness=np.where(rng.uniform(size=N) < 0.1, 0.0, f(N)).astype(np.float32),
    )
    if fresnel:
        mat.update(
            fd_mtype=rng.integers(0, 4, N).astype(np.int32),
            fs_mtype=rng.integers(0, 4, N).astype(np.int32),
            fs_albedo=f(N, 3), fs_r0=f(N), fs_metalness=f(N),
            fs_roughness=f(N), fresnel_r0=(f(N) * 0.1).astype(np.float32),
        )
    return mat


def _both(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()})


def _geometry(rng):
    normal = _unit(rng, N)
    normal[:8] = [0, 1, 0]  # form_basis's exact n.x == 0 branch
    vec_out = _unit(rng, N)
    flip = (np.sum(vec_out * normal, axis=1) < 0)[:, None]
    vec_out = np.where(flip, -vec_out, vec_out).astype(np.float32)
    vec_in = -_unit(rng, N)
    return normal, vec_out, vec_in


@pytest.mark.parametrize("fresnel", [False, True])
def test_eval_brdf_and_emittance(fresnel):
    rng = np.random.default_rng(1 + fresnel)
    jm, tm = _both(_material(rng, fresnel))
    normal, vec_out, vec_in = _geometry(rng)
    want = JM.eval_brdf(jm, *[jnp.asarray(a) for a in (vec_out, vec_in, normal)])
    got = TM.eval_brdf(tm, *[torch.from_numpy(a) for a in (vec_out, vec_in, normal)])
    _close(got, want)
    _close(TM.emittance(tm), JM.emittance(jm))


@pytest.mark.parametrize("fresnel", [False, True])
def test_sample(fresnel):
    rng = np.random.default_rng(3 + fresnel)
    jm, tm = _both(_material(rng, fresnel))
    normal, vec_out, _ = _geometry(rng)
    u = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(3)]
    want = JM.sample(jm, jnp.asarray(vec_out), jnp.asarray(normal),
                     *[jnp.asarray(x) for x in u])
    got = TM.sample(tm, torch.from_numpy(vec_out), torch.from_numpy(normal),
                    *[torch.from_numpy(x) for x in u])
    for g, w in zip(got[:3], want[:3]):
        # rtol 5e-5: at low roughness the Beckmann lobe's pdf and brdf turn
        # an ulp of difference in the facet's sin/cos into ~4e-5 relative
        # (tan^2 = (1 - cos^2)/cos^2 cancels, then exp(-tan^2/m^2)).
        _close(g, w, rtol=5e-5, atol=ATOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_light_sample():
    rng = np.random.default_rng(5)
    light = dict(
        ltype=rng.integers(0, 2, N).astype(np.int32),
        position=rng.uniform(-5, 5, (N, 3)).astype(np.float32),
        radius=rng.uniform(0.1, 2.0, N).astype(np.float32),
    )
    jl, tl = _both(light)
    p = rng.uniform(-8, 8, (N, 3)).astype(np.float32)
    u1, u2 = (rng.uniform(0, 1, N).astype(np.float32) for _ in range(2))
    want = JL.sample(jl, jnp.asarray(p), jnp.asarray(u1), jnp.asarray(u2))
    got = TL.sample(tl, torch.from_numpy(p), torch.from_numpy(u1),
                    torch.from_numpy(u2))
    for g, w in zip(got, want):
        _close(g, w)


def test_sky():
    rng = np.random.default_rng(6)
    dirs = _unit(rng, N)
    for jsky, tsky in (
        (JS.flat([0.8, 0.7, 0.6]), TS.flat([0.8, 0.7, 0.6])),
        (JS.gradient([0.35, 0.45, 0.6], [0.8, 0.8, 0.85]),
         TS.gradient([0.35, 0.45, 0.6], [0.8, 0.8, 0.85])),
    ):
        assert jsky[0] == tsky[0]
        want = JS.ambient_light(jsky[0], jsky[1], jnp.asarray(dirs))
        got = TS.ambient_light(tsky[0], tsky[1], torch.from_numpy(dirs))
        _close(got, want)
    with pytest.raises(NotImplementedError):
        TS.hdri(np.zeros((2, 4, 3), np.float32))


@pytest.mark.parametrize("radius", [0.7, 1e6])
def test_sphere_intersect(radius):
    """The double-single test, including a radius-1e6 ground sphere seen
    from near its surface (where a plain f32 quadratic loses the scene)."""
    rng = np.random.default_rng(7)
    center = np.array([0.3, -radius, 0.2], np.float32)
    o = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.05, 4, N)
    d = _unit(rng, N)
    d[: N // 2, 1] = -np.abs(d[: N // 2, 1])  # half aim down at the plane
    if radius < 1.0:  # a small sphere: aim half the rays near its centre
        center = np.array([0.3, 1.2, 0.2], np.float32)
        aim = center + rng.uniform(-radius, radius, (N // 2, 3))
        d[: N // 2] = aim - o[: N // 2]
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = np.broadcast_to(center, (N, 3)).copy()
    r = np.full(N, radius, np.float32)
    wt, wh = JG.intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c), jnp.asarray(r))
    gt, gh = TG.intersect(torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(c), torch.from_numpy(r))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    _close(gt, wt, rtol=1e-6, atol=0)
    assert gh.numpy().sum() > N // 8
    hit = gh.numpy()
    wl, wn = JG.surface(jnp.asarray(o), jnp.asarray(d), wt, jnp.asarray(c))
    gl, gn = TG.surface(torch.from_numpy(o), torch.from_numpy(d), gt,
                        torch.from_numpy(c))
    np.testing.assert_allclose(gl.numpy()[hit], np.asarray(wl)[hit], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(gn.numpy()[hit], np.asarray(wn)[hit], rtol=RTOL, atol=ATOL)
