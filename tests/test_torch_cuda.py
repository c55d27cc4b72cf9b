"""The port's CUDA kernels on the card, held against their plain PyTorch
versions.  Every test here needs a CUDA device (marker ``cuda``) and skips
without one.  The file imports no JAX, so it runs on a machine that has only
PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts=""
"""

import numpy as np
import pytest
import torch

from paths_tpu_torch.ops import sphere_traverse as ST

torch.set_num_threads(2)

N = 4096
S = 300


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene_and_rays(dev, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (S, 3))
    radii = rng.uniform(0.1, 1.5, S)
    ps, n_chunks, _ = ST.pack_spheres_chunked(
        centers, radii, ent=np.arange(S) % 17, gid0=2, device=dev)
    o = rng.uniform(-14, 14, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3))
    d[: N // 2] = rng.uniform(-8, 8, (N // 2, 3)) - o[: N // 2]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o[::23] = 1e30  # dead lanes
    excl = np.where(rng.uniform(size=N) < 0.2, rng.integers(2, S + 2, N), -1)
    t_init = np.where(rng.uniform(size=N) < 0.5, 3.4e38, rng.uniform(0, 30, N))
    excl_ent = rng.integers(-1, 17, N)
    t_max = np.where(rng.uniform(size=N) < 0.05, 0.0, rng.uniform(0, 30, N))
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=dev)
    return ps, n_chunks, (t(o, np.float32), t(d, np.float32),
                          t(excl, np.int32), t(t_init, np.float32),
                          t(excl_ent, np.int32), t(t_max, np.float32))


@pytest.mark.cuda
def test_closest_hit_kernel_matches_plain(dev):
    ps, nc, (o, d, excl, t_init, _, _) = _scene_and_rays(dev)
    before = ST.LAUNCHES["sphere_closest_hit"]
    got = ST.closest_hit_spheres(ps, nc, o, d, excl, t_init)
    torch.cuda.synchronize()
    assert ST.LAUNCHES["sphere_closest_hit"] == before + 1
    want = ST.closest_hit_spheres_plain(ps.tris, o, d, excl, t_init)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] < 3.4e38).sum()) > N // 8


@pytest.mark.cuda
def test_any_hit_kernel_matches_plain(dev):
    ps, nc, (o, d, excl, _, excl_ent, t_max) = _scene_and_rays(dev, seed=1)
    got = ST.occludes_spheres(ps, nc, o, d, excl, excl_ent, t_max)
    want = ST.occludes_spheres_plain(ps.tris, o, d, excl, excl_ent, t_max)
    assert torch.equal(got, want)
    assert int(got.sum()) > N // 8


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(dev):
    ps, nc, (o, d, excl, t_init, _, _) = _scene_and_rays(dev)
    with pytest.raises(TypeError):
        ST.closest_hit_spheres(ps, nc, o, d, excl.long(), t_init)
    with pytest.raises(ValueError):
        ST.closest_hit_spheres(ps, nc, o, d, excl, t_init.cpu())
