"""Port parity: the packed small-sphere table and the plain PyTorch versions
of the closest-hit (K1) and any-hit (K2) sphere traversal kernels, held
against the reference package's packer and its Pallas sorted-walk kernels
run in interpret mode (as tests/test_sorted_traverse.py runs them).

Packing is bit-exact.  The plain versions are flat brute force over every
slot; the sorted walk visits a conservative superset of the chunks a lane
can hit, so t, gid, ent and the occluded flag must be equal exactly.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paths_tpu.ops.pallas_traverse import pack_spheres_chunked as jax_pack
from paths_tpu.ops.sorted_traverse import (
    SPH_ROWS_PER_CHUNK_SORTED,
    closest_hit_spheres_sorted,
    occludes_spheres_sorted,
)

from paths_tpu_torch.ops import sphere_traverse as ST

torch.set_num_threads(2)

S = 40
N = 384


def _spheres(seed=11):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (S, 3))
    radii = rng.uniform(0.05, 0.4, S)
    ents = (np.arange(S) % 7).astype(np.int64)
    return centers, radii, ents


def _rays(seed=12):
    """Rays from a shell around the spheres toward the cluster, with dead
    lanes, exclusions and a mixed t_init."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    target = rng.uniform(-1.5, 1.5, (N, 3))
    d = (target - o).astype(np.float32)
    d[::5] = rng.normal(size=d[::5].shape)  # some incoherent rays
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    o[100:150] = 1e30  # dead lanes
    excl = np.full(N, -1, np.int32)
    excl[:80] = rng.integers(0, S, 80)
    t_init = np.full(N, 3.4e38, np.float32)
    t_init[200:300] = rng.uniform(0.5, 6.0, 100).astype(np.float32)
    return o, d, excl, t_init


@pytest.fixture(scope="module")
def packed():
    centers, radii, ents = _spheres()
    jps, jn, jorder = jax_pack(centers, radii, ent=ents, gid0=3,
                               rows_per_chunk=SPH_ROWS_PER_CHUNK_SORTED)
    tps, tn, torder = ST.pack_spheres_chunked(
        centers, radii, ent=ents, gid0=3)
    return (jps, jn, jorder), (tps, tn, torder)


def test_pack_bit_exact(packed):
    (jps, jn, jorder), (tps, tn, torder) = packed
    assert tn == jn
    np.testing.assert_array_equal(torder, jorder)
    np.testing.assert_array_equal(tps.tris.numpy(), np.asarray(jps.tris))
    np.testing.assert_array_equal(tps.chunk_meta.numpy(), np.asarray(jps.chunk_meta))
    assert tps.tris.dtype == torch.float32


def test_closest_hit_plain_matches_reference_kernel(packed):
    (jps, jn, _), (tps, tn, _) = packed
    o, d, excl, t_init = _rays()
    want = closest_hit_spheres_sorted(
        jps, jn, jnp.asarray(o), jnp.asarray(d), jnp.asarray(excl),
        jnp.asarray(t_init), interpret=True)
    got = ST.closest_hit_spheres(
        tps, tn, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(excl), torch.from_numpy(t_init))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    t = got[0].numpy()
    assert (t < 1e38).sum() > 50  # the rays really hit spheres


def test_any_hit_plain_matches_reference_kernel(packed):
    (jps, jn, _), (tps, tn, _) = packed
    o, d, excl, _ = _rays()
    rng = np.random.default_rng(13)
    excl_ent = rng.integers(-1, 7, N).astype(np.int32)
    t_max = rng.uniform(0.0, 8.0, N).astype(np.float32)
    t_max[::17] = 0.0  # the collapsed-t quirk: reported occluded
    want = occludes_spheres_sorted(
        jps, jn, jnp.asarray(o), jnp.asarray(d), jnp.asarray(excl),
        jnp.asarray(excl_ent), jnp.asarray(t_max), interpret=True)
    got = ST.occludes_spheres(
        tps, tn, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(excl), torch.from_numpy(excl_ent),
        torch.from_numpy(t_max))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    live = o[:, 0] < 1e29
    assert got.numpy()[live & (t_max > 0)].sum() > 20
    assert got.numpy()[t_max == 0].all()


def test_launch_checks_reject_bad_inputs(packed):
    """The checks a CUDA launch runs first: dtype, shape, contiguity and
    the chunk count."""
    _, (tps, tn, _) = packed
    o, d, excl, t_init = (torch.from_numpy(a) for a in _rays())
    seed = [("t_init", t_init, torch.float32)]
    ST._check_launch(tps, tn, o, d, excl, seed)  # well-formed: no raise
    with pytest.raises(TypeError):
        ST._check_launch(tps, tn, o, d, excl.long(), seed)
    with pytest.raises(ValueError):
        ST._check_launch(tps, tn, o[:, :2], d, excl, seed)
    with pytest.raises(ValueError):
        ST._check_launch(tps, tn, o, d.t().contiguous().t(), excl, seed)
    with pytest.raises(ValueError):
        ST._check_launch(tps, tps.chunk_meta.shape[0] + 1, o, d, excl, seed)
