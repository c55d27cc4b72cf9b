"""Port parity: the packed plane-form triangle table and the plain PyTorch
versions of the closest-hit (K3) and any-hit (K4) triangle traversal
kernels, held against the reference package's packer and its Pallas
sorted-walk kernels run in interpret mode (as tests/test_sorted_traverse.py
runs them).

Packing is bit-exact at 8 and at 20 rows per chunk.  The plain versions are
flat brute force over every slot with the reference kernel's fused
multiply-adds (the ones XLA's CPU compilation contracts); the sorted walk
visits every chunk a lane can hit, so t, gid, ent and the occluded flag must
be equal exactly, resident and streamed alike.  The replicated table is
shown to be a relayout of the same rows.

The lanes: rays aimed inside random triangles and exactly at their edges
(where the barycentric FMAs decide hit or miss), incoherent rays, rays
parallel to axis-aligned triangles (t = +-inf), dead lanes,
exclusions, a band of finite t_init, random excl_ent and t_max == 0 lanes.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paths_tpu.bvh.build import build_bvh
from paths_tpu.ops.pallas_traverse import PACK_LEAF, pack_chunked as jax_pack
from paths_tpu.ops.sorted_traverse import (
    closest_hit_sorted,
    occludes_sorted,
    replicate_tris,
)

from paths_tpu_torch.ops import tri_traverse as TT

torch.set_num_threads(2)

T = 300
N = 1500
N_ENT = 13


def _soup(seed=7):
    """T small triangles in [-1, 1]^3, 24 of them axis-aligned (planes
    z = const and y = const), BVH-ordered by the reference's Python
    builder."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (T, 3))
    v0, v1, v2 = (c + rng.uniform(-0.15, 0.15, (T, 3)) for _ in range(3))
    v1[:12, 2] = v2[:12, 2] = v0[:12, 2]
    v1[12:24, 1] = v2[12:24, 1] = v0[12:24, 1]
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    flat = build_bvh(np.minimum(np.minimum(v0, v1), v2),
                     np.maximum(np.maximum(v0, v1), v2),
                     leaf_size=PACK_LEAF, use_native=False)
    o = flat.order
    return flat, v0[o], v1[o], v2[o], n[o], (np.arange(T) % N_ENT).astype(np.int64)


def _rays(v0, v1, v2, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (N, 3))
    k = rng.integers(0, T, N)
    w = rng.dirichlet((1, 1, 1), N)
    edge = np.arange(N) % 3 == 0  # a third aimed exactly at an edge
    w[edge, rng.integers(0, 3, int(edge.sum()))] = 0.0
    w /= w.sum(1, keepdims=True)
    d = w[:, :1] * v0[k] + w[:, 1:2] * v1[k] + w[:, 2:] * v2[k] - o
    d[1::7] = rng.normal(size=d[1::7].shape)  # incoherent
    o, d = o.astype(np.float32), d.astype(np.float32)
    # Parallel to the axis-aligned triangles: n.d == 0, t = +-inf.
    d[1000:1040, 2] = 0.0
    d[1040:1080, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    o[400:500] = 1e30  # dead lanes
    excl = np.full(N, -1, np.int32)
    excl[:200] = rng.integers(0, T, 200)
    excl[200:260] = k[200:260]  # the aimed-at triangle itself
    t_init = np.full(N, 3.4e38, np.float32)
    t_init[600:800] = rng.uniform(0.5, 4.0, 200).astype(np.float32)
    excl_ent = rng.integers(-1, N_ENT, N).astype(np.int32)
    t_max = rng.uniform(0.1, 6.0, N).astype(np.float32)
    t_max[::17] = 0.0  # the collapsed-t quirk: reported occluded
    return o, d, excl, t_init, excl_ent, t_max


@pytest.fixture(scope="module")
def soup():
    flat, v0, v1, v2, n, ents = _soup()
    return flat, (v0, v1, v2, n, ents), _rays(v0, v1, v2)


@pytest.mark.parametrize("rows", [TT.ROWS_PER_CHUNK, TT.ROWS_PER_CHUNK_LARGE])
def test_pack_bit_exact(soup, rows):
    flat, (v0, v1, v2, n, ents), _ = soup
    want, wn = jax_pack(flat, v0, v1, v2, n, ent=ents, rows_per_chunk=rows)
    got, gn = TT.pack_chunked(flat, v0, v1, v2, n, ent=ents, rows_per_chunk=rows)
    assert gn == wn
    for f in TT.PackedTris._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def _tables(soup, rows):
    flat, (v0, v1, v2, n, ents), _ = soup
    ct, nc = jax_pack(flat, v0, v1, v2, n, ent=ents, rows_per_chunk=rows)
    pt, _ = TT.pack_chunked(flat, v0, v1, v2, n, ent=ents, rows_per_chunk=rows)
    return ct, pt, nc


def test_replicated_table_is_a_layout_of_the_packed_rows(soup):
    """The reference's replicated table (tris_rep) holds each slot's 14
    fields broadcast across 128 lanes and nothing else, so the port leaves
    it out."""
    ct, pt, _ = _tables(soup, TT.ROWS_PER_CHUNK)
    rep = np.asarray(replicate_tris(ct.tris)).reshape(-1, PACK_LEAF, 14, 128)
    slots = pt.tris.numpy().reshape(-1, PACK_LEAF, TT.TRI_STRIDE)
    fields = slots[:, :, list(range(12)) + [12, 14]]
    np.testing.assert_array_equal(rep, np.broadcast_to(fields[..., None], rep.shape))


@pytest.mark.parametrize("stream,rows", [(False, TT.ROWS_PER_CHUNK),
                                         (True, TT.ROWS_PER_CHUNK_LARGE)])
def test_closest_hit_plain_matches_reference_kernel(soup, stream, rows):
    ct, pt, nc = _tables(soup, rows)
    o, d, excl, t_init, _, _ = soup[2]
    want = closest_hit_sorted(
        ct, nc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(excl),
        jnp.asarray(t_init), rows_per_chunk=rows, stream=stream,
        interpret=True)
    got = TT.closest_hit_tris(pt, nc, *(torch.from_numpy(a) for a in (o, d, excl, t_init)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    t = got[0].numpy()
    assert (t < 1e38).sum() > N // 2  # the rays really hit triangles
    assert (t[400:500] >= 1e38).all()  # dead lanes miss


@pytest.mark.parametrize("stream,rows", [(False, TT.ROWS_PER_CHUNK),
                                         (True, TT.ROWS_PER_CHUNK_LARGE)])
def test_any_hit_plain_matches_reference_kernel(soup, stream, rows):
    ct, pt, nc = _tables(soup, rows)
    o, d, excl, _, excl_ent, t_max = soup[2]
    want = occludes_sorted(
        ct, nc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(excl),
        jnp.asarray(excl_ent), jnp.asarray(t_max), rows_per_chunk=rows,
        stream=stream, interpret=True)
    got = TT.occludes_tris(pt, nc, *(torch.from_numpy(a) for a in
                                      (o, d, excl, excl_ent, t_max)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    live = o[:, 0] < 1e29
    assert got.numpy()[live & (t_max > 0)].sum() > N // 4
    assert got.numpy()[t_max == 0].all()


def test_plain_needs_the_contracted_fmas(soup, monkeypatch):
    """Without the fused multiply-adds the plain version no longer matches
    the reference kernel: the FMAs are part of the contract, not noise."""
    ct, pt, nc = _tables(soup, TT.ROWS_PER_CHUNK)
    o, d, excl, t_init, _, _ = (torch.from_numpy(a) for a in soup[2])
    exact = TT.closest_hit_tris(pt, nc, o, d, excl, t_init)
    monkeypatch.setattr(TT, "_fma", lambda a, b, c: a * b + c)
    rounded = TT.closest_hit_tris(pt, nc, o, d, excl, t_init)
    assert int((rounded[0] != exact[0]).sum()) > 50


def test_launch_checks_reject_bad_inputs(soup):
    """The checks a CUDA launch runs first: dtype, shape, contiguity, the
    chunk count and the table's alignment."""
    _, pt, nc = _tables(soup, TT.ROWS_PER_CHUNK)
    o, d, excl, t_init, _, _ = (torch.from_numpy(a) for a in soup[2])
    seed = [("t_init", t_init, torch.float32)]
    TT._check_launch(pt, nc, o, d, excl, seed)  # well-formed: no raise
    with pytest.raises(TypeError):
        TT._check_launch(pt, nc, o, d, excl.long(), seed)
    with pytest.raises(ValueError):
        TT._check_launch(pt, nc, o[:, :2], d, excl, seed)
    with pytest.raises(ValueError):
        TT._check_launch(pt, nc, o, d.t().contiguous().t(), excl, seed)
    with pytest.raises(ValueError):
        TT._check_launch(pt, pt.chunk_meta.shape[0] + 1, o, d, excl, seed)
    with pytest.raises(TypeError):
        TT._check_launch(pt._replace(tris=pt.tris.double()), nc, o, d, excl, seed)
    misaligned = pt._replace(tris=torch.zeros(pt.tris.numel() + 1)[1:].view(-1, 128))
    with pytest.raises(ValueError, match="aligned"):
        TT._check_launch(misaligned, nc, o, d, excl, seed)
