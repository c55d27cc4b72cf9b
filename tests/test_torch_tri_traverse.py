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

The kernels walk a box hierarchy over the table's rows (``PackedTris.nodes``)
front to back; the tests below hold the hierarchy's boxes and shape, and a
Python emulation of the kernels' walk (the same stack, pruning and tie rule,
in f32) against the plain versions, bit for bit: on the soup, on a table of
duplicated triangles whose ties are exact, and on doom_standin's table, at 8,
20 and 32 rows a chunk (32: the table that ops/chunk_scan.py's K7 and K9
walk with the same kernels).

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there.
"""

import os
import types

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

from paths_tpu_torch.bvh.build import build_bvh as port_bvh
from paths_tpu_torch.ops import chunk_scan as CS
from paths_tpu_torch.ops import tri_traverse as TT
from paths_tpu_torch.scene import build as TB
from paths_tpu_torch.scene import models as TM
from paths_tpu_torch.scene.ply_loader import load_ply_file
from paths_tpu_torch.scene.yaml_loader import load_scene_description
from tri_walk_cases import BIG, ties_case, walk

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
    for f in TT.REFERENCE_FIELDS:
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


# ---------------------------------------------------------------- the hierarchy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _doom(n_lanes=96, seed=5):
    """doom_standin's triangles, BVH-ordered by the port's builder, and
    lanes: rays from above the terrain aimed exactly at vertices (shared by
    up to six triangles) and at edge midpoints, excluding the aimed-at
    triangle on some; rays with a zero direction component; incoherent rays
    from inside the box; dead lanes; excl_ent and t_max (some 0)."""
    sd = load_scene_description(os.path.join(REPO, "scenes", "doom_standin.yml"))
    ply = load_ply_file(os.path.join(REPO, "scenes", "assets", "doom_standin.ply"))
    tri = TB._mesh_triangles(sd.objects[0].mesh, TM.Model(ply.vertices, ply.faces), ent=0)
    lo = np.minimum(np.minimum(tri["v0"], tri["v1"]), tri["v2"])
    hi = np.maximum(np.maximum(tri["v0"], tri["v1"]), tri["v2"])
    flat = port_bvh(lo, hi)
    v0, v1, v2, n = (tri[k][flat.order] for k in ("v0", "v1", "v2", "n"))
    rng = np.random.default_rng(seed)
    k = rng.integers(0, len(v0), n_lanes)
    aim = np.where((np.arange(n_lanes) % 2 == 0)[:, None], v0[k], 0.5 * (v1[k] + v2[k]))
    o = aim + rng.uniform(-300, 300, (n_lanes, 3)) + [0.0, 400.0, 0.0]
    d = aim - o
    d[1::9, 0] = 0.0  # a zero component (the aim is then approximate)
    d[2::9, 2] = 0.0
    inc = np.arange(n_lanes) % 6 == 5
    o[inc] = lo.min(0) + rng.uniform(size=(int(inc.sum()), 3)) * (hi.max(0) - lo.min(0))
    d[inc] = rng.normal(size=(int(inc.sum()), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    o[7::13] = 1e30  # dead lanes
    excl = np.where(np.arange(n_lanes) % 4 == 1, k, -1).astype(np.int32)
    t_init = np.full(n_lanes, BIG, np.float32)
    excl_ent = rng.integers(-1, N_ENT, n_lanes).astype(np.int32)
    t_max = np.where(np.arange(n_lanes) % 10 == 3, 0.0,
                     rng.uniform(100, 2000, n_lanes)).astype(np.float32)
    ent = np.arange(len(v0)) % N_ENT
    return (flat, v0, v1, v2, n, ent), (o, d, excl, t_init, excl_ent, t_max)


@pytest.fixture(scope="module")
def doom():
    return _doom()


# The chunk sizes whose tables the walk kernels read: K3/K4's two, and K7/K9's.
WALK_ROWS = (TT.ROWS_PER_CHUNK, TT.ROWS_PER_CHUNK_LARGE, CS.TRI_ROWS_PER_CHUNK)


@pytest.fixture(scope="module")
def ties():
    return {rows: ties_case(rows, N_ENT) for rows in WALK_ROWS}


def _case(request, which, rows):
    """(flat, (v0, v1, v2, n, ent), PackedTris, n_chunks, lanes) of one
    case."""
    if which == "soup":
        flat, v0, v1, v2, n, ent = _soup()
        lanes = request.getfixturevalue("soup")[2]
    elif which == "ties":
        (flat, v0, v1, v2, n, ent), lanes = request.getfixturevalue("ties")[rows]
    else:
        (flat, v0, v1, v2, n, ent), lanes = request.getfixturevalue("doom")
    pt, nc = TT.pack_chunked(flat, v0, v1, v2, n, ent=ent, rows_per_chunk=rows)
    return flat, (v0, v1, v2, n, ent), pt, nc, lanes


CASES = [(w, r) for w in ("soup", "ties", "doom") for r in WALK_ROWS]


@pytest.mark.parametrize("which,rows", CASES)
def test_hierarchy_boxes_hold_their_rows(request, which, rows):
    """The hierarchy is the BVH's binary tree over the rows: each row a leaf
    exactly once (with its chunk), a leaf's box its row's f32 box padded by
    the kernels' rule, an inner node's the union of its children's, so every
    node's box contains the padded boxes of all the rows below it; and
    packing again gives the same bytes."""
    flat, (v0, v1, v2, n, ent), pt, nc, _ = _case(request, which, rows)
    nodes = pt.nodes.numpy()
    ref, aux = nodes[:, 3].astype(np.int64), nodes[:, 7].astype(np.int64)
    leaf = ref < 0
    n_rows = int((flat.prim_count > 0).sum())
    assert nodes.shape == (2 * n_rows - 1, TT.NODE_FLOATS)
    np.testing.assert_array_equal(-1 - ref[leaf], np.arange(n_rows))  # in preorder
    np.testing.assert_array_equal(aux[leaf], (-1 - ref[leaf]) // rows)
    inner = np.nonzero(~leaf)[0]
    np.testing.assert_array_equal(ref[inner], inner + 1)
    np.testing.assert_array_equal(aux[inner], flat.miss_link[inner + 1])
    parent = np.full(len(nodes), -1)
    parent[ref[inner]] = parent[aux[inner]] = inner
    assert (parent[1:] >= 0).all() and parent[0] == -1

    # Row boxes from the triangles, padded by the rule of row_tests.cuh.
    rows_of = TT._leaf_map(flat, len(v0))[0]
    tlo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    thi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    rlo = np.full((n_rows, 3), np.inf, np.float32)
    rhi = np.full((n_rows, 3), -np.inf, np.float32)
    np.minimum.at(rlo, rows_of, tlo)
    np.maximum.at(rhi, rows_of, thi)
    pad = np.float32(TT.BOX_PAD) * (np.abs(rlo) + np.abs(rhi) + (rhi - rlo)) + np.float32(1e-6)
    lrow = -1 - ref[leaf]
    np.testing.assert_array_equal(nodes[leaf, 0:3], (rlo - pad)[lrow])
    np.testing.assert_array_equal(nodes[leaf, 4:7], (rhi + pad)[lrow])
    np.testing.assert_array_equal(nodes[inner, 0:3],
                                  np.minimum(nodes[ref[inner], 0:3], nodes[aux[inner], 0:3]))
    np.testing.assert_array_equal(nodes[inner, 4:7],
                                  np.maximum(nodes[ref[inner], 4:7], nodes[aux[inner], 4:7]))
    node = np.nonzero(leaf)[0]
    box_lo, box_hi = nodes[node, 0:3], nodes[node, 4:7]
    while (node >= 0).any():  # every ancestor holds the leaf's padded box
        up = node >= 0
        assert (nodes[node[up], 0:3] <= box_lo[up]).all()
        assert (nodes[node[up], 4:7] >= box_hi[up]).all()
        node = np.where(up, parent[np.maximum(node, 0)], -1)
    again, _ = TT.pack_chunked(flat, v0, v1, v2, n, ent=ent, rows_per_chunk=rows)
    assert again.nodes.numpy().tobytes() == nodes.tobytes()


def test_hierarchy_deeper_than_the_stack_is_refused():
    """A tree that needs more stack entries than the kernels hold is refused
    at pack time: a chain of inner nodes, each with a leaf on its left, is
    packed at WALK_STACK inner levels and refused at one more."""
    def chain(levels):
        # Preorder: inner node 2i, its leaf 2i + 1, its right child 2i + 2.
        count = np.zeros(2 * levels + 1, np.int64)
        count[1::2] = count[-1] = 1
        miss = np.full(2 * levels + 1, -1)
        miss[1::2] = np.arange(2, 2 * levels + 1, 2)
        flat = types.SimpleNamespace(prim_count=count, prim_start=np.cumsum(count) - count,
                                     miss_link=miss)
        v0 = np.random.default_rng(0).uniform(-1, 1, (levels + 1, 3))
        return flat, v0, v0 + [0.1, 0, 0], v0 + [0, 0.1, 0], np.tile([0.0, 0.0, 1.0], (levels + 1, 1))

    pt, _ = TT.pack_chunked(*chain(TT.WALK_STACK))
    assert pt.nodes.shape[0] == 2 * TT.WALK_STACK + 1
    with pytest.raises(ValueError, match="stack"):
        TT.pack_chunked(*chain(TT.WALK_STACK + 1))


@pytest.mark.parametrize("which,rows", CASES)
def test_walk_emulation_equals_plain(request, which, rows):
    """The kernels' walk, emulated lane by lane (walk()), equals the plain
    versions' brute force bit for bit: closest hit (t, gid, ent) and the
    occluded flag.  Besides the case's own lanes: t_init set to a lane's
    exact hit t (the hit must not count), and t_max to its nearest
    occluder's t.  On the ties table the tie rule must have been taken."""
    _, _, pt, nc, lanes = _case(request, which, rows)
    o, d, excl, t_init, excl_ent, t_max = (torch.from_numpy(np.array(a)) for a in lanes)
    f = TT._slots(pt, nc)
    met, t = TT._row_test(f, o, d, excl, torch.full_like(t_init, float("inf")))
    first = torch.where(met, t, float("inf")).amin(1)  # each lane's nearest hit
    exact = (torch.arange(len(o)) % 5 == 2) & (first < float("inf"))
    t_init = torch.where(exact, first, t_init)
    t_max = torch.where((torch.arange(len(o)) % 5 == 4) & (first < float("inf")), first, t_max)
    want = TT.closest_hit_tris_plain(pt, nc, o, d, excl, t_init)
    occ = TT.occludes_tris_plain(pt, nc, o, d, excl, excl_ent, t_max)
    nodes = pt.nodes.numpy()
    met, t, gid, ent = met.numpy(), t.numpy(), f["gid"].numpy(), f["ent"].numpy()
    o, d = o.numpy(), d.numpy()
    ties = 0
    for i in range(len(o)):
        w = walk(nodes, met[i], t[i], o[i], d[i], t_init[i].item())
        assert w.depth <= TT.WALK_STACK
        ties += w.ties
        got = (np.float32(w.t if w.t < t_init[i].item() else BIG),
               gid[w.pos] if w.pos >= 0 else 0, ent[w.pos] if w.pos >= 0 else 0)
        assert got[0].tobytes() == want[0][i].numpy().tobytes(), i
        assert got[1:] == (want[1][i].item(), want[2][i].item()), i
        w = walk(nodes, met[i], t[i], o[i], d[i], t_max[i].item(), ent=ent,
                 excl_ent=excl_ent[i].item())
        assert (w.t == 0) == occ[i].item(), i
    hits = int((want[0] < BIG).sum())
    assert hits > len(o) // 4 and int(occ.sum()) > len(o) // 8
    assert int(exact.sum()) > 0 and not (want[0][exact] < BIG).any()
    if which == "ties":
        assert ties > 20  # a later row's hit replaced by an earlier row's tie


def test_launch_checks_reject_a_bad_hierarchy(soup):
    """The launch checks refuse a table without a hierarchy and one of the
    wrong dtype, width or alignment."""
    _, pt, nc = _tables(soup, TT.ROWS_PER_CHUNK)
    o, d, excl, t_init, _, _ = (torch.from_numpy(a) for a in soup[2])
    seed = [("t_init", t_init, torch.float32)]
    TT._check_launch(pt, nc, o, d, excl, seed)  # well-formed: no raise
    with pytest.raises(ValueError, match="hierarchy"):
        TT._check_launch(pt._replace(nodes=None), nc, o, d, excl, seed)
    with pytest.raises(TypeError):
        TT._check_launch(pt._replace(nodes=pt.nodes.double()), nc, o, d, excl, seed)
    with pytest.raises(ValueError):
        TT._check_launch(pt._replace(nodes=pt.nodes[:, :6].contiguous()), nc, o, d, excl, seed)
    misaligned = torch.zeros(pt.nodes.numel() + 1)[1:].view(-1, TT.NODE_FLOATS)
    with pytest.raises(ValueError, match="aligned"):
        TT._check_launch(pt._replace(nodes=misaligned), nc, o, d, excl, seed)
