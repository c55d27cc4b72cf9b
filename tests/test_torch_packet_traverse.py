"""Port parity: the packed skip-link BVH table and the plain PyTorch version
of the K6 kernel (ops/packet_traverse.py), held against the reference
package's packer and its Pallas packet walk run in interpret mode (as
tests/test_pallas.py runs it), against brute force with the same row test,
and against the reference's XLA walk (paths_tpu/bvh/traverse.py::
closest_hit_bvh), the function the reference's BVH route runs.  The scene
build packs the table on every device, and the BVH route runs K6 there.

The lanes (1,200, below the reference's lane-sort threshold of 8,192, so
its blocks keep lane order): rays aimed inside random triangles and exactly
at their edges (where the row test's fused multiply-adds decide hit or
miss), incoherent rays, rays with a zero direction component (slab
distances of +-inf, and NaN for origins exactly on a padded box plane),
dead lanes (origin 1e30), exclusions, a band of finite t_init and
t_init == 0.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
holds it against the plain version there.
"""

import os
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paths_tpu.bvh import traverse as JBT
from paths_tpu.bvh.build import build_bvh as jax_bvh
from paths_tpu.ops import pallas_traverse as JP

from paths_tpu_torch import integrator as TI
from paths_tpu_torch.bvh.build import build_bvh
from paths_tpu_torch.ops import packet_traverse as PK
from paths_tpu_torch.ops.tri_traverse import WALK_STACK
from paths_tpu_torch.scene import build as TB
from paths_tpu_torch.scene import models as TM
from paths_tpu_torch.scene.ply_loader import load_ply_file
from paths_tpu_torch.scene.stress import generate_mixed_scene
from paths_tpu_torch.scene.yaml_loader import load_scene_description
from test_torch_tri_traverse import _doom
from tri_walk_cases import full_flat, leaf_row_slots, ties_case, walk

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 300
N = 1200
N_ENT = 13
BIG = 3.4e38


def _soup(seed=7):
    """T small triangles in [-1, 1]^3, 24 of them axis-aligned (planes
    z = const and y = const), BVH-ordered by the Python builder."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (T, 3))
    v0, v1, v2 = (c + rng.uniform(-0.15, 0.15, (T, 3)) for _ in range(3))
    v1[:12, 2] = v2[:12, 2] = v0[:12, 2]
    v1[12:24, 1] = v2[12:24, 1] = v0[12:24, 1]
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    flat = jax_bvh(np.minimum(np.minimum(v0, v1), v2),
                   np.maximum(np.maximum(v0, v1), v2),
                   leaf_size=JP.PACK_LEAF, use_native=False)
    o = flat.order
    return flat, v0[o], v1[o], v2[o], n[o], (np.arange(T) % N_ENT).astype(np.int64)


def _rays(v0, v1, v2, walk, tree, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (N, 3))
    k = rng.integers(0, T, N)
    w = rng.dirichlet((1, 1, 1), N)
    edge = np.arange(N) % 3 == 0  # a third aimed exactly at an edge
    w[edge, rng.integers(0, 3, int(edge.sum()))] = 0.0
    w /= w.sum(1, keepdims=True)
    target = w[:, :1] * v0[k] + w[:, 1:2] * v1[k] + w[:, 2:] * v2[k]
    # A zero direction component (slab distances of +-inf): the origin
    # moved into the target's plane x = const (y = const).
    o[900:960, 0] = target[900:960, 0]
    o[960:1000, 1] = target[960:1000, 1]
    d = target - o
    d[1::7] = rng.normal(size=d[1::7].shape)  # incoherent
    d[900:960, 0] = 0.0
    d[960:1000, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    # Origins exactly on a padded box plane with d.x == 0: a NaN slab
    # distance, which leaves the axis unconstrained.  The plain version's
    # boxes (each node's own, padded) and the kernel's tree's (each leaf's
    # triangles', padded, and their unions) differ.
    leaf_rows = np.nonzero(walk[:, 9] > 0)[0]
    o[900:915, 0] = walk[rng.choice(leaf_rows, 15), 0]
    o[915:930, 0] = tree[rng.choice(len(tree), 15), 0]
    o[400:460] = 1e30  # dead lanes
    excl = np.full(N, -1, np.int32)
    excl[:200] = rng.integers(0, T, 200)
    excl[200:260] = k[200:260]  # the aimed-at triangle itself
    t_init = np.full(N, BIG, np.float32)
    t_init[600:800] = rng.uniform(0.5, 4.0, 200).astype(np.float32)
    t_init[800:830] = 0.0
    return o, d, excl, t_init


@pytest.fixture(scope="module")
def soup():
    flat, v0, v1, v2, n, ents = _soup()
    pt = PK.pack_bvh(flat, v0, v1, v2, n, ent=ents)
    return flat, (v0, v1, v2, n, ents), pt, _rays(v0, v1, v2, PK.walk_nodes(pt.nodes).numpy(),
                                                  pt.tree.numpy())


def _assert_tables_equal(got, want):
    for f in ("nodes", "tris"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_pack_bvh_bit_exact(soup):
    """The reference's tables, bit for bit; the kernel's tree has a node
    for each of the BVH's, in the same order, with the BVH's children and
    each leaf's row and count, and its boxes hold the BVH's own."""
    flat, (v0, v1, v2, n, ents), pt, _ = soup
    _assert_tables_equal(pt, JP.pack_bvh(flat, v0, v1, v2, n, ent=ents))
    tree, nodes = pt.tree.numpy(), pt.nodes.numpy()
    m = len(flat.prim_count)
    assert tree.shape == (m, PK.NODE_FLOATS) and nodes.shape[0] >= m
    leaf = flat.prim_count > 0
    np.testing.assert_array_equal(-1 - tree[:m][leaf, 3], nodes[:m][leaf, 8])
    np.testing.assert_array_equal(tree[:m][leaf, 7], flat.prim_count[leaf])
    inner = np.nonzero(~leaf)[0]
    np.testing.assert_array_equal(tree[inner, 3], flat.hit_link[inner])
    np.testing.assert_array_equal(tree[inner, 7], flat.miss_link[inner + 1])
    lo, hi = nodes[:m, 0:3], nodes[:m, 3:6]
    assert (tree[:m, 0:3] < lo).all() and (tree[:m, 4:7] > hi).all()


def test_pack_bvh_doom_bit_exact():
    """doom_standin's 95,922 triangles, BVH-ordered by the C++ builder."""
    sd = load_scene_description(os.path.join(REPO, "scenes", "doom_standin.yml"))
    ply = load_ply_file(os.path.join(REPO, "scenes", "assets", "doom_standin.ply"))
    tri = TB._mesh_triangles(sd.objects[0].mesh, TM.Model(ply.vertices, ply.faces), ent=0)
    flat = build_bvh(np.minimum(np.minimum(tri["v0"], tri["v1"]), tri["v2"]),
                     np.maximum(np.maximum(tri["v0"], tri["v1"]), tri["v2"]),
                     leaf_size=PK.PACK_LEAF)
    v = [tri[k][flat.order] for k in ("v0", "v1", "v2", "n")]
    ent = np.arange(len(v[0])) % 5
    got = PK.pack_bvh(flat, *v, ent=ent)
    _assert_tables_equal(got, JP.pack_bvh(flat, *v, ent=ent))
    assert got.tris.shape[0] >= -(-len(v[0]) // PK.PACK_LEAF)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _brute(pt, o, d, excl, t_init):
    """Every slot of the table in table order with the plain version's row
    test, the first qualifying slot winning a tie; dead lanes miss."""
    slots = pt.tris.reshape(-1, PK.TRI_STRIDE)
    ok, t = PK._row_test(slots[None], o[:, None], d[:, None], excl[:, None],
                         t_init[:, None])
    ok &= ~(o[:, 0:1] > 1e29)
    tm = torch.where(ok, t, float("inf"))
    arg = torch.argmin(tm, dim=1)
    tmin = torch.gather(tm, 1, arg[:, None])[:, 0]
    found = tmin < float("inf")
    zero = torch.zeros((), dtype=torch.int32)
    return (torch.where(found, tmin, torch.tensor(BIG, dtype=torch.float32)),
            torch.where(found, slots[arg, 12].to(torch.int32), zero),
            torch.where(found, slots[arg, 14].to(torch.int32), zero))


def test_plain_matches_reference_kernel(soup):
    flat, (v0, v1, v2, n, ents), pt, rays = soup
    jpt = JP.pack_bvh(flat, v0, v1, v2, n, ent=ents)
    want = JP.closest_hit_packet(jpt, *(jnp.asarray(a) for a in rays), interpret=True)
    got = PK.closest_hit_packet(pt, *_torch(*rays))
    for g, w, name in zip(got, want, ("t", "gid", "ent")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    t = got[0].numpy()
    assert (t < 1e38).sum() > N // 2  # the rays really hit triangles
    assert (t[400:460] >= 1e38).all() and (t[800:830] >= 1e38).all()
    assert (t[930:1000] < 1e38).sum() > 40  # zero direction components hit


def test_plain_equals_brute_force(soup):
    _, _, pt, rays = soup
    rays = _torch(*rays)
    for g, w, name in zip(PK.closest_hit_packet(pt, *rays), _brute(pt, *rays),
                          ("t", "gid", "ent")):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


def test_plain_needs_the_contracted_fmas(soup, monkeypatch):
    """Without the fused multiply-adds the plain version no longer matches:
    the FMAs are part of the contract, not noise."""
    _, _, pt, rays = soup
    rays = _torch(*rays)
    exact = PK.closest_hit_packet(pt, *rays)
    monkeypatch.setattr(PK, "_fma", lambda a, b, c: a * b + c)
    rounded = PK.closest_hit_packet(pt, *rays)
    assert int((rounded[0] != exact[0]).sum()) > 100


def test_plain_matches_reference_bvh_walk(soup):
    """The plain K6 against the reference's XLA walk
    (paths_tpu/bvh/traverse.py::closest_hit_bvh, its BVH route's query) on
    the lanes not aimed exactly at an edge: equal hits and ids, t to rtol
    1e-4.  They are not one function to the bit: the reference's
    geom/triangle.py::intersect divides by the area where K6 multiplies by
    the packed inv_area, and XLA contracts its multiply-adds differently.
    That moves t by an ulp, which the cancellation in n.v0 - n.o of a
    grazing ray magnifies, and flips hit or miss on rays aimed exactly at
    an edge, which are left out."""
    flat, (v0, v1, v2, n, _), pt, rays = soup
    o, d, excl, t_init = (a[np.arange(N) % 3 != 0] for a in rays)
    kind = np.where(excl >= 0, 2, 0).astype(np.int32)
    bvh = types.SimpleNamespace(**{f: jnp.asarray(getattr(flat, f)) for f in (
        "node_min", "node_max", "hit_link", "miss_link", "prim_start", "prim_count")})
    jscene = types.SimpleNamespace(bvh=bvh, **{
        f"tri_{k}": jnp.asarray(np.asarray(a, np.float32)) for k, a in
        (("v0", v0), ("v1", v1), ("v2", v2), ("n", n))})
    jt, ji = JBT.closest_hit_bvh(jscene, *(jnp.asarray(a) for a in (o, d, kind, excl, t_init)))
    tt, ti, _ = PK.closest_hit_packet(pt, *_torch(o, d, excl, t_init))
    jt, ji, tt, ti = np.asarray(jt), np.asarray(ji), tt.numpy(), ti.numpy()
    np.testing.assert_array_equal(tt < 1e38, jt < 1e38)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tt, jt, rtol=1e-4)
    assert (tt < 1e38).sum() > len(o) // 2


def test_bvh_route_packs_and_runs_the_packet_path(tmp_path, monkeypatch):
    """build_scene(..., device="cpu", bvh_threshold=64) packs the K6 table
    on the CPU, bit-equal to a fresh pack_bvh of the BVH and triangles it
    built, and the BVH route's closest-hit query runs K6's plain version
    there (its calls counted) and nothing else of the triangles'."""
    packed = []
    pack = PK.pack_bvh

    def spy(*args, **kw):
        packed.append((args, kw))
        return pack(*args, **kw)

    monkeypatch.setattr(PK, "pack_bvh", spy)
    static, scene, cam = TB.build_scene(generate_mixed_scene(str(tmp_path), n_spheres=8),
                                        device="cpu", bvh_threshold=64)
    assert static.use_bvh and static.tri_chunks == 0 and scene.ptris is None
    assert len(packed) == 1
    args, kw = packed[0]
    fresh = pack(*args, **kw)
    for f in PK.PackedBvh._fields:
        g, w = getattr(scene.pbvh, f), getattr(fresh, f)
        assert g.device.type == "cpu" and g.numpy().tobytes() == w.numpy().tobytes(), f
    flat = args[0]
    np.testing.assert_array_equal(scene.tri_v0.numpy(),
                                  np.asarray(args[1], np.float32))  # the BVH's order
    assert len(flat.prim_count) == scene.pbvh.tree.shape[0]

    calls = {"plain": 0}
    plain = PK.closest_hit_packet_plain

    def count(*a):
        calls["plain"] += 1
        return plain(*a)

    monkeypatch.setattr(PK, "closest_hit_packet_plain", count)
    monkeypatch.setattr(TI, "_scan_tris", lambda *a: pytest.fail("the scan ran"))
    o = torch.tensor([[0.0, 1.0, 4.0]] * 64) + torch.randn(64, 3) * 0.1
    d = torch.tensor([[0.0, -0.2, -1.0]]).expand(64, 3).contiguous()
    d = d / d.norm(dim=1, keepdim=True)
    none = torch.zeros(64, dtype=torch.int32)
    TI.intersect_brief(static, scene, o, d, none, none)
    assert calls["plain"] == 1


def test_launch_checks_reject_bad_inputs(soup):
    """The checks a CUDA launch runs first: dtype, shape, contiguity and
    the tables' alignment; and a device other than the CPU or CUDA."""
    _, _, pt, rays = soup
    o, d, excl, t_init = _torch(*rays)
    PK._check_launch(pt, o, d, excl, t_init)  # well-formed: no raise
    with pytest.raises(TypeError):
        PK._check_launch(pt, o, d, excl.long(), t_init)
    with pytest.raises(TypeError):
        PK._check_launch(pt, o.double(), d, excl, t_init)
    with pytest.raises(ValueError):
        PK._check_launch(pt, o[:, :2], d, excl, t_init)
    with pytest.raises(ValueError):
        PK._check_launch(pt, o, d.t().contiguous().t(), excl, t_init)
    with pytest.raises(ValueError):
        PK._check_launch(pt, o, d, excl, t_init[:-1])
    with pytest.raises(ValueError):
        PK._check_launch(pt._replace(tree=pt.tree[:, :6].contiguous()), o, d, excl, t_init)
    with pytest.raises(TypeError):
        PK._check_launch(pt._replace(tree=pt.tree.double()), o, d, excl, t_init)
    misaligned = torch.zeros(pt.tree.numel() + 1)[1:].view(-1, PK.NODE_FLOATS)
    with pytest.raises(ValueError, match="aligned"):
        PK._check_launch(pt._replace(tree=misaligned), o, d, excl, t_init)
    misaligned = torch.zeros(pt.tris.numel() + 1)[1:].view(-1, 128)
    with pytest.raises(ValueError, match="aligned"):
        PK._check_launch(pt._replace(tris=misaligned), o, d, excl, t_init)
    with pytest.raises(ValueError, match="device"):
        PK.closest_hit_packet(pt, *(x.to("meta") for x in (o, d, excl, t_init)))


# ---------------------------------------------------------------- the tree

# The kernel walks PackedBvh.tree front to back through csrc/walk.cuh; the
# tests below hold the tree's boxes and shape, and the Python emulation of
# that walk (tests/tri_walk_cases.py::walk over leaf rows, the same stack,
# pruning and tie rule, in f32) against the plain version (the skip-link
# walk), bit for bit: on the soup, on doom_standin, and on tables of
# duplicated triangles in different leaves whose ties are exact.

def _tree_case(request, which):
    """(flat, (v0, v1, v2, n, ent), PackedBvh, lanes (o, d, excl, t_init))."""
    if which == "soup":
        flat, tris, pt, lanes = request.getfixturevalue("soup")
        return flat, tris, pt, lanes
    if which == "doom":
        (flat, v0, v1, v2, n, ent), lanes = _doom()
        o, d, excl, t_init = lanes[:4]
        t_init = np.where(np.arange(len(o)) % 7 == 4, 150.0, t_init).astype(np.float32)
        lanes = (o, d, excl, t_init)
    else:
        (flat, v0, v1, v2, n, ent), lanes = ties_case(int(which[4:]), N_ENT)
        flat = full_flat(flat, v0, v1, v2)
        lanes = lanes[:4]
    return flat, (v0, v1, v2, n, ent), PK.pack_bvh(flat, v0, v1, v2, n, ent=ent), lanes


TREE_CASES = ["soup", "doom", "ties8", "ties20"]


def _slot_tests(pt, o, d, excl, step=8):
    """Each table position's row-test outcome (met: passes with gid !=
    excl, any t) and t, for the lanes (o, d, excl), as numpy."""
    slots = pt.tris.reshape(-1, PK.TRI_STRIDE)
    met, t = [], []
    for a in range(0, len(o), step):
        ok, tt = PK._row_test(slots[None], o[a:a + step, None], d[a:a + step, None],
                              excl[a:a + step, None], torch.full((len(o[a:a + step]), 1), float("inf")))
        met.append(ok.numpy())
        t.append(tt.numpy())
    return np.concatenate(met), np.concatenate(t)


@pytest.mark.parametrize("which", TREE_CASES)
def test_tree_holds_its_leaves(request, which):
    """The kernel's tree: one node per BVH node in preorder, an inner node's
    left child the next node and its right child the left child's miss
    link; every leaf row exactly once, in ascending order in preorder (the
    table's order is the preorder of its slots), with its triangle count;
    a leaf's box its triangles' f32 box padded by the kernel's rule, an
    inner node's the union of its children's, so every ancestor holds the
    padded box of each leaf below it; depth within the walk's stack."""
    flat, (v0, v1, v2, n, ent), pt, _ = _tree_case(request, which)
    tree = pt.tree.numpy()
    ref, aux = tree[:, 3].astype(np.int64), tree[:, 7].astype(np.int64)
    leaf = ref < 0
    np.testing.assert_array_equal(leaf, flat.prim_count > 0)
    np.testing.assert_array_equal(-1 - ref[leaf], np.arange(int(leaf.sum())))
    np.testing.assert_array_equal(aux[leaf], flat.prim_count[leaf])
    starts = flat.prim_start[leaf]
    np.testing.assert_array_equal(starts[1:], (starts + flat.prim_count[leaf])[:-1])
    inner = np.nonzero(~leaf)[0]
    np.testing.assert_array_equal(ref[inner], inner + 1)
    np.testing.assert_array_equal(aux[inner], flat.miss_link[inner + 1])
    parent = np.full(len(tree), -1)
    parent[ref[inner]] = parent[aux[inner]] = inner
    assert (parent[1:] >= 0).all() and parent[0] == -1
    depth = np.zeros(len(tree), np.int64)
    for i in range(1, len(tree)):
        depth[i] = depth[parent[i]] + 1
    assert depth.max() <= WALK_STACK

    rows = PK._leaf_map(flat, len(v0))[0]
    tlo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    thi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    rlo = np.full((int(leaf.sum()), 3), np.inf, np.float32)
    rhi = np.full((int(leaf.sum()), 3), -np.inf, np.float32)
    np.minimum.at(rlo, rows, tlo)
    np.maximum.at(rhi, rows, thi)
    pad = np.float32(PK.BOX_PAD) * (np.abs(rlo) + np.abs(rhi) + (rhi - rlo)) + np.float32(1e-6)
    np.testing.assert_array_equal(tree[leaf, 0:3], rlo - pad)
    np.testing.assert_array_equal(tree[leaf, 4:7], rhi + pad)
    np.testing.assert_array_equal(tree[inner, 0:3],
                                  np.minimum(tree[ref[inner], 0:3], tree[aux[inner], 0:3]))
    np.testing.assert_array_equal(tree[inner, 4:7],
                                  np.maximum(tree[ref[inner], 4:7], tree[aux[inner], 4:7]))
    node = np.nonzero(leaf)[0]
    box_lo, box_hi = tree[node, 0:3], tree[node, 4:7]
    while (node >= 0).any():  # every ancestor holds the leaf's padded box
        up = node >= 0
        assert (tree[node[up], 0:3] <= box_lo[up]).all()
        assert (tree[node[up], 4:7] >= box_hi[up]).all()
        node = np.where(up, parent[np.maximum(node, 0)], -1)


def test_pack_bvh_refuses_leaves_out_of_order(soup):
    """pack_bvh checks that the leaves, in preorder, cover the triangles in
    ascending ranges: two leaves' ranges swapped are refused."""
    flat, (v0, v1, v2, n, ents), _, _ = soup
    leaves = np.nonzero(flat.prim_count > 0)[0]
    a, b = leaves[0], leaves[1]
    start = flat.prim_start.copy()
    start[a], start[b] = start[b], start[a]
    bad = types.SimpleNamespace(**{**vars(flat), "prim_start": start}) \
        if hasattr(flat, "__dict__") else flat._replace(prim_start=start)
    with pytest.raises(ValueError, match="ascending"):
        PK.pack_bvh(bad, v0, v1, v2, n, ent=ents)


def test_pack_bvh_refuses_a_tree_deeper_than_the_stack():
    """A chain of inner nodes, each with a one-triangle leaf on its left,
    is packed at WALK_STACK inner levels and refused at one more."""
    def chain(levels):
        count = np.zeros(2 * levels + 1, np.int64)
        count[1::2] = count[-1] = 1
        miss = np.full(2 * levels + 1, -1)
        miss[1::2] = np.arange(2, 2 * levels + 1, 2)
        flat = types.SimpleNamespace(prim_count=count, prim_start=np.cumsum(count) - count,
                                     miss_link=miss)
        v0 = np.random.default_rng(0).uniform(-1, 1, (levels + 1, 3))
        v1, v2 = v0 + [0.1, 0, 0], v0 + [0, 0.1, 0]
        return full_flat(flat, v0, v1, v2), v0, v1, v2, np.tile([0.0, 0.0, 1.0], (levels + 1, 1))

    assert PK.pack_bvh(*chain(WALK_STACK)).tree.shape[0] == 2 * WALK_STACK + 1
    with pytest.raises(ValueError, match="stack"):
        PK.pack_bvh(*chain(WALK_STACK + 1))


@pytest.mark.parametrize("which", TREE_CASES)
def test_walk_emulation_equals_plain(request, which):
    """The kernel's walk, emulated lane by lane (walk() over leaf rows),
    equals the plain version bit for bit: t, gid and ent.  Besides the
    case's own lanes, t_init set to a lane's exact nearest hit on every
    fifth (the hit must not count).  On the duplicated triangles the tie
    rule must have been taken: a later slot found first, then replaced by
    an earlier one at the same t."""
    _, _, pt, lanes = _tree_case(request, which)
    o, d, excl, t_init = (torch.from_numpy(np.array(a)) for a in lanes)
    met, t = _slot_tests(pt, o, d, excl)
    live = ~(o[:, 0] > 1e29).numpy()
    first = torch.from_numpy(np.where(met & live[:, None], t, np.inf).min(1))
    exact = (torch.arange(len(o)) % 5 == 2) & (first < float("inf"))
    t_init = torch.where(exact, first, t_init)
    want = PK.closest_hit_packet(pt, o, d, excl, t_init)
    slots = pt.tris.reshape(-1, PK.TRI_STRIDE).numpy()
    gid, ent = slots[:, 12].astype(np.int32), slots[:, 14].astype(np.int32)
    tree, ties = pt.tree.numpy(), 0
    for i in range(len(o)):
        w = walk(tree, met[i], t[i], o[i].numpy(), d[i].numpy(), t_init[i].item(),
                 leaf=leaf_row_slots)
        assert w.depth <= WALK_STACK
        ties += w.ties
        got = (np.float32(w.t if w.t < t_init[i].item() else BIG),
               gid[w.pos] if w.pos >= 0 else 0, ent[w.pos] if w.pos >= 0 else 0)
        assert got[0].tobytes() == want[0][i].numpy().tobytes(), i
        assert got[1:] == (want[1][i].item(), want[2][i].item()), i
    assert int((want[0] < BIG).sum()) > len(o) // 4
    assert int(exact.sum()) > 0 and not (want[0][exact] < BIG).any()
    if which.startswith("ties"):
        assert ties > 20
