"""Port parity: the packed skip-link BVH table and the plain PyTorch version
of the K6 kernel (ops/packet_traverse.py), held against the reference
package's packer and its Pallas packet walk run in interpret mode (as
tests/test_pallas.py runs it), against brute force with the same row test,
and the port's XLA-walk counterpart (bvh/traverse.py::closest_hit_bvh)
against the reference's.

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

from paths_tpu_torch.bvh import traverse as TBT
from paths_tpu_torch.bvh.build import build_bvh
from paths_tpu_torch.ops import packet_traverse as PK
from paths_tpu_torch.scene import build as TB
from paths_tpu_torch.scene import models as TM
from paths_tpu_torch.scene.ply_loader import load_ply_file
from paths_tpu_torch.scene.types import BvhArrays
from paths_tpu_torch.scene.yaml_loader import load_scene_description

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


def _rays(v0, v1, v2, walk, seed=3):
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
    # distance, which leaves the axis unconstrained.
    leaf_rows = np.nonzero(walk[:, 9] > 0)[0]
    o[900:930, 0] = walk[rng.choice(leaf_rows, 30), 0]
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
    return flat, (v0, v1, v2, n, ents), pt, _rays(v0, v1, v2, pt.walk.numpy())


def _assert_tables_equal(got, want):
    for f in ("nodes", "tris"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_pack_bvh_bit_exact(soup):
    flat, (v0, v1, v2, n, ents), pt, _ = soup
    _assert_tables_equal(pt, JP.pack_bvh(flat, v0, v1, v2, n, ent=ents))
    walk = pt.walk.numpy()
    assert walk.shape == (pt.nodes.shape[0], PK.WALK_FLOATS)
    np.testing.assert_array_equal(walk[:, [3, 7, 8, 9]], pt.nodes.numpy()[:, 6:10])
    lo, hi = pt.nodes.numpy()[:, 0:3], pt.nodes.numpy()[:, 3:6]
    assert (walk[:, 0:3] < lo).all() and (walk[:, 4:7] > hi).all()


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


def _bvh_scene(flat, v0, v1, v2, n, to):
    """What closest_hit_bvh reads of a scene: the BVH and the triangles."""
    arrays = dict(node_min=flat.node_min, node_max=flat.node_max,
                  hit_link=flat.hit_link, miss_link=flat.miss_link,
                  prim_start=flat.prim_start, prim_count=flat.prim_count)
    bvh = types.SimpleNamespace(**{k: to(v) for k, v in arrays.items()})
    if to is torch.from_numpy:
        bvh = BvhArrays(**vars(bvh))
    return types.SimpleNamespace(bvh=bvh, **{
        f"tri_{k}": to(np.asarray(a, np.float32)) for k, a in
        (("v0", v0), ("v1", v1), ("v2", v2), ("n", n))})


def test_closest_hit_bvh_matches_reference(soup):
    """The port's XLA-walk counterpart against the reference's, on the lanes
    not aimed exactly at an edge: equal hits and ids, t to rtol 1e-4.  They
    are not equal bit for bit: XLA contracts the multiply-adds of
    geom/triangle.py::intersect into FMAs and the port's eager PyTorch does
    not.  That moves t by an ulp, which the cancellation in n.v0 - n.o of a
    grazing ray magnifies (1.9e-5 relative at most here), and flips hit or
    miss on rays aimed exactly at an edge, which are left out."""
    flat, (v0, v1, v2, n, _), _, rays = soup
    o, d, excl, t_init = (a[np.arange(N) % 3 != 0] for a in rays)
    kind = np.where(excl >= 0, 2, 0).astype(np.int32)
    jscene = _bvh_scene(flat, v0, v1, v2, n, jnp.asarray)
    jt, ji = JBT.closest_hit_bvh(jscene, *(jnp.asarray(a) for a in (o, d, kind, excl, t_init)))
    tscene = _bvh_scene(flat, v0, v1, v2, n, torch.from_numpy)
    tt, ti = TBT.closest_hit_bvh(tscene, *_torch(o, d, kind, excl, t_init))
    jt, ji, tt, ti = np.asarray(jt), np.asarray(ji), tt.numpy(), ti.numpy()
    np.testing.assert_array_equal(tt < 1e38, jt < 1e38)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tt, jt, rtol=1e-4)
    assert (tt < 1e38).sum() > len(o) // 2


def test_packet_agrees_with_bvh_walk(soup):
    """K6's function and the XLA walk's, on the lanes of the reference's
    own test (tests/test_pallas.py: random origins and directions, 200
    exclusions) and to its bound: equal hits and ids, t to rtol 1e-5.  The
    kernel multiplies by the packed inv_area where the walk divides by the
    area, so they are not one function to the bit."""
    flat, (v0, v1, v2, n, _), pt, _ = soup
    rng = np.random.default_rng(3)
    m = 1500
    o = rng.uniform(-3, 3, (m, 3)).astype(np.float32)
    d = rng.normal(size=(m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = np.full(m, -1, np.int32)
    excl[:200] = rng.integers(0, T, 200)
    t_init = np.full(m, BIG, np.float32)
    kind = np.where(excl >= 0, 2, 0).astype(np.int32)
    tt, ti = TBT.closest_hit_bvh(_bvh_scene(flat, v0, v1, v2, n, torch.from_numpy),
                                 *_torch(o, d, kind, excl, t_init))
    pt_, pi, _ = PK.closest_hit_packet(pt, *_torch(o, d, excl, t_init))
    hit = tt.numpy() < 1e38
    assert hit.sum() > 20
    np.testing.assert_array_equal(pt_.numpy() < 1e38, hit)
    np.testing.assert_array_equal(pi.numpy()[hit], ti.numpy()[hit])
    np.testing.assert_allclose(pt_.numpy()[hit], tt.numpy()[hit], rtol=1e-5)


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
        PK._check_launch(pt._replace(walk=pt.walk[:-1]), o, d, excl, t_init)
    misaligned = torch.zeros(pt.tris.numel() + 1)[1:].view(-1, 128)
    with pytest.raises(ValueError, match="aligned"):
        PK._check_launch(pt._replace(tris=misaligned), o, d, excl, t_init)
    with pytest.raises(ValueError, match="device"):
        PK.closest_hit_packet(pt, *(x.to("meta") for x in (o, d, excl, t_init)))
