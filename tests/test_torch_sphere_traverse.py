"""Port parity: the packed small-sphere table and the plain PyTorch versions
of the closest-hit (K1) and any-hit (K2) sphere traversal kernels, held
against the reference package's packer and its Pallas sorted-walk kernels
run in interpret mode (as tests/test_sorted_traverse.py runs them).

Packing is bit-exact (rows and meta; the tree over the slots is the
port's own).  The plain versions are flat brute force over every slot; the
sorted walk visits a conservative superset of the chunks a lane can hit,
so t, gid, ent and the occluded flag must be equal exactly.

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

from paths_tpu_torch import camera as TC
from paths_tpu_torch import render as TR
from paths_tpu_torch.ops import sphere_traverse as ST
from paths_tpu_torch.scene import build as TB
from paths_tpu_torch.scene.stress import generate_stress_scene
from tri_walk_cases import BIG, slot_range, sphere_ties_case, walk

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


# ---------------------------------------------------------------- the tree

# The closest-hit kernel (K1) walks a tree over the morton-ordered slots
# (PackedSpheres.nodes) front to back through csrc/walk.cuh, and the any-hit
# kernel (K2) walks it to its first occluder; the tests below
# hold the tree's boxes and shape, and the Python emulation of that walk
# (tests/tri_walk_cases.py::walk, the same stack, pruning and tie rule, in
# f32) against the plain version, bit for bit: on the 40 spheres above, on
# stress-500 (primary and incoherent lanes, zero direction components with
# origins on the tree's box planes, t_init at exact hit distances) and on
# spheres that share a pole (exact ties between leaves).

def _stress_case(n_lanes=160, seed=5):
    """stress-500's spheres as the scene build packs them (f64 centres and
    radii) and lanes: primary camera rays, incoherent rays from inside the
    spheres' box, rays along an axis from a plane of the tree's boxes,
    dead lanes, exclusions, finite t_init."""
    sd = generate_stress_scene(500)
    c = np.array([o.sphere.center.tolist() for o in sd.objects])
    r = np.array([o.sphere.radius for o in sd.objects])
    ent = np.arange(len(r)) % 7
    ps, _, _ = ST.pack_spheres_chunked(c, r, ent=ent)
    rng = np.random.default_rng(seed)
    static, _, cam = TB.build_scene(sd, device="cpu")
    cam = TC.resize(cam, 720, 480)
    pix = torch.as_tensor(rng.integers(0, 720 * 480, n_lanes))
    o, d, _ = TR.gen_camera_rays(cam, (pix % 720).int(), (pix // 720).int(), pix,
                                 torch.zeros_like(pix), 0)
    o, d = o.numpy().astype(np.float32), d.numpy().astype(np.float32)
    inc = np.arange(n_lanes) % 3 == 1
    o[inc] = rng.uniform([-50, -50, 0], [50, 50, 100], (int(inc.sum()), 3))
    g = rng.normal(size=(int(inc.sum()), 3))
    d[inc] = g / np.linalg.norm(g, axis=1, keepdims=True)
    axis = np.arange(n_lanes) % 6 == 2  # along an axis, from a box plane
    ax = rng.integers(0, 3, int(axis.sum()))
    nodes = ps.nodes.numpy()
    pick = rng.integers(0, len(nodes), int(axis.sum()))
    o[axis] = rng.uniform([-50, -50, 0], [50, 50, 100], (int(axis.sum()), 3))
    o[np.nonzero(axis)[0], (ax + 1) % 3] = nodes[pick, (ax + 1) % 3]  # a box's lo
    d[axis] = 0.0
    d[np.nonzero(axis)[0], ax] = rng.choice([-1.0, 1.0], int(axis.sum()))
    o, d = o.astype(np.float32), d.astype(np.float32)
    o[7::23] = 1e30  # dead lanes
    excl = np.where(rng.uniform(size=n_lanes) < 0.2, rng.integers(0, len(r), n_lanes),
                    -1).astype(np.int32)
    t_init = np.where(rng.uniform(size=n_lanes) < 0.8, 3.4e38,
                      rng.uniform(1, 80, n_lanes)).astype(np.float32)
    return ps, (o, d, excl, t_init)


def _tree_case(which):
    """(PackedSpheres, lanes (o, d, excl, t_init)) of one case."""
    if which == "spheres40":
        centers, radii, ents = _spheres()
        ps, _, _ = ST.pack_spheres_chunked(centers, radii, ent=ents, gid0=3)
        return ps, _rays()
    if which == "stress500":
        return _stress_case()
    (c, r, ent), lanes = sphere_ties_case()
    ps, _, _ = ST.pack_spheres_chunked(c, r, ent=ent)
    return ps, lanes[:4]


TREE_CASES = ["spheres40", "stress500", "pole_pairs"]


@pytest.mark.parametrize("which", TREE_CASES)
def test_slot_tree_holds_its_slots(which):
    """The tree over the slots: preorder, each inner node's left child the
    next node and its right child after the left subtree; every sphere slot
    in exactly one leaf, leaves in slot order, at most SPH_LEAF slots each;
    a leaf's box its spheres' f32 boxes padded by the kernel's rule, an
    inner node's the union of its children's, so every ancestor holds the
    padded box of each sphere below it; depth within the walk's stack; and
    packing again gives the same bytes."""
    ps, _ = _tree_case(which)
    nodes = ps.nodes.numpy()
    ref, aux = nodes[:, 3].astype(np.int64), nodes[:, 7].astype(np.int64)
    leaf = ref < 0
    first, count = -1 - ref[leaf], aux[leaf]
    n_slots = int((ps.tris.numpy().reshape(-1, ST.SPH_STRIDE)[:, 4] >= 0).sum())
    np.testing.assert_array_equal(first, np.concatenate([[0], np.cumsum(count)[:-1]]))
    assert count.sum() == n_slots and (count >= 1).all() and (count <= ST.SPH_LEAF).all()
    inner = np.nonzero(~leaf)[0]
    np.testing.assert_array_equal(ref[inner], inner + 1)
    assert (aux[inner] > inner + 1).all()
    parent = np.full(len(nodes), -1)
    parent[ref[inner]] = parent[aux[inner]] = inner
    assert (parent[1:] >= 0).all() and parent[0] == -1
    depth = np.zeros(len(nodes), np.int64)
    for i in range(1, len(nodes)):  # parents precede children in preorder
        depth[i] = depth[parent[i]] + 1
    assert depth.max() <= ST.WALK_STACK

    slots = ps.tris.numpy().reshape(-1, ST.SPH_STRIDE)[:n_slots]
    rad = np.sqrt(slots[:, 3].astype(np.float64))
    for i in np.nonzero(leaf)[0]:
        s = slots[-1 - ref[i]: -1 - ref[i] + aux[i]]
        # The f32 box of the f32 spheres, up to the rounding of r from r^2,
        # lies inside the leaf's box; the leaf's box is no looser than the
        # pad rule on that box allows.
        lo = (s[:, 0:3] - rad[-1 - ref[i]: -1 - ref[i] + aux[i], None] * (1 + 1e-6)).min(0)
        hi = (s[:, 0:3] + rad[-1 - ref[i]: -1 - ref[i] + aux[i], None] * (1 + 1e-6)).max(0)
        assert (nodes[i, 0:3] < lo).all() and (nodes[i, 4:7] > hi).all()
        pad = 2e-4 * (np.abs(lo) + np.abs(hi) + (hi - lo)) + 2e-6
        assert (nodes[i, 0:3] > lo - pad).all() and (nodes[i, 4:7] < hi + pad).all()
    np.testing.assert_array_equal(nodes[inner, 0:3],
                                  np.minimum(nodes[ref[inner], 0:3], nodes[aux[inner], 0:3]))
    np.testing.assert_array_equal(nodes[inner, 4:7],
                                  np.maximum(nodes[ref[inner], 4:7], nodes[aux[inner], 4:7]))
    if which == "spheres40":
        centers, radii, ents = _spheres()
        again = ST.pack_spheres_chunked(centers, radii, ent=ents, gid0=3)[0]
        assert again.nodes.numpy().tobytes() == nodes.tobytes()


def test_slot_tree_deeper_than_the_stack_is_refused():
    """A range whose codes peel one slot a level (0, 1, 2, 4, 8, ...) is a
    chain: built at WALK_STACK inner levels, refused at one more."""
    def chain(levels):
        codes = np.array([0] + [2 ** i for i in range(levels)], dtype=object)
        box = np.zeros((levels + 1, 3), np.float32)
        return box, box + 1, codes

    nodes = ST._slot_tree(*chain(ST.WALK_STACK), leaf=1)
    assert nodes.shape[0] == 2 * ST.WALK_STACK + 1
    with pytest.raises(ValueError, match="stack"):
        ST._slot_tree(*chain(ST.WALK_STACK + 1), leaf=1)


@pytest.mark.parametrize("which", TREE_CASES)
def test_walk_emulation_equals_plain(which):
    """K1's walk, emulated lane by lane (walk() over slot ranges), equals
    the plain version's first-index argmin bit for bit: t, gid and ent.
    Besides the case's own lanes, t_init set to a lane's exact nearest hit
    on every fifth (the hit must not count).  On the pole pairs the tie
    rule must have been taken: a later slot found first, then replaced by
    an earlier one at the same t."""
    ps, lanes = _tree_case(which)
    o, d, excl, t_init = (torch.from_numpy(np.array(a)) for a in lanes)
    fields = ST._slot_fields(ps.tris)
    met, t = ST._row_test(fields, o, d, excl, torch.full_like(t_init, float("inf")))
    first = torch.where(met, t, float("inf")).amin(1)
    exact = (torch.arange(len(o)) % 5 == 2) & (first < float("inf"))
    t_init = torch.where(exact, first, t_init)
    want = ST.closest_hit_spheres_plain(ps.tris, o, d, excl, t_init)
    nodes, met, t = ps.nodes.numpy(), met.numpy(), t.numpy()
    gid, ent = fields[4].numpy(), fields[5].numpy()
    ties = 0
    for i in range(len(o)):
        w = walk(nodes, met[i], t[i], o[i].numpy(), d[i].numpy(), t_init[i].item(),
                 leaf=slot_range)
        assert w.depth <= ST.WALK_STACK
        ties += w.ties
        got = (np.float32(w.t if w.t < t_init[i].item() else BIG),
               gid[w.pos] if w.pos >= 0 else 0, ent[w.pos] if w.pos >= 0 else 0)
        assert got[0].tobytes() == want[0][i].numpy().tobytes(), i
        assert got[1:] == (want[1][i].item(), want[2][i].item()), i
    assert int((want[0] < BIG).sum()) > len(o) // 8
    assert int(exact.sum()) > 0 and not (want[0][exact] < BIG).any()
    if which == "pole_pairs":
        assert ties > 10


def _any_hit_seeds(which, ps, o, d, excl, rng):
    """excl_ent and t_max for a case's lanes: random entities, t_max random
    (half BIG), every fifth lane's t_max at its exact nearest occluder (not
    occluded: the test is strict), every seventh 0 (occluded)."""
    fields = ST._slot_fields(ps.tris)
    n_ent = int(fields[5].max()) + 1
    if which == "pole_pairs":
        excl_ent, t_max = (torch.from_numpy(a) for a in sphere_ties_case()[1][4:])
    else:
        scale = {"spheres40": 8.0, "stress500": 150.0}[which]
        excl_ent = torch.from_numpy(rng.integers(-1, n_ent, len(o)).astype(np.int32))
        t_max = torch.from_numpy(np.where(rng.uniform(size=len(o)) < 0.5, BIG,
                                          rng.uniform(0, scale, len(o))).astype(np.float32))
    met, t = ST._row_test(fields, o, d, excl, torch.full_like(t_max, float("inf")))
    met &= fields[5] != excl_ent[:, None]
    near = torch.where(met, t, float("inf")).amin(1)
    lane = torch.arange(len(o))
    zero = lane % 7 == 3
    exact = (lane % 5 == 1) & (near < float("inf")) & ~zero
    t_max = torch.where(exact, near, torch.where(zero, 0.0, t_max))
    return excl_ent, t_max, exact


@pytest.mark.parametrize("which", TREE_CASES)
def test_any_hit_walk_emulation_equals_plain(which):
    """K2's walk, emulated lane by lane (walk() over slot ranges, the any-hit
    form: pruned against t_max, ended by the first occluder), equals the
    plain version bit for bit.  Among the lanes: t_max at the lane's exact
    nearest occluder (not occluded), t_max == 0 (occluded, dead or not) and
    dead lanes (not occluded unless t_max == 0)."""
    ps, lanes = _tree_case(which)
    o, d, excl, _ = (torch.from_numpy(np.array(a)) for a in lanes)
    excl_ent, t_max, exact = _any_hit_seeds(which, ps, o, d, excl,
                                            np.random.default_rng(17))
    want = ST.occludes_spheres_plain(ps.tris, o, d, excl, excl_ent, t_max)
    fields = ST._slot_fields(ps.tris)
    met, t = ST._row_test(fields, o, d, excl, torch.full_like(t_max, float("inf")))
    nodes, met, t, ent = ps.nodes.numpy(), met.numpy(), t.numpy(), fields[5].numpy()
    for i in range(len(o)):
        w = walk(nodes, met[i], t[i], o[i].numpy(), d[i].numpy(), t_max[i].item(),
                 ent=ent, excl_ent=excl_ent[i].item(), leaf=slot_range)
        assert w.depth <= ST.WALK_STACK
        assert bool(w.t == 0) == bool(want[i]), i
    dead = o[:, 0] > 1e29
    zero = t_max == 0
    assert int(exact.sum()) > 0 and not want[exact].any()
    assert want[zero].all() and int((dead & zero).sum()) > 0
    assert int((dead & ~zero).sum()) > 0 and not want[dead & ~zero].any()
    assert int(want[~zero].sum()) > len(o) // 10


def test_launch_checks_reject_a_bad_tree(packed):
    """The closest-hit kernel refuses a table without a tree and one of the
    wrong dtype, width or alignment."""
    _, (tps, _, _) = packed
    ST._check_nodes(tps, tps.tris.device)  # well-formed: no raise
    with pytest.raises(ValueError, match="tree"):
        ST._check_nodes(tps._replace(nodes=None), tps.tris.device)
    with pytest.raises(TypeError):
        ST._check_nodes(tps._replace(nodes=tps.nodes.double()), tps.tris.device)
    with pytest.raises(ValueError):
        ST._check_nodes(tps._replace(nodes=tps.nodes[:, :6].contiguous()), tps.tris.device)
    misaligned = torch.zeros(tps.nodes.numel() + 1)[1:].view(-1, ST.NODE_FLOATS)
    with pytest.raises(ValueError, match="aligned"):
        ST._check_nodes(tps._replace(nodes=misaligned), tps.tris.device)
