"""The walk kernels (csrc/walk.cuh: K1, K3/K4 and K6) emulated in Python,
and a table and lanes that stress their tie and bound rules.  Shared by
tests/test_torch_tri_traverse.py, tests/test_torch_sphere_traverse.py and
tests/test_torch_packet_traverse.py (the emulation against the plain
versions on the CPU), tests/test_torch_cuda.py (the kernels on the card)
and scripts/tri_hierarchy_shapes.py and scripts/sphere_hierarchy_shapes.py
(the emulation's counts).  Imports no JAX."""

import types
from typing import NamedTuple

import numpy as np

from paths_tpu_torch.ops import tri_traverse as TT

BIG = np.float32(3.4e38)


class Walk(NamedTuple):
    t: np.float32  # t_best at the end (0 for an occluded any-hit lane)
    pos: int  # the winning table position (row * 8 + slot), -1 for none
    ties: int  # slots taken by the tie branch (t == t_best, earlier position)
    depth: int  # the most stack entries in use
    boxes: int  # slab tests
    rows: int  # rows (leaves) entered
    tests: int  # slot tests (the slots of the leaves entered)


def levels(nodes):
    """A [lo.xyz ref | hi.xyz aux] tree's levels (nodes on its longest
    root-to-leaf path)."""
    ref, aux = nodes[:, 3].astype(np.int64), nodes[:, 7].astype(np.int64)
    level, n = np.array([0]), 0
    while len(level):
        n += 1
        inner = level[ref[level] >= 0]
        level = np.concatenate([ref[inner], aux[inner]])
    return n


def row_slots(ref, aux):
    """K3/K4's leaf: row -1 - ref, its 8 table positions."""
    return range(-8 - 8 * ref, -8 * ref)


def leaf_row_slots(ref, aux):
    """K6's leaf: row -1 - ref, its first aux (the count) positions."""
    return range(-8 - 8 * ref, -8 - 8 * ref + aux)


def slot_range(ref, aux):
    """K1's leaf: aux slots from slot -1 - ref."""
    return range(-1 - ref, -1 - ref + aux)


def _enters(node, o, inv, t_best):
    with np.errstate(invalid="ignore"):
        t0 = (node[0:3] - o) * inv
        t1 = (node[4:7] - o) * inv
    axis = ~(np.isnan(t0) | np.isnan(t1))  # a NaN axis does not constrain
    tmin = np.max(np.minimum(t0, t1)[axis], initial=-BIG)
    tmax = np.min(np.maximum(t0, t1)[axis], initial=BIG)
    return bool(tmin < tmax and tmin <= t_best and tmax > 0), tmin


def walk(nodes, met, t, o, d, t_seed, ent=None, excl_ent=None, leaf=row_slots) -> Walk:
    """The kernels' walk of one lane over a hierarchy of [lo.xyz ref | hi.xyz
    aux] nodes (PackedTris.nodes by default; leaf gives a leaf's table
    positions: row_slots, leaf_row_slots for PackedBvh.tree, slot_range for
    PackedSpheres.nodes), in f32, given each table position's row-test
    outcome (met: passes with gid != excl) and t from the plain version's
    row test: slab-test the root; at
    an inner node test both children against t_best (a box entered at
    exactly t_best is kept), descend into the nearer (the left on a tie)
    and push the farther; at a leaf take a slot when t < t_best or (t ==
    t_best and pos < pos_best), pos_best = -1 until a hit; pop, discarding
    entries entered beyond t_best.  The any-hit form when ent is given: the
    first slot with t < t_max and ent != excl_ent ends the walk with t 0."""
    anyhit = ent is not None
    t_best, pos_best, ties, depth, boxes, rows, tests = np.float32(t_seed), -1, 0, 0, 0, 0, 0
    done = lambda: Walk(t_best, pos_best, ties, depth, boxes, rows, tests)
    if o[0] > 1e29 or (anyhit and t_seed == 0):
        return done()
    with np.errstate(divide="ignore"):
        inv = np.float32(1.0) / d
    boxes += 1
    if not _enters(nodes[0], o, inv, t_best)[0]:
        return done()
    cur, stack = 0, []
    while True:
        ref, aux = int(nodes[cur, 3]), int(nodes[cur, 7])
        if ref >= 0:
            boxes += 2
            hl, tl = _enters(nodes[ref], o, inv, t_best)
            hr, tr = _enters(nodes[aux], o, inv, t_best)
            if hl and hr:
                near, far, t_far = (aux, ref, tl) if tr < tl else (ref, aux, tr)
                stack.append((far, t_far))
                depth = max(depth, len(stack))
                cur = near
                continue
            if hl or hr:
                cur = ref if hl else aux
                continue
        else:
            rows += 1
            for pos in leaf(ref, aux):
                tests += 1
                if not met[pos]:
                    continue
                if anyhit:
                    if t[pos] < t_best and ent[pos] != excl_ent:
                        t_best, pos_best = np.float32(0.0), pos
                        return done()
                elif t[pos] < t_best or (t[pos] == t_best and pos < pos_best):
                    ties += bool(t[pos] == t_best)
                    t_best, pos_best = t[pos], pos
        while stack and stack[-1][1] > t_best:
            stack.pop()
        if not stack:
            return done()
        cur = stack.pop()[0]


def flat_over(sizes):
    """A skip-link tree in preorder (prim_count, prim_start, miss_link) over
    leaves of the given sizes, in order, halving the leaf list at each
    level."""
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    count, start, miss = [], [], []

    def node(a, b, miss_to):
        i = len(count)
        count.append(0), start.append(0), miss.append(miss_to)
        if b - a == 1:
            count[i], start[i] = sizes[a], starts[a]
            return
        m = (a + b) // 2
        node(a, m, i + 2 * (m - a))  # the left subtree's miss: the right child
        node(m, b, miss_to)

    node(0, len(sizes), -1)
    return types.SimpleNamespace(prim_count=np.array(count), prim_start=np.array(start),
                                 miss_link=np.array(miss))


def ties_case(rows, n_ent, seed=11):
    """Three chunks of rows_per_chunk rows: axis-aligned right triangles on
    dyadic coordinates (so every row test is exact, whatever chunk centre
    it is recentred on), each duplicated in two chunks, rows of one or two
    triangles, and lanes along +-z aimed inside, at the edges and at the
    corners of those triangles: exact t ties between different chunks and
    rows, visited in either order.  Returns (flat, v0, v1, v2, n, ent) and
    the lanes (o, d, excl, t_init, excl_ent, t_max)."""
    rng = np.random.default_rng(seed)
    n_rows = 3 * rows
    q = lambda *s: rng.integers(-32, 33, s) / 8.0  # dyadic, exact in f32
    tris, where = [], []
    for j in range(n_rows // 2):
        corner = np.array([q(), q(), 1.0 + rng.integers(0, 16) / 4.0])
        leg = 2.0 ** rng.integers(-1, 2)
        tri = (corner, corner + [leg, 0, 0], corner + [0, leg, 0])
        a, b = rng.choice(3, 2, replace=False)  # two different chunks
        for chunk in (a, b):
            tris.append(tri)
            where.append(chunk * rows + rng.integers(0, rows))
    for r in range(n_rows):  # every row a leaf; some rows a second triangle
        if r not in where or rng.uniform() < 0.3:
            c = np.array([q(), q(), rng.integers(0, 24) / 4.0])
            tris.append((c, c + [q() / 4, 0.5, 0.25], c + [0.5, q() / 4, -0.25]))
            where.append(r)
    order = np.argsort(where, kind="stable")
    sizes = np.bincount(np.asarray(where), minlength=n_rows)
    assert sizes.min() >= 1 and sizes.max() <= TT.PACK_LEAF
    v0, v1, v2 = (np.array([tris[i][k] for i in order]) for k in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    ent = np.arange(len(v0)) % n_ent
    m = 600
    k = rng.integers(0, n_rows // 2, m) * 2  # a duplicated triangle
    w = rng.integers(0, 5, (m, 2)) / 4.0  # barycentric quarters: in, edges, corners
    w = np.where(w.sum(1, keepdims=True) > 1.0, w / 2.0, w)
    a, b, c = (np.array([tris[i][j] for i in k]) for j in range(3))
    p = a + w[:, :1] * (b - a) + w[:, 1:] * (c - a)
    up = rng.uniform(size=m) < 0.5
    o = np.where(up[:, None], p - [0, 0, 8.0], p + [0, 0, 8.0]).astype(np.float32)
    d = np.where(up[:, None], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]).astype(np.float32)
    o[::31] = 1e30  # dead lanes
    excl = np.where(rng.uniform(size=m) < 0.15, rng.integers(0, len(v0), m), -1)
    t_init = np.where(rng.uniform(size=m) < 0.7, BIG,
                      rng.integers(1, 48, m) / 4.0).astype(np.float32)
    excl_ent = rng.integers(-1, n_ent, m).astype(np.int32)
    t_max = (rng.integers(0, 48, m) / 4.0).astype(np.float32)  # some 0, some exact
    lanes = (o, d, excl.astype(np.int32), t_init, excl_ent, t_max)
    return (flat_over(sizes), v0, v1, v2, n, ent), lanes


def full_flat(flat, v0, v1, v2):
    """The skip-link BVH fields that pack_bvh reads besides a tree's shape
    (flat_over's prim_count, prim_start, miss_link): each node's box, the
    union of its triangles' (f32), and its hit link (an inner node's next
    node, a leaf's miss link)."""
    count, start, miss = flat.prim_count, np.array(flat.prim_start), flat.miss_link
    m = len(count)
    lo3 = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi3 = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    node_min = np.zeros((m, 3), np.float32)
    node_max = np.zeros((m, 3), np.float32)
    end = np.zeros(m, np.int64)  # a subtree's last triangle + 1
    for i in range(m - 1, -1, -1):  # children after parents in preorder
        if count[i] > 0:
            a, b = start[i], start[i] + count[i]
        else:
            right = miss[i + 1]
            a, b = start[i + 1], end[right]
            start[i] = a
        end[i] = b
        node_min[i], node_max[i] = lo3[a:b].min(0), hi3[a:b].max(0)
    hit = np.where(count > 0, miss, np.arange(m) + 1)
    return types.SimpleNamespace(prim_count=count, prim_start=start, miss_link=miss,
                                 hit_link=hit, node_min=node_min, node_max=node_max,
                                 n_nodes=m)


def sphere_ties_case(n_pairs=48, n_ent=7, seed=13):
    """Spheres on dyadic coordinates in pairs that share a pole: A (c, r)
    and B, shifted by delta along one axis, either way, with radius r +
    delta, so a ray along that axis through c, coming from the side of the
    shared pole, meets both at the same point, with t exact in f32 (every
    step of the sphere test is exact on these numbers).  B's centre lies
    behind A's on the ray, so its morton code and often its leaf differ,
    and the walk, front to back, meets A's side of the tree first as often
    as not: a later slot found first, then its tie at an earlier one.
    Among them, unrelated spheres.  Lanes along +-x, +-y or +-z aimed at a
    pair's shared pole, some exactly through the centres, some off by a
    dyadic step (no exact tie, zero components still), with exclusions,
    finite t_init, excl_ent and t_max.  Returns (centers, radii, ent) and
    the lanes (o, d, excl, t_init, excl_ent, t_max); excl holds slot ids
    of the packed order."""
    rng = np.random.default_rng(seed)
    q = lambda *s: rng.integers(-64, 65, s) / 4.0  # dyadic, exact in f32
    centers, radii, axes, signs = [], [], [], []
    for _ in range(n_pairs):
        c = q(3)
        r = 0.5 + rng.integers(0, 8) / 4.0
        ax = rng.integers(0, 3)
        sign = rng.choice([-1.0, 1.0])
        delta = rng.integers(8, 49) / 4.0
        c2 = c.copy()
        c2[ax] += sign * delta
        centers += [c, c2]
        radii += [r, r + delta]
        axes.append(ax)
        signs.append(sign)
    for _ in range(n_pairs):
        centers.append(q(3))
        radii.append(0.25 + rng.integers(0, 6) / 4.0)
    centers, radii = np.array(centers), np.array(radii)
    ent = np.arange(len(radii)) % n_ent
    m = 600
    k = rng.integers(0, n_pairs, m)
    ax, sign = np.array(axes)[k], np.array(signs)[k]
    c = centers[2 * k]
    lane = np.arange(m)
    o = c.copy()
    o[lane, ax] = c[lane, ax] - sign * (radii[2 * k] + rng.integers(4, 40, m) / 4.0)
    off = lane % 4 == 3  # off the shared pole by a dyadic step
    side = (ax + 1) % 3
    o[np.where(off)[0], side[off]] += rng.integers(1, 4, int(off.sum())) / 8.0
    d = np.zeros((m, 3))
    d[lane, ax] = sign
    o, d = o.astype(np.float32), d.astype(np.float32)
    o[::37] = 1e30  # dead lanes
    excl = np.where(rng.uniform(size=m) < 0.15, rng.integers(0, len(radii), m), -1)
    t_init = np.where(rng.uniform(size=m) < 0.7, BIG,
                      rng.integers(1, 48, m) / 4.0).astype(np.float32)
    excl_ent = rng.integers(-1, n_ent, m).astype(np.int32)
    t_max = (rng.integers(0, 48, m) / 4.0).astype(np.float32)
    lanes = (o, d, excl.astype(np.int32), t_init, excl_ent, t_max)
    return (centers, radii, ent), lanes
