"""Skip-link BVH traversal (K6): the packed BVH table, the CUDA closest-hit
kernel that walks it, and its plain PyTorch version.

Ports the K6 part of ``paths_tpu/ops/pallas_traverse.py``: ``pack_bvh``,
``_pack_nodes``, ``_pack_tri_rows`` (with ``_leaf_map`` and ``tris_pad``,
shared with ``ops/tri_traverse.py``), bit-exact, and ``closest_hit_packet``.
The kernel in ``csrc/packet_bvh.cu`` replaces ``pallas_traverse.py::_kernel``
(launched by ``_launch_chunked``), whose row test is the vertex-layout
``_tri_row_test``.  This is the BVH route's closest-hit query on every
device: the plain version on the CPU, the kernel on the card.

Table layout (as the reference's):
  nodes (M, 128) f32, one node per row, in preorder: [0:3] box min,
    [3:6] box max, [6] hit link, [7] miss link, [8] leaf row, [9] triangle
    count (0 for an inner node); links and ids as f32 (exact below 2^24).
  tris (R, 128) f32, one leaf per row: 8 slots of [v0.xyz v1.xyz v2.xyz
    n.xyz gid inv_area ent n.v0]; an empty slot has gid = -1 and n = 0
    (cos = 0: never hit).  inv_area and n.v0 are computed in f64 and
    rounded.
and the port's own ``tree`` (M, 8) f32, derived at pack time: the same
binary tree with explicit children, as csrc/walk.cuh reads it, [lo.xyz ref
| hi.xyz aux] per node in preorder -- an inner node's ref its left child
(the next node), aux its right child (the left child's miss link); a
leaf's ref = -1 - leaf row, aux = its triangle count -- with each leaf's
box its triangles' f32 box padded by a relative 1e-4 and each inner box the
union of its children's (``tri_traverse.py::_row_hierarchy``, the tree of
the triangle kernels' table).

The function is per lane, not per 1,024-lane packet: the closest
qualifying slot, the first in table order (= preorder) on a tie, found by
brute force over every triangle with the row test.  The plain version
computes it by the skip-link walk (``cursor = hit ? hit_link :
miss_link``) with the slab test on each node's own box padded by a relative
1e-4 (``walk_nodes``) and a strict ``t < t_best``; the kernel by a
front-to-back stack walk of ``tree`` with a (t, table position) tie rule.
Both pads make their walks equal brute force: f32 rounding of a box can
only keep a node, never drop one.  The reference's packet walk tests a leaf
for every lane of a block once any lane's (unpadded) test passes, so its
answer can depend on the other lanes of the block (``ROADMAP.md``, Queue
3).  A slab distance that is NaN (a direction component 0 with the origin
exactly on a padded plane) leaves that axis unconstrained, in the kernel
and here alike.

What bounds the kernel on an H100: bytes -- the leaves' triangles (64 B a
slot) and the nodes on a lane's way, which stay in the 50 MB L2 -- though
what holds it from that bound is the chain of dependent node and slot
reads per lane and the divergence of a warp's lanes.  The design: one
thread per ray walks the tree front to back with a short per-lane stack,
prunes every box beyond its running best, and reads nodes and slots as
float4 through the read-only path.

Dispatch: a wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises -- it never falls back.  Its
launches are counted in ``profiling.LAUNCHES`` (``native.launch``); it
detaches o, d and t_init first, so its outputs carry no gradient on any
device (``sphere_traverse.cut``, whose module docstring says why).
"""

from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch

from paths_tpu_torch import native
from paths_tpu_torch.ops.sphere_traverse import BIG, DEAD, _fma, cut
from paths_tpu_torch.ops.tri_traverse import (BOX_PAD, NODE_FLOATS, PACK_LEAF, TRI_STRIDE,
                                               _leaf_map, _row_hierarchy)
from paths_tpu_torch.ops.tri_traverse import _pad8 as tris_pad


class PackedBvh(NamedTuple):
    nodes: torch.Tensor  # (M, 128) f32, the reference's node table
    tris: torch.Tensor  # (R, 128) f32, the reference's leaf rows
    tree: torch.Tensor  # (M, NODE_FLOATS) f32, the kernel's tree (module docstring)


# ---------------------------------------------------------------------------
# Packing (numpy, f64 host math, f32 table): bit-exact with the reference.
# ---------------------------------------------------------------------------

def _pack_nodes(flat) -> np.ndarray:
    is_leaf = flat.prim_count > 0
    leaf_ids = np.cumsum(is_leaf) - 1  # node -> its leaf row
    nodes = np.zeros((flat.n_nodes, 128), np.float32)
    nodes[:, 0:3] = flat.node_min
    nodes[:, 3:6] = flat.node_max
    nodes[:, 6] = flat.hit_link
    nodes[:, 7] = flat.miss_link
    nodes[:, 8] = np.where(is_leaf, leaf_ids, 0)
    nodes[:, 9] = flat.prim_count
    return nodes


def _pack_tri_rows(flat, v0, v1, v2, n, ent=None) -> np.ndarray:
    """One leaf per row, 8 vertex-layout slots of 16 floats (module
    docstring); inv_area = 0 marks a degenerate slot (never hit)."""
    v0, v1, v2, n = (np.asarray(a, np.float64) for a in (v0, v1, v2, n))
    T = len(v0)
    ent = np.zeros(T, np.int64) if ent is None else np.asarray(ent)
    row, slot, leaf_start = _leaf_map(flat, T)

    area = np.einsum("ij,ij->i", n, np.cross(v1 - v0, v2 - v0))
    inv_area = np.where(area != 0.0, 1.0 / np.where(area == 0.0, 1.0, area), 0.0)
    dd = np.einsum("ij,ij->i", n, v0)
    tris = np.zeros((max(len(leaf_start), 1), 128), np.float32)
    tris[:, 12::TRI_STRIDE] = -1.0  # gid = -1 in empty slots
    base = slot * TRI_STRIDE
    for j in range(3):
        tris[row, base + j] = v0[:, j]
        tris[row, base + 3 + j] = v1[:, j]
        tris[row, base + 6 + j] = v2[:, j]
        tris[row, base + 9 + j] = n[:, j]
    tris[row, base + 12] = np.arange(T)
    tris[row, base + 13] = inv_area
    tris[row, base + 14] = ent
    tris[row, base + 15] = dd
    return tris


def walk_nodes(nodes: torch.Tensor) -> torch.Tensor:
    """The plain version's skip-link node copy: [lo - pad, hit | hi + pad,
    miss | leaf row, count, 0, 0] per node row, pad = 1e-4 * (|lo| + |hi| +
    (hi - lo)) + 1e-6 per axis in f32 (the pad of
    csrc/row_tests.cuh::crosses_box)."""
    lo, hi = nodes[:, 0:3], nodes[:, 3:6]
    pad = (lo.abs() + hi.abs() + (hi - lo)) * BOX_PAD + 1e-6
    zero = torch.zeros_like(nodes[:, 0:2])
    return torch.cat([lo - pad, nodes[:, 6:7], hi + pad, nodes[:, 7:10], zero],
                     dim=1)


def _tree(flat, v0, v1, v2) -> np.ndarray:
    """The kernel's tree (module docstring): the BVH's binary tree with a
    leaf's box its triangles' f32 box, padded, and aux its triangle count.
    Raises if the tree is deeper than the kernel's walk stack."""
    _, _, leaf_start = _leaf_map(flat, len(v0))
    lo3 = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi3 = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    row_lo = np.minimum.reduceat(lo3, leaf_start, axis=0)
    row_hi = np.maximum.reduceat(hi3, leaf_start, axis=0)
    count = flat.prim_count[flat.prim_count > 0]
    return _row_hierarchy(flat, row_lo, row_hi, count)


def pack_bvh(flat, v0, v1, v2, n, ent=None, device="cpu") -> PackedBvh:
    """Pack a FlatBvh (leaves of at most PACK_LEAF triangles) and its
    triangles (v0, v1, v2, n (T, 3) in ``flat.order``, so the gid written
    into each slot indexes them; ent (T,) entity ids) into the table, each
    part padded to a multiple of 8 rows as the reference's, and the
    kernel's tree.  Raises if the BVH's leaves do not cover the triangles in
    ascending ranges in preorder, or if the tree is deeper than the
    kernel's walk stack (64 inner levels)."""
    nodes = torch.from_numpy(tris_pad(_pack_nodes(flat)))
    tris = torch.from_numpy(tris_pad(_pack_tri_rows(flat, v0, v1, v2, n, ent)))
    tree = torch.from_numpy(_tree(flat, *(np.asarray(a, np.float64) for a in (v0, v1, v2))))
    return PackedBvh(*(x.to(device) for x in (nodes, tris, tree)))


def tree_shape(pt: PackedBvh):
    """The BVH's shape read back from a packed table, as pack_chunked takes
    it: per node (in preorder, pt.tree's rows) prim_count, miss_link and
    prim_start (a leaf's first triangle: the triangles of the leaves before
    it, as pack_bvh checked that their ranges ascend), numpy int64."""
    nodes = pt.nodes[: pt.tree.shape[0]].cpu().numpy()
    count = nodes[:, 9].astype(np.int64)
    return types.SimpleNamespace(prim_count=count, prim_start=np.cumsum(count) - count,
                                 miss_link=nodes[:, 7].astype(np.int64))


# ---------------------------------------------------------------------------
# Plain PyTorch version: the skip-link walk, vectorised over the lanes that
# are still walking, in the kernel's arithmetic.  Used on CPU tensors, and
# by the tests and the chip smoke run to hold the kernel.
# ---------------------------------------------------------------------------

def _dot3(a0, a1, a2, b0, b1, b2):
    """a.b as XLA's CPU compilation of the reference's ``a0*b0 + a1*b1 +
    a2*b2`` contracts it: fma(a2, b2, fma(a0, b0, a1*b1))."""
    return _fma(a2, b2, _fma(a0, b0, a1 * b1))


def _cross_dot_n(n, a, b):
    """n . (a x b), each cross component a_i*b_j - a_j*b_i contracted to
    fma(a_i, b_j, -(a_j*b_i)) and the dot as _dot3."""
    cx = _fma(a[1], b[2], -(a[2] * b[1]))
    cy = _fma(a[2], b[0], -(a[0] * b[2]))
    cz = _fma(a[0], b[1], -(a[1] * b[0]))
    return _dot3(n[0], n[1], n[2], cx, cy, cz)


def _row_test(s, o, d, excl, t_best):
    """Qualifying mask and t of _tri_row_test for slot fields s (..., 16)
    against rays o, d (..., 3), excl and t_best (...), with the fused
    multiply-adds of the reference kernel compiled by XLA for the CPU (the
    CUDA kernel issues them as fmaf): cos and n.o as _dot3, p = fma(d, t,
    o), the cross products and dots of _cross_dot_n.  t = (n.v0 - n.o) /
    cos is an IEEE division."""
    v0 = [s[..., j] for j in range(0, 3)]
    v1 = [s[..., j] for j in range(3, 6)]
    v2 = [s[..., j] for j in range(6, 9)]
    n = [s[..., j] for j in range(9, 12)]
    gid = s[..., 12].to(torch.int32)
    inv_area = s[..., 13]
    oo = [o[..., j] for j in range(3)]
    dd = [d[..., j] for j in range(3)]
    cos = _dot3(*n, *dd)
    n_o = _dot3(*n, *oo)
    t = (s[..., 15] - n_o) / torch.where(cos == 0.0, 1.0, cos)
    p = [_fma(dd[j], t, oo[j]) for j in range(3)]
    pa = [v0[j] - p[j] for j in range(3)]
    pb = [v1[j] - p[j] for j in range(3)]
    pc = [v2[j] - p[j] for j in range(3)]
    bx = _cross_dot_n(n, pb, pc) * inv_area
    by = _cross_dot_n(n, pc, pa) * inv_area
    bz = (1.0 - bx) - by
    ok = ((cos != 0.0) & (t >= 0.0) & (bx >= 0.0) & (by >= 0.0) & (bz >= 0.0)
          & (inv_area != 0.0) & (t < t_best) & (gid != excl) & (gid >= 0))
    return ok, t


def _slab(box, o, inv, t_best):
    """The padded slab test of the walk: (lanes,) bool.  box (lanes, 12)
    compact node rows; an axis whose slab distance is NaN does not
    constrain (csrc/row_tests.cuh::crosses_padded_box)."""
    tmin = torch.full_like(t_best, -BIG)
    tmax = torch.full_like(t_best, BIG)
    for ax in range(3):
        t0 = (box[:, ax] - o[:, ax]) * inv[:, ax]
        t1 = (box[:, 4 + ax] - o[:, ax]) * inv[:, ax]
        nan = torch.isnan(t0) | torch.isnan(t1)
        tmin = torch.where(nan, tmin, torch.maximum(tmin, torch.minimum(t0, t1)))
        tmax = torch.where(nan, tmax, torch.minimum(tmax, torch.maximum(t0, t1)))
    return (tmin < tmax) & (tmin < t_best) & (tmax > 0.0)


def closest_hit_packet_plain(pt: PackedBvh, o, d, excl_idx, t_init):
    """Plain version of the kernel: (t, gid, ent), t == BIG and gid = ent =
    0 where no triangle beats t_init."""
    n = o.shape[0]
    dev = o.device
    walk = walk_nodes(pt.nodes)
    slots = pt.tris.reshape(-1, PACK_LEAF, TRI_STRIDE)
    t_best = t_init.clone()
    gid_best = torch.zeros(n, dtype=torch.int32, device=dev)
    ent_best = torch.zeros(n, dtype=torch.int32, device=dev)
    inv = 1.0 / d
    lanes = torch.nonzero(~(o[:, 0] > DEAD))[:, 0]  # dead lanes are misses
    cursor = torch.zeros_like(lanes)
    while lanes.numel():
        box = walk[cursor]
        hit = _slab(box, o[lanes], inv[lanes], t_best[lanes])
        leaf = hit & (box[:, 9] > 0)
        if bool(leaf.any()):
            ix = lanes[leaf]
            rows = slots[box[leaf, 8].to(torch.int64)]  # (k, 8, 16)
            ok, t = _row_test(rows, o[ix, None, :], d[ix, None, :],
                              excl_idx[ix, None], t_best[ix, None])
            tb, gb, eb = t_best[ix], gid_best[ix], ent_best[ix]
            for k in range(PACK_LEAF):  # in slot order: the first wins a tie
                win = ok[:, k] & (t[:, k] < tb)
                tb = torch.where(win, t[:, k], tb)
                gb = torch.where(win, rows[:, k, 12].to(torch.int32), gb)
                eb = torch.where(win, rows[:, k, 14].to(torch.int32), eb)
            t_best[ix], gid_best[ix], ent_best[ix] = tb, gb, eb
        cursor = torch.where(hit, box[:, 3], box[:, 7]).to(torch.int64)
        keep = cursor >= 0
        lanes, cursor = lanes[keep], cursor[keep]
    t_out = torch.where(t_best < t_init, t_best, torch.full_like(t_best, BIG))
    return t_out, gid_best, ent_best


# ---------------------------------------------------------------------------
# CUDA kernel: checks and launch (native.py).
# ---------------------------------------------------------------------------


def _check_launch(pt: PackedBvh, o, d, excl_idx, t_init) -> int:
    """What the kernel takes: the leaf rows, (R, 128) f32, and the tree,
    (M, NODE_FLOATS) f32 with a root, both 16-byte aligned and on the
    lanes' device; lanes o, d (N, 3) f32, excl_idx (N,) i32, t_init (N,)
    f32 (``native.check_rays``).  Returns N."""
    dev = o.device
    native.check("tris", pt.tris, torch.float32, (pt.tris.shape[0], 128), dev, align16=True)
    native.check("tree", pt.tree, torch.float32, (pt.tree.shape[0], NODE_FLOATS), dev,
                 align16=True)
    if pt.tree.shape[0] == 0:
        raise ValueError("the tree has no root")
    return native.check_rays(o, d, excl_idx, [("t_init", t_init, torch.float32)])


def closest_hit_packet(pt: PackedBvh, o, d, excl_idx, t_init):
    """Closest triangle hit per lane over the BVH table: (t, gid, ent),
    t == BIG (gid = ent = 0) where nothing beats t_init.  o, d (N, 3) f32;
    excl_idx (N,) i32 triangle id to skip (-1 none); t_init (N,) f32.  The
    outputs carry no gradient."""
    o, d, t_init = cut(o, d, t_init)
    if o.device.type == "cpu":
        return closest_hit_packet_plain(pt, o, d, excl_idx, t_init)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    n = _check_launch(pt, o, d, excl_idx, t_init)
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    gid = torch.empty(n, dtype=torch.int32, device=o.device)
    ent = torch.empty(n, dtype=torch.int32, device=o.device)
    if n:
        native.launch("packet_closest_hit", "packet_closest_hit", o.device, pt.tree, pt.tris,
                      o, d, excl_idx, t_init, n, t, gid, ent)
    return t, gid, ent
