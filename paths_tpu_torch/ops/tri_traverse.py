"""Triangle traversal: the packed plane-form triangle table with a box
hierarchy over its rows, the CUDA closest-hit and any-hit kernels that walk
it, and their plain PyTorch versions.

Ports ``paths_tpu/ops/pallas_traverse.py::pack_chunked`` with
``_pack_tri_rows_plane`` and ``_leaf_map`` (bit-exact) and the triangle forms
of ``paths_tpu/ops/sorted_traverse.py`` (``closest_hit_sorted`` ->
``closest_hit_tris``, ``occludes_sorted`` -> ``occludes_tris``).  The kernels
in ``csrc/tri_traverse.cu`` replace ``sorted_traverse.py::_make_sorted_kernel``
in its triangle forms (row test ``pallas_traverse.py::_tri_row_test_v2``,
recentring ``_chunk_shift``).  The reference's replicated table
(``tris_rep``) is a TPU layout of the same rows and has no counterpart here.

The hierarchy (``PackedTris.nodes``, built by ``pack_chunked`` on every
device) is the mesh BVH's own binary tree over the table's rows, one row a
leaf, with each box padded so that it can only keep a row: the reference
walks its chunks front to back per ray block (``_block_cull_keys``), the
kernels walk this tree front to back per lane, with pruning against the
running best and a (t, table position) tie rule, so their answers equal the
plain versions' brute force in table order.  The tree was chosen by counting
box tests: on doom_standin and dragon_standin an implicit tree that halves
contiguous row ranges tests 2.2-2.7 times as many boxes per ray as the BVH's
own splits, primary and incoherent rays alike
(``scripts/tri_hierarchy_shapes.py``).

What bounds the kernels on an H100: bytes -- the function needs the
triangles of the leaves a ray enters before its answer is settled and the
nodes on its way, and moving those takes longer than their 32 FP32
operations per slot -- though what holds them far from that bound is the
chain of dependent node and slot reads per lane and the divergence of a
warp's lanes.  The design: one thread per ray walks the tree with a short
per-lane stack, reading nodes and slots as float4 through the read-only
path.  The arithmetic is IEEE with exactly the fused multiply-adds that
XLA's CPU compilation of the reference kernel contracts (see ``_row_test``),
so the plain versions, the kernels and the reference in interpret mode agree
bit for bit.

Dispatch: a wrapper given CPU tensors runs the plain version (which does not
read the hierarchy); given CUDA tensors it launches the kernel or raises --
it never falls back.  Each wrapper's launches are counted under its own
key of ``profiling.LAUNCHES`` (``native.launch``).  ``ops/chunk_scan.py``'s
K7 and K9 launch the same kernels through ``walk_closest_hit`` and
``walk_any_hit`` under their keys, not these.  The wrappers' outputs carry no
gradient on any device: they detach o, d, t_init and t_max first
(``sphere_traverse.cut``, whose module docstring says why).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from paths_tpu_torch import native
from paths_tpu_torch.ops.sphere_traverse import BIG, DEAD, _fma, cut

PACK_LEAF = 8  # triangle slots per row (one BVH leaf per row)
TRI_STRIDE = 16  # floats per slot
# Rows per chunk: the reference packs at 8 (sorted_traverse.py
# ROWS_PER_CHUNK_SORTED) and repacks at 20 (ROWS_PER_CHUNK_STREAMED) when
# table and meta reach REPACK_BYTES (pallas_traverse.py VMEM_LIMIT_BYTES).
# The chunk size is part of the table: each slot's plane constants are
# recentred on its chunk's box centre.
ROWS_PER_CHUNK = 8
ROWS_PER_CHUNK_LARGE = 20
REPACK_BYTES = 10 * 1024 * 1024
# The hierarchy: floats per node ([lo.xyz ref | hi.xyz aux]), the relative
# pad of a row box (csrc/row_tests.cuh kBoxPad) and the kernels' walk stack
# (csrc/tri_traverse.cu kStack), which bounds the tree's depth.
NODE_FLOATS = 8
BOX_PAD = 1e-4
WALK_STACK = 64


class PackedTris(NamedTuple):
    tris: torch.Tensor  # (R, 128) f32 rows of 8 plane-form slots
    chunk_meta: torch.Tensor  # (Cpad, 128) f32: [lo.xyz, hi.xyz, row0, nrows, row boxes]
    tri_ent: torch.Tensor  # (T,) int32 triangle -> entity
    # (M, NODE_FLOATS) f32, the box hierarchy over the rows that the kernels
    # walk (_row_hierarchy); the reference has none.  None only for a table
    # rebuilt from the reference's arrays (scene/types.py::scene_from_numpy):
    # the plain versions do not read it, the kernels refuse a table without it.
    nodes: Optional[torch.Tensor] = None


# The fields that the reference's table (pallas_traverse.py::ChunkedTris) has
# too, bit for bit.
REFERENCE_FIELDS = ("tris", "chunk_meta", "tri_ent")


# ---------------------------------------------------------------------------
# Packing (numpy, f64 host math, f32 table): bit-exact with the reference.
# ---------------------------------------------------------------------------

def _leaf_map(flat, T):
    """Primitive -> (row, slot) for the leaf-row layout; prim ranges are
    contiguous in leaf order.  Returns (row, slot, leaf_start).  Raises
    unless the leaves, in preorder, cover [0, T) in ascending ranges: then
    a leaf's row is its rank in preorder, so the table's order is the
    preorder of its slots, which the walk kernels' tie rule relies on."""
    is_leaf = flat.prim_count > 0
    leaf_start = flat.prim_start[is_leaf]  # (R,) ascending, partitions [0,T)
    ends = leaf_start + flat.prim_count[is_leaf]
    if T and (leaf_start[0] != 0 or ends[-1] != T
              or (leaf_start[1:] != ends[:-1]).any()):
        raise ValueError("the BVH's leaves do not cover the triangles in "
                         "ascending ranges in preorder")
    g = np.arange(T)
    row = np.searchsorted(leaf_start, g, side="right") - 1
    slot = g - leaf_start[row]
    return row, slot, leaf_start


def _pad8(a: np.ndarray) -> np.ndarray:
    """Pad rows to a multiple of 8 with zeros (the reference's tris_pad)."""
    r = (-len(a)) % 8
    return np.pad(a, ((0, r), (0, 0))) if r else a


def _pack_rows(flat, v0, v1, v2, n, ent, centers, rows_per_chunk, rpad):
    """Plane-form slots, built in f64 against each chunk's centre c:

      [0:3] n   [3] dd = n.(v0-c)   [4:7] g1  [7] c1   [8:11] g2  [11] c2
      [12] gid  [13] 0   [14] ent   [15] 0

    bx = c1 + g1.p' and by = c2 + g2.p' are the barycentrics of the
    recentred hit point p' = (o-c) + t d.  Empty and degenerate slots get
    c1 = c2 = -BIG (bx >= 0 fails for every ray) and gid = -1."""
    v0, v1, v2, n = (np.asarray(a, np.float64) for a in (v0, v1, v2, n))
    T = len(v0)
    row, slot, _ = _leaf_map(flat, T)
    c = np.asarray(centers, np.float64)[row // rows_per_chunk]  # (T, 3)

    area = np.einsum("ij,ij->i", n, np.cross(v1 - v0, v2 - v0))
    inv_area = np.where(area != 0.0, 1.0 / np.where(area == 0.0, 1.0, area), 0.0)
    v0c, v1c, v2c = v0 - c, v1 - c, v2 - c
    dd = np.einsum("ij,ij->i", n, v0c)
    g1 = np.cross(v1 - v2, n) * inv_area[:, None]
    c1 = np.einsum("ij,ij->i", n, np.cross(v1c, v2c)) * inv_area
    g2 = np.cross(v2 - v0, n) * inv_area[:, None]
    c2 = np.einsum("ij,ij->i", n, np.cross(v2c, v0c)) * inv_area
    bad = area == 0.0
    c1 = np.where(bad, -np.float64(BIG), c1)
    c2 = np.where(bad, -np.float64(BIG), c2)

    rows = np.zeros((max(rpad, 1), 128), np.float32)
    rows[:, 7::TRI_STRIDE] = -BIG   # c1 in empty slots
    rows[:, 11::TRI_STRIDE] = -BIG  # c2
    rows[:, 12::TRI_STRIDE] = -1.0  # gid
    base = slot * TRI_STRIDE
    for j in range(3):
        rows[row, base + j] = n[:, j]
        rows[row, base + 4 + j] = g1[:, j]
        rows[row, base + 8 + j] = g2[:, j]
    rows[row, base + 3] = dd
    rows[row, base + 7] = c1
    rows[row, base + 11] = c2
    rows[row, base + 12] = np.arange(T)
    rows[row, base + 14] = ent
    return rows


def _row_hierarchy(flat, row_lo, row_hi, leaf_aux):
    """A walk kernel's box hierarchy over the table's rows: the BVH's own
    binary tree (``flat``: prim_count and miss_link in preorder, one leaf
    per row), one node per BVH node in the same order, as (M, NODE_FLOATS)
    f32 rows [lo.xyz ref | hi.xyz aux] (csrc/walk.cuh).  An inner node has
    ref = its left child (the next node in preorder) and aux = its right
    child (the left child's miss link); a leaf has ref = -1 - row and aux =
    leaf_aux[row] (K3/K4: the row's chunk; K6: its triangle count).  A
    leaf's box is its row's f32 box (row_lo, row_hi) padded by kBoxPad's
    rule, pad = BOX_PAD * (|lo| + |hi| + (hi - lo)) + 1e-6 per axis in f32,
    an inner node's the union of its children's, so a node can only keep a
    row.  Raises if the tree needs more than WALK_STACK stack entries."""
    count = np.asarray(flat.prim_count)
    leaf = count > 0
    n_leaves = int(leaf.sum())
    row_lo, row_hi = row_lo[:n_leaves], row_hi[:n_leaves]
    pad = np.float32(BOX_PAD) * (np.abs(row_lo) + np.abs(row_hi) + (row_hi - row_lo)) \
        + np.float32(1e-6)
    m = len(count)
    inner = np.nonzero(~leaf)[0]
    left = inner + 1
    right = np.asarray(flat.miss_link)[left]
    if n_leaves == 0 or m != 2 * n_leaves - 1 or not (right > left).all():
        raise ValueError("the BVH is not a binary tree in preorder")
    parent = np.full(m, -1, np.int64)
    parent[left] = inner
    parent[right] = inner
    depth = np.zeros(m, np.int64)
    for _ in range(m):  # parents precede their children in preorder
        nxt = np.where(parent >= 0, depth[parent] + 1, 0)
        if (nxt == depth).all():
            break
        depth = nxt
    if depth.max() > WALK_STACK:
        raise ValueError(f"the BVH is {depth.max() + 1} levels deep; the kernels' "
                         f"walk stack holds {WALK_STACK} inner levels")
    lo = np.zeros((m, 3), np.float32)
    hi = np.zeros((m, 3), np.float32)
    rows = np.arange(n_leaves)  # leaves in preorder are the rows in order
    lo[leaf] = row_lo - pad
    hi[leaf] = row_hi + pad
    ref = np.zeros(m, np.float32)
    aux = np.zeros(m, np.float32)
    ref[leaf], aux[leaf] = -1 - rows, np.asarray(leaf_aux)[:n_leaves]
    ref[inner], aux[inner] = left, right
    right_of = np.zeros(m, np.int64)
    right_of[inner] = right
    for level in range(int(depth.max()) - 1, -1, -1):  # children before parents
        ids = inner[depth[inner] == level]
        lo[ids] = np.minimum(lo[ids + 1], lo[right_of[ids]])
        hi[ids] = np.maximum(hi[ids + 1], hi[right_of[ids]])
    return np.concatenate([lo, ref[:, None], hi, aux[:, None]], axis=1)


def pack_chunked(flat, v0, v1, v2, n, ent=None,
                 rows_per_chunk: int = ROWS_PER_CHUNK):
    """The BVH's leaf rows (one leaf of at most 8 triangles per row; v0, v1,
    v2, n in ``flat.order``) cut into chunks of rows_per_chunk rows, and the
    hierarchy over them (_row_hierarchy).  Returns (PackedTris on the CPU,
    n_chunks).

    Meta row: [0:6] chunk box lo/hi, [6] first row, [7] row count, and, when
    rows_per_chunk <= 15, [8 : 8+8*rows] per-row boxes (lo, hi, 0, 0); rows
    past the mesh get an inverted box (+BIG lo, -BIG hi).  The table is
    padded to n_chunks * rows_per_chunk rows with empty slots."""
    T = len(v0)
    row, _, leaf_start = _leaf_map(flat, T)
    R = max(len(leaf_start), 1)
    n_chunks = -(-R // rows_per_chunk)
    rpad = n_chunks * rows_per_chunk

    tmin3 = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tmax3 = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    row_lo = np.full((rpad, 3), BIG, np.float32)
    row_hi = np.full((rpad, 3), -BIG, np.float32)
    if T:
        row_lo[: len(leaf_start)] = np.minimum.reduceat(tmin3, leaf_start, axis=0)
        row_hi[: len(leaf_start)] = np.maximum.reduceat(tmax3, leaf_start, axis=0)

    meta = np.zeros((n_chunks, 128), np.float32)
    clo = row_lo.reshape(n_chunks, rows_per_chunk, 3)
    chi = row_hi.reshape(n_chunks, rows_per_chunk, 3)
    meta[:, 0:3] = clo.min(axis=1)
    meta[:, 3:6] = chi.max(axis=1)
    meta[:, 6] = np.arange(n_chunks) * rows_per_chunk
    meta[:, 7] = np.minimum((np.arange(n_chunks) + 1) * rows_per_chunk, R) \
        - np.arange(n_chunks) * rows_per_chunk
    if rows_per_chunk <= 15:
        rowmeta = np.concatenate(
            [clo, chi, np.zeros((n_chunks, rows_per_chunk, 2), np.float32)],
            axis=2,
        )
        meta[:, 8: 8 + 8 * rows_per_chunk] = rowmeta.reshape(n_chunks, -1)

    # Chunk centres: exactly the midpoint the kernels recompute from meta
    # cols 0:6 in f32, so pack-time and run-time shifts agree bit for bit.
    valid = (meta[:, 7] > 0) & (meta[:, 0] <= meta[:, 3])
    centers = np.where(valid[:, None], 0.5 * (meta[:, 0:3] + meta[:, 3:6]), 0.0)
    ent_rows = np.zeros(T, np.int64) if ent is None else np.asarray(ent)
    tris = _pack_rows(flat, v0, v1, v2, n, ent_rows, centers, rows_per_chunk, rpad)
    tri_ent = (np.zeros(max(T, 1), np.int32) if ent is None
               else np.asarray(ent, np.int32))
    nodes = _row_hierarchy(flat, row_lo, row_hi, np.arange(rpad) // rows_per_chunk)
    packed = PackedTris(tris=torch.from_numpy(_pad8(tris)),
                        chunk_meta=torch.from_numpy(_pad8(meta)),
                        tri_ent=torch.from_numpy(tri_ent),
                        nodes=torch.from_numpy(nodes))
    return packed, n_chunks


def pack_tris(flat, v0, v1, v2, n, ent=None, device="cpu"):
    """Pack at ROWS_PER_CHUNK rows per chunk, or at ROWS_PER_CHUNK_LARGE when
    that table and its meta reach REPACK_BYTES (the reference's rule).
    Returns (PackedTris, n_chunks, rows_per_chunk)."""
    packed, n_chunks = pack_chunked(flat, v0, v1, v2, n, ent, ROWS_PER_CHUNK)
    size = (packed.tris.shape[0] + packed.chunk_meta.shape[0]) * 128 * 4
    rows = ROWS_PER_CHUNK
    if size >= REPACK_BYTES:
        rows = ROWS_PER_CHUNK_LARGE
        packed, n_chunks = pack_chunked(flat, v0, v1, v2, n, ent, rows)
    return PackedTris(*(x.to(device) for x in packed)), n_chunks, rows


# ---------------------------------------------------------------------------
# Plain PyTorch versions: flat brute force over every slot of the table, in
# the kernel's arithmetic order, each slot against its own chunk's centre,
# with a first-index tie-break.  Used on CPU tensors, and by the tests and
# the chip smoke run to hold the kernels.
# ---------------------------------------------------------------------------

def _lane_steps(n: int, n_slots: int, device):
    """Lane ranges that bound the (lanes, slots) temporaries."""
    pairs = (1 << 22) if device.type == "cpu" else (1 << 25)
    step = max(1, pairs // max(n_slots, 1))
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def _slots(pt: PackedTris, n_chunks: int):
    """Per-slot fields and recentring centre (each slot's chunk: meta row0 /
    nrows; pad rows belong to no chunk and hold empty slots)."""
    table, meta = pt.tris, pt.chunk_meta
    s = table.reshape(-1, TRI_STRIDE)
    rows = torch.arange(table.shape[0], device=table.device)
    row0 = meta[:n_chunks, 6].to(torch.int64)
    chunk = torch.clamp_min(torch.searchsorted(row0, rows, right=True) - 1, 0)
    centre = (meta[chunk, 0:3] + meta[chunk, 3:6]) * 0.5  # f32, as the kernel
    centre = centre.repeat_interleave(PACK_LEAF, dim=0)
    return dict(n=s[:, 0:3], dd=s[:, 3], g1=s[:, 4:7], c1=s[:, 7],
                g2=s[:, 8:11], c2=s[:, 11], gid=s[:, 12].to(torch.int32),
                ent=s[:, 14].to(torch.int32), centre=centre)


def _dot3(a, b):
    """a.b over the trailing 3, as XLA's CPU compilation of the reference's
    ``a0*b0 + a1*b1 + a2*b2`` contracts it: fma(a2, b2, fma(a0, b0, a1*b1))."""
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 0], b[..., 0], a[..., 1] * b[..., 1]))


def _row_test(f, o, d, excl, t_seed):
    """(lanes, slots) qualifying mask and t of _tri_row_test_v2 against the
    lanes' seeds, with the fused multiply-adds the reference kernel gets
    when XLA compiles it for the CPU (the CUDA kernel issues them as fmaf):
    the six dot products (_dot3) and bx = fma(t, g1.d, c1 + g1.o'), by
    likewise."""
    osh = o[:, None, :] - f["centre"][None]  # (lanes, slots, 3)
    dd_ = d[:, None, :]
    n = f["n"][None]
    cos = _dot3(n, dd_)
    t = (f["dd"][None] - _dot3(n, osh)) / cos
    g1, g2 = f["g1"][None], f["g2"][None]
    bx = _fma(t, _dot3(g1, dd_), f["c1"][None] + _dot3(g1, osh))
    by = _fma(t, _dot3(g2, dd_), f["c2"][None] + _dot3(g2, osh))
    bz = (1.0 - bx) - by
    live = ~(o[:, 0:1] > DEAD)
    ok = ((torch.minimum(torch.minimum(t, bx), torch.minimum(by, bz)) >= 0.0)
          & (t < t_seed[:, None]) & (f["gid"][None] != excl[:, None]) & live)
    return ok, t


def closest_hit_tris_plain(pt: PackedTris, n_chunks: int, o, d, excl_idx, t_init):
    """Plain version of the closest-hit kernel: (t, gid, ent) with t = BIG,
    gid = ent = 0 where no slot beats t_init."""
    f = _slots(pt, n_chunks)
    n = o.shape[0]
    t_out = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    gid_out = torch.zeros(n, dtype=torch.int32, device=o.device)
    ent_out = torch.zeros(n, dtype=torch.int32, device=o.device)
    live = torch.nonzero(~(o[:, 0] > DEAD))[:, 0]  # dead lanes are misses
    for a, b in _lane_steps(live.shape[0], f["gid"].shape[0], o.device):
        ix = live[a:b]
        ok, t = _row_test(f, o[ix], d[ix], excl_idx[ix], t_init[ix])
        tm = torch.where(ok, t, float("inf"))
        arg = torch.argmin(tm, dim=1)  # first index among equal minima
        tmin = torch.gather(tm, 1, arg[:, None])[:, 0]
        found = tmin < float("inf")
        t_out[ix] = torch.where(found, tmin, BIG)
        gid_out[ix] = torch.where(found, f["gid"][arg], 0)
        ent_out[ix] = torch.where(found, f["ent"][arg], 0)
    return t_out, gid_out, ent_out


def occludes_tris_plain(pt: PackedTris, n_chunks: int, o, d, excl_idx,
                        excl_ent, t_max):
    """Plain version of the any-hit kernel: True where some slot with gid !=
    excl and ent != excl_ent is hit at t < t_max.  A lane seeded with t_max
    == 0 reports occluded, as the kernel's collapsed-t output does."""
    f = _slots(pt, n_chunks)
    occ = t_max == 0.0
    live = torch.nonzero(~(o[:, 0] > DEAD) & (t_max > 0.0))[:, 0]
    for a, b in _lane_steps(live.shape[0], f["gid"].shape[0], o.device):
        ix = live[a:b]
        ok, _ = _row_test(f, o[ix], d[ix], excl_idx[ix], t_max[ix])
        ok = ok & (f["ent"][None] != excl_ent[ix, None])
        occ[ix] |= ok.any(dim=1)
    return occ


# ---------------------------------------------------------------------------
# CUDA kernels: checks and launches (native.py).
# ---------------------------------------------------------------------------


def _check_launch(pt: PackedTris, n_chunks, o, d, excl_idx, lane_args) -> int:
    """What the walks take: the table and its meta, (R, 128) and (C, 128)
    f32 on the lanes' device, the chunk count within the meta's rows, the
    hierarchy, (M, NODE_FLOATS) f32 with a root, the three 16-byte aligned
    (read as float4), and the lanes (``native.check_rays``).  Returns the
    lane count."""
    dev = o.device
    native.check("tris", pt.tris, torch.float32, (pt.tris.shape[0], 128), dev,
                 align16=True)
    native.check("chunk_meta", pt.chunk_meta, torch.float32,
                 (pt.chunk_meta.shape[0], 128), dev, align16=True)
    if not 0 <= n_chunks <= pt.chunk_meta.shape[0]:
        raise ValueError(f"n_chunks {n_chunks} exceeds the meta's "
                         f"{pt.chunk_meta.shape[0]} rows")
    if pt.nodes is None:
        raise ValueError("the table has no hierarchy (nodes): pack it with "
                         "pack_chunked")
    native.check("nodes", pt.nodes, torch.float32, (pt.nodes.shape[0], NODE_FLOATS), dev,
                 align16=True)
    if pt.nodes.shape[0] == 0:
        raise ValueError("the hierarchy has no root")
    return native.check_rays(o, d, excl_idx, lane_args)


def walk_closest_hit(pt: PackedTris, n_chunks: int, o, d, excl_idx, t_init, key: str):
    """Launch the closest-hit walk on CUDA tensors (checks first; raises, never
    falls back), counted under `key`: the walk of closest_hit_tris (K3) and
    of chunk_scan.closest_hit_chunked (K7), each under its own key."""
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    n = _check_launch(pt, n_chunks, o, d, excl_idx, [("t_init", t_init, torch.float32)])
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    gid = torch.empty(n, dtype=torch.int32, device=o.device)
    ent = torch.empty(n, dtype=torch.int32, device=o.device)
    if n:
        native.launch("tri_closest_hit", key, o.device, pt.tris, pt.chunk_meta, pt.nodes,
                      o, d, excl_idx, t_init, n, t, gid, ent)
    return t, gid, ent


def walk_any_hit(pt: PackedTris, n_chunks: int, o, d, excl_idx, excl_ent, t_max,
                 key: str):
    """Launch the any-hit walk on CUDA tensors (checks first; raises, never
    falls back), counted under `key`: the walk of occludes_tris (K4) and of
    chunk_scan.occludes_chunked (K9)."""
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    n = _check_launch(pt, n_chunks, o, d, excl_idx, [("excl_ent", excl_ent, torch.int32),
                                                     ("t_max", t_max, torch.float32)])
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        native.launch("tri_any_hit", key, o.device, pt.tris, pt.chunk_meta, pt.nodes, o, d,
                      excl_idx, excl_ent, t_max, n, occ)
    return occ


def closest_hit_tris(pt: PackedTris, n_chunks: int, o, d, excl_idx, t_init):
    """Closest triangle hit per lane: (t, gid, ent), t == BIG (gid = ent = 0)
    where nothing beats t_init.  o, d (N,3) f32; excl_idx (N,) i32 triangle
    id to skip (-1 none); t_init (N,) f32.  The outputs carry no gradient."""
    o, d, t_init = cut(o, d, t_init)
    if o.device.type == "cpu":
        return closest_hit_tris_plain(pt, n_chunks, o, d, excl_idx, t_init)
    return walk_closest_hit(pt, n_chunks, o, d, excl_idx, t_init, "tri_closest_hit")


def occludes_tris(pt: PackedTris, n_chunks: int, o, d, excl_idx, excl_ent, t_max):
    """Any-hit occlusion per lane (bool): some triangle other than excl_idx,
    of an entity other than excl_ent, is hit at t < t_max.  The output
    carries no gradient."""
    o, d, t_max = cut(o, d, t_max)
    if o.device.type == "cpu":
        return occludes_tris_plain(pt, n_chunks, o, d, excl_idx, excl_ent, t_max)
    return walk_any_hit(pt, n_chunks, o, d, excl_idx, excl_ent, t_max, "tri_any_hit")
