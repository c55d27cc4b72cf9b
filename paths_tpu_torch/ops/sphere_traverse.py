"""Small-sphere traversal: the packed sphere table, the CUDA closest-hit and
any-hit kernels that walk it, and their plain PyTorch versions.

Ports ``paths_tpu/ops/pallas_traverse.py::pack_spheres_chunked`` (bit-exact)
and the sphere forms of ``paths_tpu/ops/sorted_traverse.py``
(``closest_hit_spheres_sorted`` -> ``closest_hit_spheres``,
``occludes_spheres_sorted`` -> ``occludes_spheres``).  The kernels in
``csrc/sphere_traverse.cu`` replace ``sorted_traverse.py::_make_sorted_kernel``
(sphere forms, row test ``pallas_traverse.py::_sphere_row_test``).

What bounds them on an H100: FP32 issue.  A (ray, slot) pair costs about 25
FP32 operations while a lane moves about 36 bytes of ray input and output,
and the table (16 KB at 500 spheres) stays in cache.  The closest-hit
kernel walks a tree over the morton-ordered slots (``PackedSpheres.nodes``,
built on every device; ``_slot_tree``) front to back per lane with the
shared walk of ``csrc/walk.cuh``, pruning against its running best, with a
(t, slot index) tie rule, so its answer equals the plain version's
first-index argmin.  The any-hit kernel walks the same tree with the same
walk, pruning against t_max, and returns at the first occluder.  The
arithmetic is IEEE with exactly three fused multiply-adds -- where XLA's
CPU compilation of the reference kernel contracts (see ``_row_test``) --
so the plain versions, the kernels and the reference in interpret mode
agree bit for bit.

Dispatch: a wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises -- it never falls back.  Each
wrapper's launches are counted under its own key of
``profiling.LAUNCHES``; ``ops/chunk_scan.py``'s K8 and K9 launch the
closest-hit and any-hit walks through ``walk_closest_hit`` and
``walk_any_hit`` under their keys, not these.  The kernels are declared,
built at first use and launched by ``native.py``.

Gradients: traversal is a discrete selector, and every public traversal
wrapper of ``ops/`` (K1-K9) detaches its rays and seeds (o, d, t_init,
t_max) before it dispatches, so its outputs carry no gradient on any device
-- on the card the launch makes new tensors anyway, on the CPU the plain
version would otherwise differentiate t through o and d.  This is the
counterpart of the reference launchers' ``stop_gradient``
(``sorted_traverse.py:687-692``, ``pallas_traverse.py:788-790``,
``:931-933``, ``:1058``).  The integrator recomputes shading
differentiably at the returned hit, and its scans (the double-single
spheres of ``ops/sphere_ds.py``, whose closest hit's t is recomputed
differentiably at the chosen sphere, and ``integrator._scan_tris``) stay
differentiable, as the reference's XLA scans are (``grad.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from paths_tpu_torch import native
from paths_tpu_torch.math import vec

SPH_STRIDE = 8  # floats per sphere slot: [cx cy cz r^2 gid ent 0 0]
SPH_PER_ROW = 128 // SPH_STRIDE  # 16
# Rows per chunk of the scene build's table (2 rows = 32 sphere slots), as
# the reference's sorted walk; K8's and K9's tables take 16
# (ops/chunk_scan.py).
SPH_ROWS_PER_CHUNK = 2
BIG = 3.4e38
DEAD = 1e29  # a lane whose origin x is past this is dead (a miss)
# The walk kernels' tree over the slots (PackedSpheres.nodes): at
# most SPH_LEAF slots a leaf, a range split at its highest differing morton
# bit (scripts/sphere_hierarchy_shapes.py: the fewest box and slot tests
# per lane on stress-500, and the fastest K1 on an H100), floats per node
# ([lo.xyz ref | hi.xyz aux]), the relative pad of a leaf box
# (csrc/row_tests.cuh kBoxPad) and the walk's stack (csrc/walk.cuh kStack),
# which bounds the tree's depth.
SPH_LEAF = 4
SPH_SPLIT = "morton"
NODE_FLOATS = 8
BOX_PAD = 1e-4
WALK_STACK = 64


class PackedSpheres(NamedTuple):
    tris: torch.Tensor  # (R, 128) f32 rows of 16 sphere slots
    chunk_meta: torch.Tensor  # (Cpad, 128) f32: [lo.xyz, hi.xyz, row0, nrows]
    # (M, NODE_FLOATS) f32, the walk kernels' tree over the slots
    # (_slot_tree); the reference has none.  None only for a table rebuilt
    # from the reference's arrays (scene/types.py::scene_from_numpy): the
    # plain versions do not read it, the kernels refuse a table without it.
    nodes: Optional[torch.Tensor] = None


# The fields that the reference's table (pallas_traverse.py::ChunkedSpheres)
# has too, bit for bit.
REFERENCE_FIELDS = ("tris", "chunk_meta")


def _split_at(codes, a: int, b: int, split: str) -> int:
    """Where the slot range [a, b) splits: at the first code with the
    highest bit in which codes[a] and codes[b - 1] differ set (split
    "morton"; codes ascend), or halfway (split "halving", and "morton" on a
    range of one code)."""
    x = int(codes[a]) ^ int(codes[b - 1])
    if split == "morton" and x:
        bit = 1 << (x.bit_length() - 1)
        return a + int(np.argmax((codes[a:b] & bit) != 0))
    return (a + b) // 2


def _slot_tree(lo, hi, codes, leaf: int = SPH_LEAF, split: str = SPH_SPLIT):
    """The walk kernels' tree over the table's slots (csrc/walk.cuh):
    a binary tree over contiguous ranges of the morton-ordered slots, in
    preorder (root 0), as (M, NODE_FLOATS) f32 rows [lo.xyz ref | hi.xyz
    aux].  A range of at most `leaf` slots is a leaf, ref = -1 - its first
    slot and aux = its slot count; a larger one is split (_split_at) into
    an inner node with ref = its left child (the next node) and aux = its
    right child.  lo, hi (S, 3) f32: each sphere's box.  A leaf's box is
    its spheres' box padded by kBoxPad's rule, pad = BOX_PAD * (|lo| + |hi|
    + (hi - lo)) + 1e-6 per axis in f32, an inner node's the union of its
    children's, so f32 rounding of a box can only keep a slot.  Raises if
    the tree is deeper than WALK_STACK inner levels."""
    rows = []  # [lo(3), ref, hi(3), aux] per node, in preorder

    def node(a, b, depth):
        if depth > WALK_STACK:
            raise ValueError(f"the sphere tree is deeper than the walk stack "
                             f"({WALK_STACK} inner levels)")
        i = len(rows)
        rows.append(None)
        if b - a <= leaf:
            blo, bhi = lo[a:b].min(0), hi[a:b].max(0)
            pad = np.float32(BOX_PAD) * (np.abs(blo) + np.abs(bhi) + (bhi - blo)) \
                + np.float32(1e-6)
            rows[i] = (blo - pad, -1 - a, bhi + pad, b - a)
            return rows[i][0], rows[i][2]
        m = _split_at(codes, a, b, split)
        llo, lhi = node(a, m, depth + 1)
        right = len(rows)
        rlo, rhi = node(m, b, depth + 1)
        rows[i] = (np.minimum(llo, rlo), i + 1, np.maximum(lhi, rhi), right)
        return rows[i][0], rows[i][2]

    node(0, len(lo), 0)
    out = np.zeros((len(rows), NODE_FLOATS), np.float32)
    for i, (blo, ref, bhi, aux) in enumerate(rows):
        out[i, 0:3], out[i, 3], out[i, 4:7], out[i, 7] = blo, ref, bhi, aux
    return out


def morton_codes(centers) -> np.ndarray:
    """30-bit morton codes of the centres (S, 3), quantised to 10 bits an
    axis over their bounding box: the packer's sort key."""
    c = np.asarray(centers, np.float64)
    lo, hi = c.min(0), c.max(0)
    ext = np.where(hi - lo > 0, hi - lo, 1.0)
    q = np.clip(((c - lo) / ext * 1023).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def pack_spheres_chunked(centers, radii, ent=None, gid0: int = 0,
                         rows_per_chunk: int = SPH_ROWS_PER_CHUNK, device="cpu"):
    """Pack spheres (numpy (S,3), (S,)) into chunks of rows_per_chunk rows.
    Slot layout
    [cx cy cz r^2 gid ent 0 0]; empty slots have r^2 = -1 and gid = -1.
    Spheres are morton-sorted so chunk AABBs stay tight; the gid written is
    gid0 + position in the sorted order.  Returns (PackedSpheres, n_chunks,
    order).  Rows and meta are bit-exact with the reference package's
    packer; the port adds the walk kernels' tree over the slots
    (_slot_tree)."""
    S = len(radii)
    c = np.asarray(centers, np.float64)
    r = np.asarray(radii, np.float64)
    if ent is None:
        ent = np.zeros(S, np.int64)
    ent = np.asarray(ent)
    codes = morton_codes(c)
    order = np.argsort(codes)
    c, r, ent, codes = c[order], r[order], ent[order], codes[order]

    R = -(-S // SPH_PER_ROW)
    n_chunks = -(-R // rows_per_chunk)
    # Every row, padding included, gets the canonical empty fill: an
    # all-zero row would act as r=0 spheres at the origin with gid 0.
    rpad = -(-max(n_chunks * rows_per_chunk, 1) // 8) * 8
    rows = np.zeros((rpad, 128), np.float32)
    rows[:, 3::SPH_STRIDE] = -1.0  # r^2 = -1 in empty slots
    rows[:, 4::SPH_STRIDE] = -1.0
    for i in range(S):
        row, slot = divmod(i, SPH_PER_ROW)
        s = slot * SPH_STRIDE
        rows[row, s: s + 3] = c[i]
        rows[row, s + 3] = r[i] * r[i]
        rows[row, s + 4] = gid0 + i
        rows[row, s + 5] = ent[i]

    meta = np.zeros((n_chunks, 128), np.float32)
    for k in range(n_chunks):
        i0 = k * rows_per_chunk * SPH_PER_ROW
        i1 = min(i0 + rows_per_chunk * SPH_PER_ROW, S)
        cc, rr = c[i0:i1], r[i0:i1, None]
        meta[k, 0:3] = (cc - rr).min(0)
        meta[k, 3:6] = (cc + rr).max(0)
        meta[k, 6] = k * rows_per_chunk
        meta[k, 7] = min((k + 1) * rows_per_chunk, R) - k * rows_per_chunk
    meta = np.pad(meta, ((0, (-len(meta)) % 8), (0, 0)))  # 8-row multiple
    nodes = _slot_tree((c - r[:, None]).astype(np.float32),
                       (c + r[:, None]).astype(np.float32), codes) if S else None
    packed = PackedSpheres(tris=torch.from_numpy(rows).to(device),
                           chunk_meta=torch.from_numpy(meta).to(device),
                           nodes=None if nodes is None else torch.from_numpy(nodes).to(device))
    return packed, n_chunks, order


# ---------------------------------------------------------------------------
# Plain PyTorch versions: flat brute force over every slot of the table, in
# the kernel's arithmetic order, with a first-index tie-break.  Used on CPU
# tensors, and by the tests and the chip smoke run to hold the kernels.
# ---------------------------------------------------------------------------

# Lanes per step of the plain versions (bounds the (lanes, slots) temporaries).
_PLAIN_PAIRS_PER_STEP = 1 << 22


def _slot_fields(table: torch.Tensor):
    slots = table.reshape(-1, SPH_STRIDE)
    return (slots[:, 0], slots[:, 1], slots[:, 2], slots[:, 3],
            slots[:, 4].to(torch.int32), slots[:, 5].to(torch.int32))


def _fma(a, b, c):
    """Correctly rounded f32 fused multiply-add.  The product of two f32 is
    exact in f64; the f64 sum is made round-to-odd (from its exact error
    term) so that the one rounding to f32 is correct -- a plain f64 sum
    would round twice and miss a true FMA now and then."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # p + c == s + err exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _row_test(fields, o, d, excl, t_seed):
    """(lanes, slots) qualifying mask and t, as _sphere_row_test computes
    them against the lane's seed -- with the three fused multiply-adds the
    reference kernel gets when XLA compiles it for the CPU, which the CUDA
    kernel issues as fmaf."""
    cx, cy, cz, r2, gid, _ = fields
    ocx = o[:, 0:1] - cx
    ocy = o[:, 1:2] - cy
    ocz = o[:, 2:3] - cz
    b = _fma(d[:, 2:3], ocz, _fma(d[:, 0:1], ocx, d[:, 1:2] * ocy))
    c2 = _fma(ocz, ocz, _fma(ocx, ocx, ocy * ocy)) - r2
    disc = _fma(b, b, -c2)
    root = vec.sqrt(torch.clamp_min(disc, 0.0))
    d1 = -b + root
    d2 = -b - root
    t = torch.where(d2 > 0.0, d2, d1)
    live = ~(o[:, 0:1] > DEAD)
    ok = ((disc >= 0.0) & (d1 >= 0.0) & (t < t_seed[:, None])
          & (gid != excl[:, None]) & (gid >= 0) & live)
    return ok, t


def _lane_steps(n: int, n_slots: int):
    step = max(1, _PLAIN_PAIRS_PER_STEP // max(n_slots, 1))
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def closest_hit_spheres_plain(table, o, d, excl_idx, t_init):
    """Plain version of the closest-hit kernel: (t, gid, ent) with t = BIG,
    gid = ent = 0 where no slot beats t_init."""
    fields = _slot_fields(table)
    n = o.shape[0]
    t_out = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    gid_out = torch.zeros(n, dtype=torch.int32, device=o.device)
    ent_out = torch.zeros(n, dtype=torch.int32, device=o.device)
    for a, b in _lane_steps(n, fields[0].shape[0]):
        ok, t = _row_test(fields, o[a:b], d[a:b], excl_idx[a:b], t_init[a:b])
        tm = torch.where(ok, t, float("inf"))
        arg = torch.argmin(tm, dim=1)  # first index among equal minima
        tmin = torch.gather(tm, 1, arg[:, None])[:, 0]
        found = tmin < float("inf")
        t_out[a:b] = torch.where(found, tmin, BIG)
        gid_out[a:b] = torch.where(found, fields[4][arg], 0)
        ent_out[a:b] = torch.where(found, fields[5][arg], 0)
    return t_out, gid_out, ent_out


def occludes_spheres_plain(table, o, d, excl_idx, excl_ent, t_max):
    """Plain version of the any-hit kernel: True where some slot with
    gid != excl and ent != excl_ent is hit at t < t_max.  A lane seeded with
    t_max == 0 reports occluded, as the kernel's collapsed-t output does."""
    fields = _slot_fields(table)
    n = o.shape[0]
    occ = t_max == 0.0
    for a, b in _lane_steps(n, fields[0].shape[0]):
        ok, _ = _row_test(fields, o[a:b], d[a:b], excl_idx[a:b], t_max[a:b])
        ok = ok & (fields[5] != excl_ent[a:b, None])
        occ[a:b] |= ok.any(dim=1)
    return occ


# ---------------------------------------------------------------------------
# CUDA kernels: checks and launches (native.py).
# ---------------------------------------------------------------------------


def _check_launch(ps: PackedSpheres, n_chunks, o, d, excl_idx, lane_args) -> int:
    """What the walks take: the table, (R, 128) f32, and its meta on the
    lanes' device, the chunk count within the meta's rows, the tree,
    (M, NODE_FLOATS) f32 with a root, the table and tree 16-byte aligned
    (read as float4), and the lanes (``native.check_rays``).  Returns the
    lane count."""
    dev = o.device
    native.check("table", ps.tris, torch.float32, (ps.tris.shape[0], 128), dev,
                 align16=True)
    native.check("chunk_meta", ps.chunk_meta, torch.float32,
                 (ps.chunk_meta.shape[0], 128), dev)
    if not 0 <= n_chunks <= ps.chunk_meta.shape[0]:
        raise ValueError(f"n_chunks {n_chunks} exceeds the meta's "
                         f"{ps.chunk_meta.shape[0]} rows")
    if ps.nodes is None:
        raise ValueError("the table has no tree (nodes): pack it with "
                         "pack_spheres_chunked")
    native.check("nodes", ps.nodes, torch.float32, (ps.nodes.shape[0], NODE_FLOATS), dev,
                 align16=True)
    if ps.nodes.shape[0] == 0:
        raise ValueError("the tree has no root")
    return native.check_rays(o, d, excl_idx, lane_args)


def cut(*xs):
    """The wrappers' gradient cut (module docstring): each tensor detached."""
    return tuple(x.detach() for x in xs)


def closest_hit_spheres(ps: PackedSpheres, n_chunks: int, o, d, excl_idx,
                        t_init):
    """Closest small-sphere hit per lane: (t, gid, ent), t == BIG (gid = ent
    = 0) where nothing beats t_init, the first slot among the nearest.  o, d
    (N,3) f32; excl_idx (N,) i32 sphere id to skip (-1 none); t_init (N,)
    f32.  The kernel walks ps.nodes (n_chunks is checked, not read).  The
    outputs carry no gradient."""
    o, d, t_init = cut(o, d, t_init)
    if o.device.type == "cpu":
        return closest_hit_spheres_plain(ps.tris, o, d, excl_idx, t_init)
    return walk_closest_hit(ps, n_chunks, o, d, excl_idx, t_init, "sphere_closest_hit")


def walk_closest_hit(ps: PackedSpheres, n_chunks: int, o, d, excl_idx, t_init,
                     key: str):
    """Launch the closest-hit walk on CUDA tensors (checks first; raises,
    never falls back), counted under `key`: the walk of closest_hit_spheres
    (K1) and of chunk_scan.closest_hit_spheres (K8), each under its own
    key."""
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    n = _check_launch(ps, n_chunks, o, d, excl_idx, [("t_init", t_init, torch.float32)])
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    gid = torch.empty(n, dtype=torch.int32, device=o.device)
    ent = torch.empty(n, dtype=torch.int32, device=o.device)
    if n:
        native.launch("sphere_closest_hit", key, o.device, ps.tris, ps.nodes, o, d,
                      excl_idx, t_init, n, t, gid, ent)
    return t, gid, ent


def walk_any_hit(ps: PackedSpheres, n_chunks: int, o, d, excl_idx, excl_ent,
                 t_max, key: str):
    """Launch the any-hit walk on CUDA tensors (checks first; raises, never
    falls back), counted under `key`: the walk of occludes_spheres (K2) and
    of chunk_scan.occludes_spheres (K9), each under its own key."""
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    n = _check_launch(ps, n_chunks, o, d, excl_idx, [("excl_ent", excl_ent, torch.int32),
                                                     ("t_max", t_max, torch.float32)])
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        native.launch("sphere_any_hit", key, o.device, ps.tris, ps.nodes, o, d, excl_idx,
                      excl_ent, t_max, n, occ)
    return occ


def occludes_spheres(ps: PackedSpheres, n_chunks: int, o, d, excl_idx,
                     excl_ent, t_max):
    """Any-hit occlusion per lane (bool): some sphere other than excl_idx,
    of an entity other than excl_ent, is hit at t < t_max (a lane seeded
    with t_max == 0 reports occluded).  The kernel walks ps.nodes (n_chunks
    is checked, not read).  The output carries no gradient."""
    o, d, t_max = cut(o, d, t_max)
    if o.device.type == "cpu":
        return occludes_spheres_plain(ps.tris, o, d, excl_idx, excl_ent, t_max)
    return walk_any_hit(ps, n_chunks, o, d, excl_idx, excl_ent, t_max, "sphere_any_hit")
