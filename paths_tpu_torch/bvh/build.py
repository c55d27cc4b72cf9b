"""Host-side BVH construction -> flattened skip-link arrays (port of
``paths_tpu/bvh/build.py``).

Top-down binned SAH (16 bins on the longest centroid axis, median fallback),
leaves of at most LEAF_SIZE triangles, laid out in preorder with hit/miss
links.  The port keeps only the builder's *order*, its leaves and its node
boxes: the triangle tables are the BVH's leaf rows cut into chunks
(``ops/tri_traverse.py``), so the order fixes triangle ids and chunk
membership.

Dispatch as the reference's: more than 512 triangles go to the C++ builder
(``csrc/bvh_builder.cc``, a copy of the reference's, built with g++ at first
use and bound with ctypes), which boxes in f32; at most 512 go to the Python
builder below, which keeps f64.  The two give different orders on the same
mesh, so the dispatch is part of the port's contract.  A failed C++ build
raises; there is no switch to Python.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from paths_tpu_torch import native

# One leaf = one 8-slot triangle row (ops/tri_traverse.PACK_LEAF).
LEAF_SIZE = 8
N_BINS = 16
# More triangles than this go to the C++ builder.
NATIVE_MIN_TRIS = 512


@dataclass
class FlatBvh:
    node_min: np.ndarray  # (N, 3) f32
    node_max: np.ndarray  # (N, 3) f32
    hit_link: np.ndarray  # (N,) i32
    miss_link: np.ndarray  # (N,) i32
    prim_start: np.ndarray  # (N,) i32 (leaf primitive range; count==0 -> inner)
    prim_count: np.ndarray  # (N,) i32
    order: np.ndarray  # (T,) i64: new-to-old triangle permutation
    n_nodes: int
    depth: int


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray,
              leaf_size: int = LEAF_SIZE) -> FlatBvh:
    """tri_min/tri_max: (T, 3) per-triangle boxes (f64 ok)."""
    if len(tri_min) > NATIVE_MIN_TRIS:
        return _build_bvh_native(tri_min, tri_max, leaf_size)
    return _build_bvh_py(tri_min, tri_max, leaf_size)


def _build_bvh_native(tri_min, tri_max, leaf_size) -> FlatBvh:
    lib = native.library("bvh_builder.cc")
    n = len(tri_min)
    tmin = np.ascontiguousarray(tri_min, np.float32)
    tmax = np.ascontiguousarray(tri_max, np.float32)
    cap = 2 * n + 2
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    links = [np.empty(cap, np.int32) for _ in range(4)]  # hit, miss, start, count
    order = np.empty(n, np.int64)
    n_nodes = ctypes.c_int64(0)
    depth = ctypes.c_int32(0)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    rc = lib.paths_build_bvh(
        tmin.ctypes.data_as(fp), tmax.ctypes.data_as(fp), n, leaf_size,
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        *(a.ctypes.data_as(ip) for a in links),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(n_nodes), ctypes.byref(depth),
    )
    if rc != 0:
        raise RuntimeError(f"the C++ BVH builder failed (rc {rc}) on {n} triangles")
    m = n_nodes.value
    hit, miss, start, count = (a[:m].copy() for a in links)
    return FlatBvh(node_min=node_min[:m].copy(), node_max=node_max[:m].copy(),
                   hit_link=hit, miss_link=miss, prim_start=start,
                   prim_count=count, order=order, n_nodes=m, depth=depth.value)


class _Node:
    __slots__ = ("lo", "hi", "bmin", "bmax", "left", "right")

    def __init__(self, lo, hi, bmin, bmax):
        self.lo = lo
        self.hi = hi
        self.bmin = bmin
        self.bmax = bmax
        self.left = None
        self.right = None


def _build_bvh_py(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int = LEAF_SIZE) -> FlatBvh:
    T = len(tri_min)
    centers = (tri_min + tri_max) * 0.5
    order = np.arange(T)

    def node_bounds(lo, hi):
        idx = order[lo:hi]
        return tri_min[idx].min(axis=0), tri_max[idx].max(axis=0)

    bmin, bmax = node_bounds(0, T)
    root = _Node(0, T, bmin, bmax)
    stack = [root]
    while stack:
        nd = stack.pop()
        n = nd.hi - nd.lo
        if n <= leaf_size:
            continue
        idx = order[nd.lo: nd.hi]
        c = centers[idx]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        if extent[axis] <= 0.0:
            # All centroids identical: arbitrary median split.
            mid = nd.lo + n // 2
        else:
            # Binned SAH.
            rel = (c[:, axis] - cmin[axis]) / extent[axis]
            bins = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)
            counts = np.bincount(bins, minlength=N_BINS)
            bin_min = np.full((N_BINS, 3), np.inf)
            bin_max = np.full((N_BINS, 3), -np.inf)
            for a in range(3):
                np.minimum.at(bin_min[:, a], bins, tri_min[idx][:, a])
                np.maximum.at(bin_max[:, a], bins, tri_max[idx][:, a])

            def sa(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])

            # Prefix (left) / suffix (right) accumulations over bins.
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            lcount = np.cumsum(counts)
            rcount = np.cumsum(counts[::-1])[::-1]
            costs = np.full(N_BINS - 1, np.inf)
            for s in range(N_BINS - 1):
                nl, nr = lcount[s], rcount[s + 1]
                if nl == 0 or nr == 0:
                    continue
                costs[s] = sa(lmin[s], lmax[s]) * nl + sa(rmin[s + 1], rmax[s + 1]) * nr
            s_best = int(np.argmin(costs))
            if not np.isfinite(costs[s_best]):
                mid = nd.lo + n // 2
                left_mask = None
            else:
                left_mask = bins <= s_best
                mid = nd.lo + int(left_mask.sum())
            if left_mask is not None:
                # Partition order[lo:hi] by the mask (stable).
                order[nd.lo: nd.hi] = np.concatenate([idx[left_mask], idx[~left_mask]])
            else:
                # Median split on the axis.
                part = np.argpartition(c[:, axis], n // 2)
                order[nd.lo: nd.hi] = idx[part]
        if mid <= nd.lo or mid >= nd.hi:
            mid = nd.lo + n // 2
        lmn, lmx = node_bounds(nd.lo, mid)
        rmn, rmx = node_bounds(mid, nd.hi)
        nd.left = _Node(nd.lo, mid, lmn, lmx)
        nd.right = _Node(mid, nd.hi, rmn, rmx)
        stack.append(nd.right)
        stack.append(nd.left)

    # ---- preorder flatten with skip links (iterative: trees can be deep) ----
    node_min, node_max = [], []
    hit_link, miss_link = [], []
    prim_start, prim_count = [], []
    max_depth = 0
    sizes = {}

    st = [(root, False)]
    while st:
        nd, done = st.pop()
        if nd.left is None:
            sizes[id(nd)] = 1
        elif done:
            sizes[id(nd)] = 1 + sizes[id(nd.left)] + sizes[id(nd.right)]
        else:
            st.append((nd, True))
            st.append((nd.left, False))
            st.append((nd.right, False))

    st = [(root, -1, 0)]
    while st:
        nd, next_skip, depth = st.pop()
        i = len(node_min)
        node_min.append(nd.bmin)
        node_max.append(nd.bmax)
        miss_link.append(next_skip)
        max_depth = max(max_depth, depth)
        if nd.left is None:
            prim_start.append(nd.lo)
            prim_count.append(nd.hi - nd.lo)
            hit_link.append(next_skip)
        else:
            prim_start.append(0)
            prim_count.append(0)
            hit_link.append(i + 1)
            right_idx = i + 1 + sizes[id(nd.left)]
            # Push right first so left is emitted next (preorder).
            st.append((nd.right, next_skip, depth + 1))
            st.append((nd.left, right_idx, depth + 1))

    return FlatBvh(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        hit_link=np.asarray(hit_link, np.int32),
        miss_link=np.asarray(miss_link, np.int32),
        prim_start=np.asarray(prim_start, np.int32),
        prim_count=np.asarray(prim_count, np.int32),
        order=order,
        n_nodes=len(node_min),
        depth=max_depth,
    )
