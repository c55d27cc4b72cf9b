"""Stackless BVH traversal as a vectorised gather + select loop (port of
``paths_tpu/bvh/traverse.py``).

Every ray carries a node cursor through the preorder layout that
``bvh/build.py`` builds, ``cursor = box hit ? hit_link : miss_link``, with
closest-hit pruning folded into the slab test (tmin < t_best).  A leaf tests
a fixed LEAF_SIZE block of triangles with ``geom/triangle.py::intersect``.
This is the BVH route's traversal on the CPU, as in the reference (which has
no kernel for it); on the card the route takes the skip-link kernel K6
(``ops/packet_traverse.py``).  Unlike the reference's loop, which runs every
lane until the last one finishes, finished lanes leave the loop: the same
answer for each lane.
"""

from __future__ import annotations

import torch

from paths_tpu_torch.bvh.build import LEAF_SIZE
from paths_tpu_torch.geom import triangle as GT

BIG = 3.4e38
KIND_TRI = 2


@torch.no_grad()
def closest_hit_bvh(scene, o, d, excl_kind, excl_idx, t_init):
    """Closest triangle hit via the skip-link BVH ``scene.bvh``.

    o, d (N, 3); t_init (N,) the best distance so far (the sphere pass: hits
    beyond it are pruned).  Returns (t, idx), t == BIG where nothing beat
    t_init.  A lane with excl_kind == KIND_TRI skips triangle excl_idx."""
    bvh = scene.bvh
    n = o.shape[0]
    n_tris = scene.tri_v0.shape[0]
    inv_d = 1.0 / d
    excl_i = torch.where(excl_kind == KIND_TRI, excl_idx, -1)
    t_best = t_init.to(torch.float32).clone()
    i_best = torch.zeros(n, dtype=torch.int32, device=o.device)
    lanes = torch.arange(n, device=o.device)
    cursor = torch.zeros(n, dtype=torch.int64, device=o.device)
    while lanes.numel():
        ol, dl, tb, ib = o[lanes], d[lanes], t_best[lanes], i_best[lanes]
        t0 = (bvh.node_min[cursor] - ol) * inv_d[lanes]
        t1 = (bvh.node_max[cursor] - ol) * inv_d[lanes]
        tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
        tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
        hit = (tmin < tmax) & (tmin < tb) & (tmax > 0.0)
        count = bvh.prim_count[cursor]
        start = bvh.prim_start[cursor]
        do_leaf = hit & (count > 0)
        for k in range(LEAF_SIZE):
            pidx = torch.clamp_max(start + k, n_tris - 1)
            t, h, *_ = GT.intersect(ol, dl, scene.tri_v0[pidx], scene.tri_v1[pidx],
                                    scene.tri_v2[pidx], scene.tri_n[pidx])
            ok = do_leaf & (k < count) & h & (t < tb) & (pidx != excl_i[lanes])
            tb = torch.where(ok, t, tb)
            ib = torch.where(ok, pidx, ib)
        t_best[lanes], i_best[lanes] = tb, ib
        cursor = torch.where(hit, bvh.hit_link[cursor], bvh.miss_link[cursor]).long()
        keep = cursor >= 0
        lanes, cursor = lanes[keep], cursor[keep]
    t_out = torch.where(t_best < t_init, t_best, torch.full_like(t_best, BIG))
    return t_out, i_best
