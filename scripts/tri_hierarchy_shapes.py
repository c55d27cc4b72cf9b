#!/usr/bin/env python3
"""Count what the triangle walk kernels (K3/K4) would do on two shapes of
box hierarchy over the same table rows, to choose the shape.

    python scripts/tri_hierarchy_shapes.py [--lanes 192]

For doom_standin and dragon_standin, packed as the scene build packs them
(8 and 20 rows per chunk), two trees over the rows, one row a leaf:
  bvh      the mesh BVH's own binary tree (what pack_chunked builds);
  halving  an implicit tree over contiguous row ranges, each range halved.
Each tree is walked as csrc/tri_traverse.cu walks it (front to back, a
per-lane stack, pruning against the running best), lane by lane in f32 by
the emulation that the tests hold against the plain versions
(tests/tri_walk_cases.py::walk), on primary camera rays (random pixels of
the 720x480 frame) and on incoherent rays from inside the mesh's box.  Printed per tree: its levels; per tree
and ray kind: box tests, rows entered and stack entries used, per lane
(means and the largest).
Every lane's answer is checked against the plain closest-hit version.
Runs on the CPU; a count, not a time.
"""

from __future__ import annotations

import argparse
import os
import sys
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))  # the walk emulation the tests use

from paths_tpu_torch import camera as C  # noqa: E402
from paths_tpu_torch.ops import tri_traverse as TT  # noqa: E402
from paths_tpu_torch.render import gen_camera_rays  # noqa: E402
from paths_tpu_torch.scene.build import build_scene  # noqa: E402
from paths_tpu_torch.scene.yaml_loader import load_scene_description  # noqa: E402
from tri_walk_cases import BIG, flat_over, walk  # noqa: E402


def levels(nodes):
    """The tree's levels (nodes on its longest root-to-leaf path)."""
    ref, aux = nodes[:, 3].astype(np.int64), nodes[:, 7].astype(np.int64)
    level, n = np.array([0]), 0
    while len(level):
        n += 1
        inner = level[ref[level] >= 0]
        level = np.concatenate([ref[inner], aux[inner]])
    return n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=192, help="lanes of each ray kind")
    args = ap.parse_args()
    torch.set_num_threads(4)
    rng = np.random.default_rng(0)
    for name in ("doom_standin", "dragon_standin"):
        sd = load_scene_description(os.path.join(REPO, "scenes", f"{name}.yml"))
        static, scene, cam = build_scene(sd, device="cpu", bvh_threshold=0)
        flat = types.SimpleNamespace(**{k: getattr(scene.bvh, k).numpy()
                                        for k in ("prim_count", "prim_start", "miss_link")})
        tris = [getattr(scene, f"tri_{k}").double().numpy() for k in ("v0", "v1", "v2", "n")]
        pt, nc, rows_per_chunk = TT.pack_tris(flat, *tris, ent=scene.tri_ent.numpy())
        sizes = flat.prim_count[flat.prim_count > 0]
        half, _ = TT.pack_chunked(flat_over(sizes), *tris,
                                  ent=scene.tri_ent.numpy(), rows_per_chunk=rows_per_chunk)
        assert torch.equal(half.tris, pt.tris) and torch.equal(half.chunk_meta, pt.chunk_meta)
        n = args.lanes
        cam = C.resize(cam, 720, 480)
        pix = torch.as_tensor(rng.integers(0, 720 * 480, n))
        po, pd, _ = gen_camera_rays(cam, (pix % 720).int(), (pix // 720).int(), pix,
                                    torch.zeros_like(pix), 0)
        meta = pt.chunk_meta[:nc]
        lo, hi = meta[:, 0:3].amin(0), meta[:, 3:6].amax(0)
        io = lo + torch.as_tensor(rng.uniform(size=(n, 3)), dtype=torch.float32) * (hi - lo)
        idir = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
        idir = idir / idir.norm(dim=1, keepdim=True)
        print(f"{name}: {static.n_tris} triangles, {int((flat.prim_count > 0).sum())} rows, "
              f"{nc} chunks of {rows_per_chunk} rows; {n} lanes of each ray kind; "
              f"levels: bvh {levels(pt.nodes.numpy())}, halving {levels(half.nodes.numpy())}")
        f = TT._slots(pt, nc)
        for kind, o, d in (("primary", po, pd), ("incoherent", io, idir)):
            o, d = o.float().contiguous(), d.float().contiguous()
            excl = torch.full((n,), -1, dtype=torch.int32)
            want = TT.closest_hit_tris_plain(pt, nc, o, d, excl, torch.full((n,), float(BIG)))
            counts = {"bvh": [], "halving": []}
            for a in range(0, n, 16):
                met, t = TT._row_test(f, o[a:a + 16], d[a:a + 16], excl[a:a + 16],
                                      torch.full((min(16, n - a),), float("inf")))
                for i in range(met.shape[0]):
                    for shape, table in (("bvh", pt), ("halving", half)):
                        w = walk(table.nodes.numpy(), met[i].numpy(), t[i].numpy(),
                                 o[a + i].numpy(), d[a + i].numpy(), BIG)
                        assert np.float32(w.t).tobytes() == want[0][a + i].numpy().tobytes()
                        counts[shape].append((w.boxes, w.rows, w.depth))
            hits = int((want[0] < BIG).sum())
            for shape, c in counts.items():
                c = np.array(c)
                print(f"  {kind} ({hits} hits), {shape}: box tests {c[:, 0].mean():.1f} "
                      f"(max {c[:, 0].max()}), rows entered {c[:, 1].mean():.2f} "
                      f"(max {c[:, 1].max()}), stack entries max {c[:, 2].max()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
