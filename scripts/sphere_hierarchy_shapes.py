#!/usr/bin/env python3
"""Count what the sphere closest-hit walk kernel (K1) would do on six shapes
of tree over the same table slots, and what the chunk walk it replaces did,
to choose the shape.

    python scripts/sphere_hierarchy_shapes.py [--lanes 256] [--cuda]

For stress-500 (the CLI's default scene), packed as the scene build packs
it, trees over contiguous ranges of the morton-ordered slots
(ops/sphere_traverse.py::_slot_tree): leaves of at most 4, 8 or 16 slots,
each range split halfway ("halving") or at the highest morton bit in which
its first and last codes differ ("morton").  Each tree is walked as
csrc/walk.cuh walks it (front to back, a per-lane stack, pruning against
the running best), lane by lane in f32 by the emulation that the tests hold
against the plain version (tests/tri_walk_cases.py::walk); the chunk walk
(each lane slab-tests the 16 chunk boxes of 32 slots in id order against
its running best and tests every slot of a chunk it enters) is counted
beside them.  Rays: primary camera rays (random pixels of the 720x480
frame) and incoherent rays from inside the spheres' box.  Printed per shape
and ray kind: box tests, slot tests and their sum per lane (means and the
largest), stack entries used and levels.  Every lane's answer is checked
against the plain closest-hit version.  Runs on the CPU; a count, not a
time.  With --cuda (on a machine with a CUDA card) it also times the K1
kernel on each tree over full 720x480 frames of primary and of incoherent
rays (CUDA events, median of 25 launches), each result held bit for bit
against the plain version, and prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))  # the walk emulation the tests use

from paths_tpu_torch import camera as C  # noqa: E402
from paths_tpu_torch.ops import sphere_traverse as ST  # noqa: E402
from paths_tpu_torch.render import gen_camera_rays  # noqa: E402
from paths_tpu_torch.scene.build import build_scene  # noqa: E402
from paths_tpu_torch.scene.stress import generate_stress_scene  # noqa: E402
from tri_walk_cases import BIG, levels, slot_range, walk  # noqa: E402


def chunk_walk(meta, n_chunks, met, t, o, d):
    """The chunk walk's counts for one lane: (box tests, slot tests)."""
    inv = np.float32(1.0) / d
    t_best, boxes, tests = BIG, 0, 0
    for k in range(n_chunks):
        m = meta[k]
        lo, hi = m[0:3], m[3:6]
        pad = np.float32(ST.BOX_PAD) * (np.abs(lo) + np.abs(hi) + (hi - lo)) + np.float32(1e-6)
        with np.errstate(invalid="ignore"):
            t0, t1 = (lo - pad - o) * inv, (hi + pad - o) * inv
        axis = ~(np.isnan(t0) | np.isnan(t1))
        tmin = np.max(np.minimum(t0, t1)[axis], initial=-BIG)
        tmax = np.min(np.maximum(t0, t1)[axis], initial=BIG)
        boxes += 1
        if not (tmin < tmax and tmin < t_best and tmax > 0):
            continue
        row0, nrows = int(m[6]), int(m[7])
        for pos in range(16 * row0, 16 * (row0 + nrows)):
            tests += 1
            if met[pos] and t[pos] < t_best:
                t_best = t[pos]
    return boxes, tests


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=256, help="lanes of each ray kind")
    ap.add_argument("--cuda", action="store_true", help="also time K1 on each tree")
    args = ap.parse_args()
    torch.set_num_threads(4)
    rng = np.random.default_rng(0)
    sd = generate_stress_scene(500)
    static, scene, cam = build_scene(sd, device="cpu")
    assert static.n_sph_big == 0
    ps, nc = scene.psph, static.sph_chunks
    c = np.array([o.sphere.center.tolist() for o in sd.objects])  # f64, as the build packs
    r = np.array([o.sphere.radius for o in sd.objects])
    codes = ST.morton_codes(c)
    order = ST.pack_spheres_chunked(c, r)[2]  # the packer's order (the scene's)
    c, r, codes = c[order], r[order], codes[order]
    lo, hi = (c - r[:, None]).astype(np.float32), (c + r[:, None]).astype(np.float32)
    shapes = {f"{split} {leaf}": ST._slot_tree(lo, hi, codes, leaf, split)
              for split in ("halving", "morton") for leaf in (4, 8, 16)}
    assert np.array_equal(shapes[f"{ST.SPH_SPLIT} {ST.SPH_LEAF}"], ps.nodes.numpy())
    n = args.lanes
    print(f"stress-500: {len(r)} spheres, {nc} chunks of {ST.SPH_ROWS_PER_CHUNK * 16} "
          f"slots; {n} lanes of each ray kind; trees: "
          + ", ".join(f"{k} {len(v)} nodes, {levels(v)} levels" for k, v in shapes.items()))
    cam = C.resize(cam, 720, 480)
    pix = torch.as_tensor(rng.integers(0, 720 * 480, n))
    po, pd, _ = gen_camera_rays(cam, (pix % 720).int(), (pix // 720).int(), pix,
                                torch.zeros_like(pix), 0)
    io = torch.as_tensor(rng.uniform([-50, -50, 0], [50, 50, 100], (n, 3)), dtype=torch.float32)
    idir = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    idir = idir / idir.norm(dim=1, keepdim=True)
    fields = ST._slot_fields(ps.tris)
    meta = ps.chunk_meta.numpy()
    for kind, o, d in (("primary", po, pd), ("incoherent", io, idir)):
        o, d = o.float().contiguous(), d.float().contiguous()
        excl = torch.full((n,), -1, dtype=torch.int32)
        t_init = torch.full((n,), float(BIG))
        want = ST.closest_hit_spheres_plain(ps.tris, o, d, excl, t_init)
        met, t = ST._row_test(fields, o, d, excl, torch.full((n,), float("inf")))
        met, t = met.numpy(), t.numpy()
        counts = {k: [] for k in ["chunks", *shapes]}
        for i in range(n):
            oi, di = o[i].numpy(), d[i].numpy()
            counts["chunks"].append((*chunk_walk(meta, nc, met[i], t[i], oi, di), 0))
            for shape, nodes in shapes.items():
                w = walk(nodes, met[i], t[i], oi, di, BIG, leaf=slot_range)
                got = np.float32(w.t if w.t < BIG else BIG)
                assert got.tobytes() == want[0][i].numpy().tobytes(), (shape, i)
                counts[shape].append((w.boxes, w.tests, w.depth))
        hits = int((want[0] < BIG).sum())
        print(f"  {kind} ({hits} hits of {n}):")
        for shape, cs in counts.items():
            cs = np.array(cs)
            tot = cs[:, 0] + cs[:, 1]
            print(f"    {shape:>11}: box tests {cs[:, 0].mean():6.1f} (max {cs[:, 0].max():3d}), "
                  f"slot tests {cs[:, 1].mean():6.1f} (max {cs[:, 1].max():3d}), "
                  f"sum {tot.mean():6.1f} (max {tot.max():3d}), stack max {cs[:, 2].max()}")
    if args.cuda:
        time_trees(shapes, ps, nc, cam)
    return 0


def time_trees(shapes, ps, nc, cam):
    """K1 on each tree over full frames of primary and incoherent rays."""
    import statistics
    import subprocess

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"K1 on each tree, {smi.stdout.strip()}:")
    w, h = 720, 480
    pix = torch.arange(w * h)
    po, pd, _ = gen_camera_rays(cam, (pix % w).int(), (pix // w).int(), pix,
                                torch.zeros_like(pix), 0)
    g = torch.Generator().manual_seed(1)
    io = torch.tensor([-50.0, -50.0, 0.0]) + torch.rand(w * h, 3, generator=g) * 100.0
    idir = torch.randn(w * h, 3, generator=g)
    idir = idir / idir.norm(dim=1, keepdim=True)
    table = ps.tris.to(dev)
    for kind, o, d in (("primary", po, pd), ("incoherent", io, idir)):
        o, d = o.float().contiguous().to(dev), d.float().contiguous().to(dev)
        excl = torch.full((w * h,), -1, dtype=torch.int32, device=dev)
        t_init = torch.full((w * h,), float(BIG), device=dev)
        want = ST.closest_hit_spheres_plain(table, o, d, excl, t_init)
        for shape, nodes in shapes.items():
            p = ps._replace(tris=table, chunk_meta=ps.chunk_meta.to(dev),
                            nodes=torch.from_numpy(nodes).to(dev))
            run = lambda: ST.closest_hit_spheres(p, nc, o, d, excl, t_init)
            for a, b in zip(run(), want):
                assert torch.equal(a, b), shape
            times = []
            for _ in range(25):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                run()
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            print(f"  {kind}, {w * h} lanes, {shape}: {statistics.median(times):.4f} ms "
                  "(equal to the plain version)")


if __name__ == "__main__":
    sys.exit(main())
