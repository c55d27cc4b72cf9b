#!/usr/bin/env python3
"""Rehearse chip_smoke.py's gradient phase (8 (a), (b)) on the CPU at small
sizes, and count what its backward pass keeps.

    python scripts/grad_cpu_study.py [--size 90x60 ...] [--fd]

For each size, on the lit stress scene (500 spheres) at one sample a pixel:
the bytes of the tensors autograd saves for the backward pass of one
l2_loss over the whole frame, per lane (torch.autograd.graph's
saved_tensors_hooks, each storage counted once), then chip_smoke's
gradient_step, which logs the chosen entity, the curvature along the first
descent step, the learning rate it sets and the loss curve.  With --fd,
chip_smoke's vertex_colour_fd on 512 lanes of doom_standin.  The kernel
wrappers launch nothing on the CPU (they run their plain versions), so the
phases' checks that the kernels were launched are given counts of 1 here.
The loss's curvature depends on the frame size (a few bright lanes carry
the loss), which is why gradient_step sets its rate from the curvature
along its first step.  Runs on the CPU only; a few minutes at 180x120.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def saved_bytes_per_lane(width, height):
    import torch

    import chip_smoke as CSM
    from paths_tpu_torch import camera as C
    from paths_tpu_torch import grad as G
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_lit_stress_scene

    static, scene, cam = build_scene(generate_lit_stress_scene(500), device="cpu")
    lanes = CSM.wave_lanes(width, height, "cpu")
    n = lanes[0].shape[0]
    storages = {}

    def pack(t):
        storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    params = G.leaf_params(G.get_params(scene))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        G.l2_loss(static, params, scene, C.resize(cam, width, height), *lanes, 0,
                  torch.zeros(n, 3))
    # Storages of at least one byte a lane: the per-lane state, not the
    # scene's tables.
    return sum(v for v in storages.values() if v >= n) / n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", action="append", default=None,
                    help="WxH (repeatable; default 90x60 and 180x120)")
    ap.add_argument("--fd", action="store_true", help="also phase 8 (b) on doom")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as CSM

    torch.set_num_threads(4)
    CSM.P.reset_launches = lambda: CSM.P.LAUNCHES.update(dict.fromkeys(CSM.KERNELS, 1))
    for size in args.size or ["90x60", "180x120"]:
        w, h = (int(v) for v in size.split("x"))
        print(f"[study] {w}x{h}: the backward keeps "
              f"{saved_bytes_per_lane(w, h) / 1024:.1f} KiB a lane", flush=True)
        CSM.gradient_step("cpu", w, h)
    if args.fd:
        CSM.vertex_colour_fd("cpu", 72, 48, lanes_n=512)


if __name__ == "__main__":
    main()
