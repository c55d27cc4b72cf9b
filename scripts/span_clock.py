#!/usr/bin/env python3
"""Check that the program's recorded spans (``profiling.record()``) lie on
the profiler's clock, and from which threads the gradient's backward
launches its kernels.

    python scripts/span_clock.py [--cpu] [--size 360x240] [--spp 2]

Renders stress-500 (the CLI's default scene) under ``torch.profiler`` (the
host and, on ``cuda``, the card) with the recorder on, after one warm-up
frame, then one ``grad.loss_and_grad`` of lit stress-500 over a tile.  Each
``paths_tpu_torch.*`` range the profiler recorded is matched with the
recorded span of the same name and order; printed per name: the count and
the largest offset in microseconds at the start (span minus range) and at
the end (range minus span), both 0 or more when the span lies inside its
range.  Then the kernel launches inside each ``grad_backward`` range, by
host thread.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from paths_tpu_torch import camera as C
from paths_tpu_torch import grad as G
from paths_tpu_torch import profiling as P
from paths_tpu_torch.render import render_image
from paths_tpu_torch.scene.build import build_scene
from paths_tpu_torch.scene.stress import generate_lit_stress_scene, generate_stress_scene


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def offsets(prof, rec) -> dict:
    """{name: (count, largest start offset ns, largest end offset ns,
    smallest of either)} over the program's ranges and recorded spans."""
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("paths_tpu_torch.") and e.device_type() == torch.autograd.DeviceType.CPU:
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    out = {}
    for name, got in ranges.items():
        spans = [s for s in rec.spans if s.name == name]
        if len(spans) != len(got):
            raise SystemExit(f"{name}: {len(got)} ranges against {len(spans)} spans")
        d = [(s.start_ns - lo, hi - s.end_ns) for s, (lo, hi) in zip(spans, sorted(got))]
        out[name] = (len(d), max(a for a, _ in d), max(b for _, b in d),
                     min(min(a, b) for a, b in d))
    return out


def backward_threads(prof) -> dict:
    """{thread id: kernel launches} inside the grad_backward ranges."""
    evs = list(prof.profiler.kineto_results.events())
    back = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs
            if e.name() == "paths_tpu_torch.grad_backward"
            and e.device_type() == torch.autograd.DeviceType.CPU]
    out = {}
    for e in evs:
        n = e.name()
        if ("LaunchKernel" in n or n.startswith("cuLaunch")) and \
                any(lo <= e.start_ns() <= hi for lo, hi in back):
            out[e.start_thread_id()] = out.get(e.start_thread_id(), 0) + 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--size", default="360x240")
    ap.add_argument("--spp", type=int, default=2)
    args = ap.parse_args(argv)
    dev = "cpu" if args.cpu else "cuda"
    w, h = (int(v) for v in args.size.split("x"))
    print(f"[card] {card()}", flush=True)
    acts = [ProfilerActivity.CPU] + ([] if args.cpu else [ProfilerActivity.CUDA])

    static, scene, cam = build_scene(generate_stress_scene(500, seed=0), device=dev)
    cam = C.resize(cam, w, h)
    render_image(static, scene, cam, w, h, spp=1, seed=1)
    with P.record() as rec, profile(activities=acts) as prof:
        t = time.perf_counter()
        render_image(static, scene, cam, w, h, spp=args.spp, seed=2)
        secs = time.perf_counter() - t
    print(f"[render] {w}x{h} at {args.spp} spp in {secs:.3f} s (profiled)")
    worst = 0
    for name, (n, a, b, lo) in sorted(offsets(prof, rec).items()):
        print(f"[clock] {name}: {n} spans, largest offset at start {a / 1e3:.1f} us, "
              f"at end {b / 1e3:.1f} us, smallest of either {lo / 1e3:.1f} us")
        if name == "paths_tpu_torch.path_step":
            worst = max(a, b, -lo)

    static, scene, cam = build_scene(generate_lit_stress_scene(500, seed=0), device=dev)
    cam = C.resize(cam, w, h)
    n = w * h
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    lanes = ((pix % w).to(torch.int32), (pix // w).to(torch.int32), pix, torch.zeros_like(pix))
    target = torch.full((n, 3), 0.25, device=dev)
    G.loss_and_grad(static, scene, cam, *lanes, 3, target)
    with P.record() as rec, profile(activities=acts) as prof:
        G.loss_and_grad(static, scene, cam, *lanes, 3, target)
        if dev == "cuda":
            torch.cuda.synchronize()
    for name, (n_s, a, b, lo) in sorted(offsets(prof, rec).items()):
        if name in ("paths_tpu_torch.grad_backward", "paths_tpu_torch.render_wave"):
            print(f"[clock] {name}: {n_s} spans, largest offset at start {a / 1e3:.1f} us, "
                  f"at end {b / 1e3:.1f} us, smallest of either {lo / 1e3:.1f} us")
    print(f"[backward] kernel launches inside grad_backward by host thread: "
          f"{backward_threads(prof)}")
    print(f"[clock] path_step: largest offset {worst / 1e3:.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
