#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paths_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero before the last line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from paths_tpu_torch/csrc (nvcc, timed);
  3. parity: each kernel against its plain PyTorch version on the card, at
     the stress-500 table and a full 720x480 frame of lanes (345,600):
     primary camera rays and incoherent rays (5% dead lanes, 20%
     exclusions, random excl_ent / t_max); the outputs must be equal;
  4. timing: CUDA events, median of 25 launches after warm-up, for each
     kernel and its plain version, beside its bound: the larger of bytes
     over 3.35 TB/s and ~25 FP32 operations per needed (ray, sphere-slot)
     pair over the FP32 peak SMs x 128 x max SM clock (no FMA).  A pair is
     needed when its chunk's box is entered before the lane's answer is
     settled: its closest hit, its nearest occluder or the end of its ray;
  5. main path: the CLI renders the 500-sphere stress scene at 720x480,
     8 spp, then the lit stress scene renders at 720x480, 4 spp; both images
     must be finite, non-negative and not all zero, and the kernel launch
     counts read after the two renders must be positive;
  6. profile: one main-path tile (65,536 lanes) of the lit scene under
     torch.profiler (wall vs device-busy time, the kernels' share, launches
     per bounce); then both kernels held against their plain versions and
     timed, as in 3 and 4, on the inputs that tile's second bounce
     iteration gave them;
  7. GPU vs CPU: the lit 40-sphere stress scene at 48x32, 2 spp, 3 bounces,
     rendered with the kernels and with the plain versions on the CPU, must
     agree to relative MSE < 1e-4.
Then a JSON line of per-kernel results (ms, plain_ms and bound_ms at the main
path's tile; frame_* at the full frame of incoherent rays), the nvidia-smi
name/power line, and the final JSON status line.  Needs one CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
OPS_PER_PAIR = 25  # FP32 operations per (ray, sphere slot) test
BIG = 3.4e38

KERNELS = {
    "sphere_closest_hit": dict(
        replaces="paths_tpu/ops/sorted_traverse.py:992",
        source="paths_tpu_torch/csrc/sphere_traverse.cu"),
    "sphere_any_hit": dict(
        replaces="paths_tpu/ops/sorted_traverse.py:1027",
        source="paths_tpu_torch/csrc/sphere_traverse.cu"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 3/4

def primary_rays(cam, width, height, device):
    import torch

    from paths_tpu_torch import camera as C
    from paths_tpu_torch.render import gen_camera_rays

    cam = C.resize(cam, width, height)
    pix = torch.arange(width * height, device=device, dtype=torch.int64)
    o, d, _ = gen_camera_rays(cam, (pix % width).to(torch.int32),
                              (pix // width).to(torch.int32), pix,
                              torch.zeros_like(pix), 0)
    return o.contiguous(), d.contiguous()


def incoherent_rays(n, n_spheres, n_entities, device, seed=1):
    """Rays from inside the stress volume in random directions: 5% dead
    lanes, 20% excluded spheres, random excl_ent and t_max (some 0)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)
    o = torch.stack([u(n) * 100 - 50, u(n) * 100 - 50, u(n) * 100], 1)
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    dead = u(n) < 0.05
    o[dead] = 1e30
    excl = torch.full((n,), -1, dtype=torch.int32)
    ex = u(n) < 0.2
    excl[ex] = torch.randint(0, n_spheres, (int(ex.sum()),), generator=g,
                             dtype=torch.int32)
    t_init = torch.where(u(n) < 0.5, torch.full((n,), BIG), u(n) * 150)
    excl_ent = torch.randint(-1, n_entities, (n,), generator=g, dtype=torch.int32)
    t_max = torch.where(u(n) < 0.02, torch.zeros(n), u(n) * 150)
    return [x.to(device).contiguous() for x in (o, d, excl, t_init, excl_ent, t_max)]


def needed_pairs(ps, n_chunks, o, d, t_answer):
    """(ray, slot) tests the function needs for these rays: the slots of
    every chunk whose sphere AABB a live ray enters before t_answer, the
    distance at which the lane's answer is settled (its closest hit, its
    nearest occluder, or the end of its segment).  A walk in front-to-back
    chunk order that stops there tests no fewer; lanes with t_answer <= 0
    need none."""
    import torch

    meta = ps.chunk_meta[:n_chunks]
    lo, hi, nrows = meta[:, 0:3], meta[:, 3:6], meta[:, 7]
    total = 0
    step = 1 << 15
    for a in range(0, o.shape[0], step):
        oo, dd, tt = o[a:a + step], d[a:a + step], t_answer[a:a + step]
        inv = 1.0 / dd
        t0 = (lo[None] - oo[:, None]) * inv[:, None]
        t1 = (hi[None] - oo[:, None]) * inv[:, None]
        tmin = torch.nan_to_num(torch.minimum(t0, t1), nan=-BIG).amax(2)
        tmax = torch.nan_to_num(torch.maximum(t0, t1), nan=BIG).amin(2)
        cross = (tmin < tmax) & (tmin < tt[:, None]) & (tmax > 0)
        cross &= ((oo[:, 0] <= 1e29) & (tt > 0))[:, None]
        total += int((cross.float() * nrows[None] * 16).sum().item())
    return total


def nearest_occluder(ps, o, d, excl, excl_ent, t_max):
    """Distance to each lane's nearest occluder before t_max (inf where
    there is none), from the plain version's row test."""
    import torch

    from paths_tpu_torch.ops import sphere_traverse as ST

    fields = ST._slot_fields(ps.tris)
    out = torch.full_like(t_max, float("inf"))
    for a, b in ST._lane_steps(o.shape[0], fields[0].shape[0]):
        ok, t = ST._row_test(fields, o[a:b], d[a:b], excl[a:b], t_max[a:b])
        ok &= fields[5] != excl_ent[a:b, None]
        out[a:b] = torch.where(ok, t, float("inf")).amin(1)
    return out


def check_equal(name, got, want):
    """Raise unless the kernel's outputs equal the plain version's; return
    the largest absolute difference (0.0 when equal)."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            bad = int((g != w).sum().item())
            raise AssertionError(f"{name}: {bad} of {g.numel()} lanes differ "
                                 "from the plain version")
        err = max(err, float((g.double() - w.double()).abs().max().item()))
    return err


def time_ms(fn, reps=25):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def fp32_peak(device):
    """FP32 operations per second with no FMA: SMs x 128 x max SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return sms * 128 * mhz * 1e6, f"{sms} SMs x 128 x {mhz:.0f} MHz"


def measure(label, ps, nc, k1_args, k2_args, timer):
    """Hold K1 and K2 against their plain versions on these inputs (equal
    outputs), time both, and bound both by the work these inputs need.
    k1_args = (o, d, excl, t_init); k2_args = (o, d, excl, excl_ent, t_max).
    Returns {name: dict(max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    import torch

    from paths_tpu_torch.ops import sphere_traverse as ST

    peak_ops, peak_txt = fp32_peak(k1_args[0].device)
    table_bytes = ps.tris.numel() * 4 + nc * 128 * 4
    lane_in = 24 + 4 + 4  # o, d, excl, seed

    t_hit = ST.closest_hit_spheres(ps, nc, *k1_args)
    err1 = check_equal(f"K1 {label}", t_hit, ST.closest_hit_spheres_plain(ps.tris, *k1_args))
    occ = ST.occludes_spheres(ps, nc, *k2_args)
    err2 = check_equal(f"K2 {label}", occ, ST.occludes_spheres_plain(ps.tris, *k2_args))
    t_occ = nearest_occluder(ps, *k2_args)
    t_max = k2_args[-1]
    if not torch.equal((t_occ < float("inf")) | (t_max == 0), occ):
        raise AssertionError(f"K2 {label}: nearest occluders disagree with the flags")

    recs = {}
    for name, run, plain, args, answer, extra_in, out_bytes, err in (
        ("sphere_closest_hit", ST.closest_hit_spheres, ST.closest_hit_spheres_plain,
         k1_args, torch.minimum(t_hit[0], k1_args[-1]), 0, 12, err1),
        ("sphere_any_hit", ST.occludes_spheres, ST.occludes_spheres_plain,
         k2_args, torch.minimum(t_occ, t_max), 4, 1, err2),
    ):
        n = args[0].shape[0]
        ms = timer(lambda: run(ps, nc, *args))
        plain_ms = timer(lambda: plain(ps.tris, *args))
        pairs = needed_pairs(ps, nc, args[0], args[1], answer)
        bytes_ = table_bytes + n * (lane_in + extra_in + out_bytes)
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = pairs * OPS_PER_PAIR / peak_ops * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        recs[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=max(t_bytes, t_ops), bound_by=bound_by)
        log(f"[timing] {name}, {label}, {n} lanes: {ms:.4f} ms (plain "
            f"{plain_ms:.3f} ms), bound {max(t_bytes, t_ops):.4f} ms by {bound_by} "
            f"({pairs} needed pair tests, {bytes_} bytes; FP32 peak "
            f"{peak_ops / 1e12:.2f} T op/s = {peak_txt})")
    return recs


def kernel_phases(device, width=720, height=480, timer=time_ms):
    """Phases 3 and 4: parity and timing of both kernels at the stress-500
    table and width x height lanes.  Returns per-kernel records."""
    import torch

    from paths_tpu_torch.ops import sphere_traverse as ST
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_stress_scene

    static, scene, cam = build_scene(generate_stress_scene(500), device=device)
    ps, nc = scene.psph, static.sph_chunks
    n = width * height
    po, pd = primary_rays(cam, width, height, device)
    o, d, excl, t_init, excl_ent, t_max = incoherent_rays(
        n, static.n_spheres, static.n_entities, device)
    p_excl = torch.full((n,), -1, dtype=torch.int32, device=device)
    p_t = torch.full((n,), BIG, device=device)

    err = check_equal("K1 primary", ST.closest_hit_spheres(ps, nc, po, pd, p_excl, p_t),
                      ST.closest_hit_spheres_plain(ps.tris, po, pd, p_excl, p_t))
    err = max(err, check_equal(
        "K2 primary", ST.occludes_spheres(ps, nc, po, pd, p_excl, excl_ent, t_max),
        ST.occludes_spheres_plain(ps.tris, po, pd, p_excl, excl_ent, t_max)))
    recs = measure("incoherent frame", ps, nc, (o, d, excl, t_init),
                   (o, d, excl, excl_ent, t_max), timer)
    hits = int((ST.closest_hit_spheres(ps, nc, o, d, excl, t_init)[0] < BIG).sum().item())
    occl = int(ST.occludes_spheres(ps, nc, o, d, excl, excl_ent, t_max).sum().item())
    log(f"[parity] K1/K2 == plain at {n} lanes x {ps.tris.shape[0] * 16} slots "
        f"(primary + incoherent rays; incoherent: {hits} hits, {occl} occluded)")
    t_prim = timer(lambda: ST.closest_hit_spheres(ps, nc, po, pd, p_excl, p_t))
    log(f"[timing] sphere_closest_hit on primary rays: {t_prim:.4f} ms")
    for r in recs.values():
        r["max_abs_err"] = max(r["max_abs_err"], err)
    return recs


# ---------------------------------------------------------------- phases 5-7

def check_image(name, img):
    import numpy as np

    if not np.isfinite(img).all():
        raise AssertionError(f"{name}: non-finite pixels")
    if (img < 0).any():
        raise AssertionError(f"{name}: negative pixels")
    if not (img > 0).any():
        raise AssertionError(f"{name}: image is all zero")


def main_path(device, out_dir, width=720, height=480, spp=(8, 4)):
    """Phase 5: the CLI on the stress scene, then the lit stress scene
    through the library entry points.  Returns the two images."""
    import torch

    from paths_tpu_torch import camera as C
    from paths_tpu_torch import cli
    from paths_tpu_torch.render import render_image
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_lit_stress_scene

    argv = ["-o", os.path.join(out_dir, "stress.png"), "--spp", str(spp[0])]
    if (width, height) != (720, 480):
        argv += ["--size", f"{width}x{height}"]
    if torch.device(device).type == "cpu":
        argv.append("--cpu")
    t = time.time()
    img1 = cli.main(argv)
    dt1 = time.time() - t
    check_image("stress-500", img1)

    static, scene, cam = build_scene(generate_lit_stress_scene(500), device=device)
    cam = C.resize(cam, width, height)
    t = time.time()
    img2 = render_image(static, scene, cam, width, height, spp=spp[1], seed=0)
    dt2 = time.time() - t
    check_image("lit stress-500", img2)
    log(f"[main] stress-500 {width}x{height} {spp[0]} spp: {dt1:.2f} s "
        f"({width * height * spp[0] / dt1 / 1e6:.3f} M pixel-samples/s incl. "
        f"scene build); lit stress-500 {spp[1]} spp: {dt2:.2f} s "
        f"({width * height * spp[1] / dt2 / 1e6:.3f} M pixel-samples/s)")
    return img1, img2


def capture_inputs(run, call_index=1):
    """Run run() with both kernel wrappers spied on.  Returns, per wrapper
    name, copies of the arguments of its call number call_index (0-based)."""
    import torch

    from paths_tpu_torch.ops import sphere_traverse as ST

    names = ("closest_hit_spheres", "occludes_spheres")
    origs = {n: getattr(ST, n) for n in names}
    calls = {n: 0 for n in names}
    saved = {}

    def spy(name):
        def call(*args):
            if calls[name] == call_index:
                saved[name] = [a.clone() if isinstance(a, torch.Tensor) else a
                               for a in args]
            calls[name] += 1
            return origs[name](*args)
        return call

    for n in names:
        setattr(ST, n, spy(n))
    try:
        run()
    finally:
        for n in names:
            setattr(ST, n, origs[n])
    if len(saved) < len(names):
        raise AssertionError(f"wrapper calls {calls}: fewer than {call_index + 1}")
    return saved


def where_time_goes(device, width=720, height=480, lanes=65536, spp=4,
                    timer=time_ms):
    """Phase 6: one render_samples call of the lit stress-500 scene on one
    main-path tile under torch.profiler: wall time against device-busy time,
    the sphere kernels' share, and the kernel launches per bounce iteration.
    Then both kernels held and timed on the inputs that tile's second bounce
    iteration gave them.  Returns per-kernel records at that shape."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paths_tpu_torch import camera as C
    from paths_tpu_torch.ops import sphere_traverse as ST
    from paths_tpu_torch.render import render_samples, tiled_pixel_order
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_lit_stress_scene

    static, scene, cam = build_scene(generate_lit_stress_scene(500), device=device)
    cam = C.resize(cam, width, height)
    pix = torch.as_tensor(
        tiled_pixel_order(width, height)[:lanes].astype(np.int64), device=device)
    px, py = (pix % width).to(torch.int32), (pix // width).to(torch.int32)
    # Warm-up, capturing the second bounce iteration's kernel inputs.
    cap = capture_inputs(
        lambda: render_samples(static, scene, cam, px, py, pix, 0, 1, 0))
    k1_in, k2_in = cap["closest_hit_spheres"], cap["occludes_spheres"]
    torch.cuda.synchronize()
    before = ST.LAUNCHES["sphere_closest_hit"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t = time.perf_counter()
        render_samples(static, scene, cam, px, py, pix, 1, spp, 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    iters = ST.LAUNCHES["sphere_closest_hit"] - before  # one K1 per path_step

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # Device-side rows only (kernels, copies): the operator rows on the host
    # carry the same device time again.
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    if busy_ms == 0:
        log(f"[profile] wall {wall_ms:.1f} ms over {iters} bounce iterations; "
            "the profiler traced no device time")
    else:
        n_launch = sum(e.count for e in rows)
        sphere_ms = sum(dev_us(e) for e in rows if "sphere_traverse" in e.key) / 1e3
        top = sorted(rows, key=dev_us, reverse=True)[:4]
        log(f"[profile] lit stress-500, {lanes} lanes, {spp} spp: wall {wall_ms:.1f} ms, "
            f"{iters} bounce iterations; device busy {busy_ms:.1f} ms "
            f"({100 * busy_ms / wall_ms:.1f}% of wall); sphere kernels {sphere_ms:.2f} ms "
            f"({100 * sphere_ms / wall_ms:.2f}% of wall); {n_launch} device kernels "
            f"({n_launch / max(iters, 1):.0f} per iteration); top: "
            + "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.2f} ms x{e.count}" for e in top))

    return measure("main-path tile", k1_in[0], k1_in[1], tuple(k1_in[2:]),
                   tuple(k2_in[2:]), timer)


def gpu_vs_cpu(device):
    """Phase 6: the whole path with kernels vs with the plain versions."""
    import numpy as np

    from paths_tpu_torch import camera as C
    from paths_tpu_torch.render import render_image
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_lit_stress_scene

    imgs = []
    for dev in (device, "cpu"):
        static, scene, cam = build_scene(generate_lit_stress_scene(40), device=dev)
        static = dataclasses.replace(static, max_bounces=3)
        imgs.append(render_image(static, scene, C.resize(cam, 48, 32), 48, 32,
                                 spp=2, seed=0))
    a, b = imgs
    rel = float(np.mean((a - b) ** 2) / (np.mean(b ** 2) + 1e-12))
    if not rel < 1e-4:
        raise AssertionError(f"GPU vs CPU relative MSE {rel:.3e} >= 1e-4")
    log(f"[gpu-vs-cpu] lit stress-40 48x32 2 spp: relative MSE {rel:.3e} (< 1e-4)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAIL: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    from paths_tpu_torch.ops import sphere_traverse as ST

    device = torch.device("cuda")
    smi = nvidia_smi("name,power.limit")
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t = time.time()
    ST.build_kernels(verbose=True)
    log(f"[build] sphere_traverse.cu built and loaded in {time.time() - t:.1f} s")

    frame = kernel_phases(device)

    with tempfile.TemporaryDirectory() as tmp:
        ST.reset_launch_counts()
        main_path(device, tmp)
        launches = dict(ST.LAUNCHES)
    log(f"[main] kernel launches on the main path: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    tile = where_time_goes(device)
    gpu_vs_cpu(device)

    # ms, plain_ms and bound_ms are at the main path's shape (one tile of
    # bounce and shadow rays); frame_* at the full incoherent frame.
    recs = [dict(name=name, route="cuda", **KERNELS[name],
                 launches=launches[name],
                 max_abs_err=max(tile[name]["max_abs_err"], frame[name]["max_abs_err"]),
                 ms=tile[name]["ms"], plain_ms=tile[name]["plain_ms"],
                 bound_ms=tile[name]["bound_ms"], bound_by=tile[name]["bound_by"],
                 library_ms=None,
                 frame_ms=frame[name]["ms"], frame_plain_ms=frame[name]["plain_ms"],
                 frame_bound_ms=frame[name]["bound_ms"])
            for name in KERNELS]
    print(json.dumps({"kernels": recs}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
