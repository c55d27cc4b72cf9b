#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paths_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero before the last line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels (csrc/sphere_traverse.cu, csrc/tri_traverse.cu,
     nvcc with ptxas -v) and the C++ BVH builder (csrc/bvh_builder.cc, g++),
     all three started together, timed;
  3. parity, spheres: K1/K2 against their plain PyTorch versions on the
     card, at the stress-500 table and a full 720x480 frame of lanes
     (345,600): primary camera rays and incoherent rays (5% dead lanes, 20%
     exclusions, random excl_ent / t_max); the outputs must be equal;
  4. timing, spheres: CUDA events, median of 25 launches after warm-up, for
     each kernel and its plain version, beside its bound: the larger of the
     needed bytes over 3.35 TB/s and FP32 operations per needed (ray, slot)
     pair over the FP32 peak SMs x 128 x max SM clock (an FMA counts as one).
     A chunk is needed when some lane enters its box before the lane's answer
     is settled: its closest hit, its nearest occluder or the end of its ray.
     The needed pairs are those chunks' slots for each such lane; the needed
     bytes are those chunks' rows and meta rows, read once, and the lanes'
     inputs and outputs;
  3b/4b. parity and timing, triangles: K3/K4 on the doom_standin table (96k
     triangles, 8 rows per chunk) and the dragon_standin table (200k, 20 rows
     per chunk).  The kernels are timed on full 720x480 frames of primary
     and of incoherent rays; they are held equal to their plain versions
     (flat brute force, timed once) on 65,536 of those lanes -- every
     tenth-or-so primary ray and the first 32,768 incoherent rays -- where
     the bound is counted too;
  5. main path: each path driven with the launch counts set to 0 just before
     it and read just after: the CLI renders the 500-sphere stress scene at
     720x480, 8 spp (K1); the lit stress scene renders at 720x480, 4 spp
     (K1, K2); the CLI renders scenes/doom_standin.yml at 720x480, 4 spp and
     scenes/dragon_standin.yml at 720x480, 2 spp (K3, K4).  Images must be
     finite, non-negative and not all zero;
  6. profile: one main-path tile (65,536 lanes) of the lit stress scene and
     one of doom_standin under torch.profiler (wall vs device-busy time, the
     kernels' share, launches per bounce); then each kernel held against its
     plain version and timed, as in 3/4, on the inputs that tile's second
     bounce iteration gave it;
  7. GPU vs CPU: the mixed sphere + mesh scene (40 spheres, 128 triangles, a
     sphere light; all four kernels) at 48x32, 2 spp, 3 bounces, rendered
     with the kernels and with the plain versions on the CPU, must agree to
     relative MSE < 1e-4.
Then a JSON line of per-kernel results (ms, plain_ms and bound_ms at the main
path's tile; frame_* and doom_*/dragon_* at the shapes of 4 and 4b), the
nvidia-smi name/power line, and the final JSON status line.  Needs one CUDA
device.
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
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# FP32 operations per (ray, slot) test, counted from the row tests: a sphere
# slot ~25; a triangle slot 32 (six three-term dot products of one multiply
# and two FMAs, t's subtraction and division, bx/by's add and FMA, bz's two
# subtractions, six comparisons).
OPS_PER_PAIR = {"sphere": 25, "tri": 32}
SLOTS_PER_ROW = {"sphere": 16, "tri": 8}
BIG = 3.4e38
SUBSET = 65536  # lanes held against the plain triangle versions

KERNELS = {
    "sphere_closest_hit": dict(
        replaces="paths_tpu/ops/sorted_traverse.py:992",
        source="paths_tpu_torch/csrc/sphere_traverse.cu"),
    "sphere_any_hit": dict(
        replaces="paths_tpu/ops/sorted_traverse.py:1027",
        source="paths_tpu_torch/csrc/sphere_traverse.cu"),
    "tri_closest_hit": dict(
        replaces="paths_tpu/ops/sorted_traverse.py:937",
        source="paths_tpu_torch/csrc/tri_traverse.cu"),
    "tri_any_hit": dict(
        replaces="paths_tpu/ops/sorted_traverse.py:968",
        source="paths_tpu_torch/csrc/tri_traverse.cu"),
}
DOOM = os.path.join(REPO, "scenes", "doom_standin.yml")
DRAGON = os.path.join(REPO, "scenes", "dragon_standin.yml")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def reset_launch_counts():
    from paths_tpu_torch.ops import sphere_traverse as ST
    from paths_tpu_torch.ops import tri_traverse as TT

    ST.reset_launch_counts()
    TT.reset_launch_counts()


def launch_counts() -> dict:
    from paths_tpu_torch.ops import sphere_traverse as ST
    from paths_tpu_torch.ops import tri_traverse as TT

    return {**ST.LAUNCHES, **TT.LAUNCHES}


# ---------------------------------------------------------------- phase 2

def build_all():
    """Build the two CUDA libraries and the C++ BVH builder at once (one
    compiler process each); returns {source: seconds}."""
    from paths_tpu_torch.bvh import build as BB
    from paths_tpu_torch.ops import sphere_traverse as ST
    from paths_tpu_torch.ops import tri_traverse as TT

    def timed(fn):
        t = time.time()
        fn()
        return time.time() - t

    jobs = {"sphere_traverse.cu": lambda: ST.build_kernels(verbose=True),
            "tri_traverse.cu": lambda: TT.build_kernels(verbose=True),
            "bvh_builder.cc": BB._native_lib}
    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {name: ex.submit(timed, fn) for name, fn in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


# ---------------------------------------------------------------- phases 3/4

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


def incoherent_rays(n, lo, hi, n_prims, n_entities, device, t_span=None, seed=1):
    """Rays from inside the box [lo, hi] in random directions: 5% dead
    lanes, 20% excluded primitives, random excl_ent, t_init and t_max (2% 0)
    up to t_span (default: the box's diagonal)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)
    lo, hi = torch.as_tensor(lo).float().cpu(), torch.as_tensor(hi).float().cpu()
    diag = t_span or float((hi - lo).norm())
    o = lo + u(n, 3) * (hi - lo)
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    dead = u(n) < 0.05
    o[dead] = 1e30
    excl = torch.full((n,), -1, dtype=torch.int32)
    ex = u(n) < 0.2
    excl[ex] = torch.randint(0, n_prims, (int(ex.sum()),), generator=g,
                             dtype=torch.int32)
    t_init = torch.where(u(n) < 0.5, torch.full((n,), BIG), u(n) * diag)
    excl_ent = torch.randint(-1, n_entities, (n,), generator=g, dtype=torch.int32)
    t_max = torch.where(u(n) < 0.02, torch.zeros(n), u(n) * diag)
    return [x.to(device).contiguous() for x in (o, d, excl, t_init, excl_ent, t_max)]


def needed_work(meta, n_chunks, slots_per_row, o, d, t_answer, step=4096):
    """(pairs, table_bytes): the (ray, slot) tests and the table bytes the
    function needs for these rays.  A chunk is needed when a live ray enters
    its box before t_answer, the distance at which the lane's answer is
    settled (its closest hit, its nearest occluder, or the end of its
    segment); a walk in front-to-back chunk order that stops there tests no
    fewer, and lanes with t_answer <= 0 need none.  The pairs are the slots
    of each needed chunk, once per lane that needs it; the bytes are the
    rows of the needed chunks and their meta rows, each read once (512 B a
    row)."""
    import torch

    meta = meta[:n_chunks]
    lo, hi, nrows = meta[:, 0:3], meta[:, 3:6], meta[:, 7]
    total = 0
    entered = torch.zeros(n_chunks, dtype=torch.bool, device=meta.device)
    for a in range(0, o.shape[0], step):
        oo, dd, tt = o[a:a + step], d[a:a + step], t_answer[a:a + step]
        inv = 1.0 / dd
        t0 = (lo[None] - oo[:, None]) * inv[:, None]
        t1 = (hi[None] - oo[:, None]) * inv[:, None]
        tmin = torch.nan_to_num(torch.minimum(t0, t1), nan=-BIG).amax(2)
        tmax = torch.nan_to_num(torch.maximum(t0, t1), nan=BIG).amin(2)
        cross = (tmin < tmax) & (tmin < tt[:, None]) & (tmax > 0)
        cross &= ((oo[:, 0] <= 1e29) & (tt > 0))[:, None]
        total += int((cross.double() @ nrows.double()).sum().item()) * slots_per_row
        entered |= cross.any(0)
    table_bytes = int(((nrows + 1) * entered).sum().item()) * 128 * 4
    return total, table_bytes


def nearest_occluder(kind, table, n_chunks, o, d, excl, excl_ent, t_max):
    """Distance to each lane's nearest occluder before t_max (inf where
    there is none), from the plain version's row test."""
    import torch

    from paths_tpu_torch.ops import sphere_traverse as ST
    from paths_tpu_torch.ops import tri_traverse as TT

    out = torch.full_like(t_max, float("inf"))
    if kind == "sphere":
        fields = ST._slot_fields(table.tris)
        steps, ent = ST._lane_steps(o.shape[0], fields[0].shape[0]), fields[5]
        row_test = lambda a, b: ST._row_test(fields, o[a:b], d[a:b], excl[a:b], t_max[a:b])
    else:
        f = TT._slots(table, n_chunks)
        steps, ent = TT._lane_steps(o.shape[0], f["gid"].shape[0], o.device), f["ent"]
        row_test = lambda a, b: TT._row_test(f, o[a:b], d[a:b], excl[a:b], t_max[a:b])
    for a, b in steps:
        ok, t = row_test(a, b)
        ok &= ent != excl_ent[a:b, None]
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


def time_once(fn):
    """(ms, result) of one call, by CUDA events: for the plain versions,
    whose brute force over a mesh is too slow to repeat."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def fp32_peak(device):
    """FP32 operations per second with no FMA: SMs x 128 x max SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return sms * 128 * mhz * 1e6, f"{sms} SMs x 128 x {mhz:.0f} MHz"


def _family(kind):
    from paths_tpu_torch.ops import sphere_traverse as ST
    from paths_tpu_torch.ops import tri_traverse as TT

    if kind == "sphere":
        return (("sphere_closest_hit", ST.closest_hit_spheres,
                 lambda tab, nc, *a: ST.closest_hit_spheres_plain(tab.tris, *a)),
                ("sphere_any_hit", ST.occludes_spheres,
                 lambda tab, nc, *a: ST.occludes_spheres_plain(tab.tris, *a)))
    return (("tri_closest_hit", TT.closest_hit_tris, TT.closest_hit_tris_plain),
            ("tri_any_hit", TT.occludes_tris, TT.occludes_tris_plain))


def measure(kind, label, table, nc, ch_args, ah_args, timer, plain_reps=True):
    """Hold the closest-hit and any-hit kernels of one family ("sphere" or
    "tri") against their plain versions on these inputs (equal outputs),
    time both, and bound both by the work these inputs need.  ch_args = (o,
    d, excl, t_init); ah_args = (o, d, excl, excl_ent, t_max).  The plain
    versions are timed like the kernels (plain_reps) or, for the triangle
    brute force, once.  Returns {name: dict(max_abs_err, ms, plain_ms,
    bound_ms, bound_by)}."""
    import torch

    (ch_name, ch, ch_plain), (ah_name, ah, ah_plain) = _family(kind)
    peak_ops, peak_txt = fp32_peak(ch_args[0].device)
    lane_in = 24 + 4 + 4  # o, d, excl, seed

    t_hit = ch(table, nc, *ch_args)
    plain_ch_ms, want = time_once(lambda: ch_plain(table, nc, *ch_args))
    err_ch = check_equal(f"{ch_name} {label}", t_hit, want)
    occ = ah(table, nc, *ah_args)
    plain_ah_ms, want = time_once(lambda: ah_plain(table, nc, *ah_args))
    err_ah = check_equal(f"{ah_name} {label}", occ, want)
    t_occ = nearest_occluder(kind, table, nc, *ah_args)
    t_max = ah_args[-1]
    if not torch.equal((t_occ < float("inf")) | (t_max == 0), occ):
        raise AssertionError(f"{ah_name} {label}: nearest occluders disagree with the flags")

    recs = {}
    for name, run, plain, args, answer, extra_in, out_bytes, err, plain_ms in (
        (ch_name, ch, ch_plain, ch_args, torch.minimum(t_hit[0], ch_args[-1]), 0,
         12, err_ch, plain_ch_ms),
        (ah_name, ah, ah_plain, ah_args, torch.minimum(t_occ, t_max), 4, 1, err_ah,
         plain_ah_ms),
    ):
        n = args[0].shape[0]
        ms = timer(lambda: run(table, nc, *args))
        if plain_reps:
            plain_ms = timer(lambda: plain(table, nc, *args))
        pairs, table_bytes = needed_work(table.chunk_meta, nc, SLOTS_PER_ROW[kind],
                                         args[0], args[1], answer)
        bytes_ = table_bytes + n * (lane_in + extra_in + out_bytes)
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = pairs * OPS_PER_PAIR[kind] / peak_ops * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        recs[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=max(t_bytes, t_ops), bound_by=bound_by)
        log(f"[timing] {name}, {label}, {n} lanes: {ms:.4f} ms (plain "
            f"{plain_ms:.3f} ms), bound {max(t_bytes, t_ops):.4f} ms by {bound_by} "
            f"({pairs} needed pair tests, {bytes_} bytes of which {table_bytes} "
            f"needed table; FP32 peak "
            f"{peak_ops / 1e12:.2f} T op/s = {peak_txt})")
    return recs


def sphere_kernel_phases(device, width=720, height=480, timer=time_ms):
    """Phases 3 and 4: parity and timing of K1/K2 at the stress-500 table
    and width x height lanes.  Returns per-kernel records."""
    import torch

    from paths_tpu_torch.ops import sphere_traverse as ST
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_stress_scene

    static, scene, cam = build_scene(generate_stress_scene(500), device=device)
    ps, nc = scene.psph, static.sph_chunks
    n = width * height
    po, pd = primary_rays(cam, width, height, device)
    o, d, excl, t_init, excl_ent, t_max = incoherent_rays(
        n, (-50.0, -50.0, 0.0), (50.0, 50.0, 100.0), static.n_spheres,
        static.n_entities, device, t_span=150.0)
    p_excl = torch.full((n,), -1, dtype=torch.int32, device=device)
    p_t = torch.full((n,), BIG, device=device)

    err = check_equal("K1 primary", ST.closest_hit_spheres(ps, nc, po, pd, p_excl, p_t),
                      ST.closest_hit_spheres_plain(ps.tris, po, pd, p_excl, p_t))
    err = max(err, check_equal(
        "K2 primary", ST.occludes_spheres(ps, nc, po, pd, p_excl, excl_ent, t_max),
        ST.occludes_spheres_plain(ps.tris, po, pd, p_excl, excl_ent, t_max)))
    recs = measure("sphere", "incoherent frame", ps, nc, (o, d, excl, t_init),
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


def tri_kernel_phases(device, scene_path, label, width=720, height=480,
                      timer=time_ms):
    """Phases 3b and 4b for one mesh scene: K3/K4 timed on a full frame of
    primary rays and one of incoherent rays, held equal to their plain
    versions and bounded on SUBSET of those lanes (every (n / (SUBSET/2))-th
    primary ray and the first SUBSET/2 incoherent rays; the primary lanes'
    any-hit queries take the incoherent set's excl_ent and t_max).  Returns
    per-kernel records at the subset, with frame_ms added."""
    import torch

    from paths_tpu_torch.ops import tri_traverse as TT
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.yaml_loader import load_scene_description

    t = time.time()
    static, scene, cam = build_scene(load_scene_description(scene_path), device=device)
    pt, nc = scene.ptris, static.tri_chunks
    log(f"[build] {label}: {static.n_tris} triangles, {nc} chunks of "
        f"{static.tri_rows} rows, table {pt.tris.shape[0]} rows; scene built in "
        f"{time.time() - t:.1f} s")
    n = width * height
    meta = pt.chunk_meta[:nc]
    po, pd = primary_rays(cam, width, height, device)
    o, d, excl, t_init, excl_ent, t_max = incoherent_rays(
        n, meta[:, 0:3].amin(0), meta[:, 3:6].amax(0), static.n_tris,
        static.n_entities, device)
    p_excl = torch.full((n,), -1, dtype=torch.int32, device=device)
    p_t = torch.full((n,), BIG, device=device)

    frame = {
        "primary": timer(lambda: TT.closest_hit_tris(pt, nc, po, pd, p_excl, p_t)),
        "tri_closest_hit": timer(lambda: TT.closest_hit_tris(pt, nc, o, d, excl, t_init)),
        "tri_any_hit": timer(lambda: TT.occludes_tris(pt, nc, o, d, excl, excl_ent, t_max)),
    }
    hits = int((TT.closest_hit_tris(pt, nc, po, pd, p_excl, p_t)[0] < BIG).sum().item())
    log(f"[timing] {label} frame, {n} lanes: tri_closest_hit primary "
        f"{frame['primary']:.3f} ms ({hits} hits), incoherent "
        f"{frame['tri_closest_hit']:.3f} ms; tri_any_hit incoherent "
        f"{frame['tri_any_hit']:.3f} ms")

    half = SUBSET // 2
    sel = torch.arange(half, device=device) * (n // half)
    cat = lambda a, b: torch.cat([a[sel], b[:half]]).contiguous()
    so, sd_, sx = cat(po, o), cat(pd, d), cat(p_excl, excl)
    recs = measure("tri", f"{label} subset", pt, nc, (so, sd_, sx, cat(p_t, t_init)),
                   (so, sd_, sx, torch.cat([excl_ent[half:SUBSET], excl_ent[:half]]),
                    torch.cat([t_max[half:SUBSET], t_max[:half]])),
                   timer, plain_reps=False)
    log(f"[parity] {label}: K3/K4 == plain at {SUBSET} lanes x "
        f"{pt.tris.shape[0] * 8} slots")
    for name, r in recs.items():
        r["frame_ms"] = frame[name]
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


def drive(name, run, kernels):
    """Drive one path with the launch counts set to 0 just before it and read
    just after; each of its kernels must have launched.  Returns the
    counts."""
    reset_launch_counts()
    run()
    counts = launch_counts()
    log(f"[main] {name}: kernel launches {counts}")
    for k in kernels:
        if counts[k] <= 0:
            raise AssertionError(f"{k} was not launched on the {name} path")
    return counts


def main_path(device, out_dir, width=720, height=480, spp=(8, 4, 4, 2)):
    """Phase 5: the CLI on the stress scene, the lit stress scene through the
    library entry points, then the CLI on the two mesh scenes.  Returns the
    summed launch counts of the four paths."""
    import torch

    from paths_tpu_torch import camera as C
    from paths_tpu_torch import cli
    from paths_tpu_torch.render import render_image
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_lit_stress_scene

    def cli_args(out, n_spp):
        argv = ["-o", os.path.join(out_dir, out), "--spp", str(n_spp)]
        if (width, height) != (720, 480):
            argv += ["--size", f"{width}x{height}"]
        if torch.device(device).type == "cpu":
            argv.append("--cpu")
        return argv

    def timed_cli(name, argv, n_spp):
        t = time.time()
        img = cli.main(argv)
        dt = time.time() - t
        check_image(name, img)
        log(f"[main] {name} {width}x{height} {n_spp} spp: {dt:.2f} s "
            f"({width * height * n_spp / dt / 1e6:.3f} M pixel-samples/s incl. "
            f"scene build)")

    def lit():
        static, scene, cam = build_scene(generate_lit_stress_scene(500), device=device)
        t = time.time()
        img = render_image(static, scene, C.resize(cam, width, height), width,
                           height, spp=spp[1], seed=0)
        dt = time.time() - t
        check_image("lit stress-500", img)
        log(f"[main] lit stress-500 {width}x{height} {spp[1]} spp: {dt:.2f} s "
            f"({width * height * spp[1] / dt / 1e6:.3f} M pixel-samples/s)")

    total = {}
    for counts in (
        drive("stress-500", lambda: timed_cli(
            "stress-500", cli_args("stress.png", spp[0]), spp[0]),
            ["sphere_closest_hit"]),
        drive("lit stress-500", lit, ["sphere_closest_hit", "sphere_any_hit"]),
        drive("doom_standin", lambda: timed_cli(
            "doom_standin", [DOOM] + cli_args("doom.png", spp[2]), spp[2]),
            ["tri_closest_hit", "tri_any_hit"]),
        drive("dragon_standin", lambda: timed_cli(
            "dragon_standin", [DRAGON] + cli_args("dragon.png", spp[3]), spp[3]),
            ["tri_closest_hit", "tri_any_hit"]),
    ):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def capture_inputs(run, module, names, call_index=1):
    """Run run() with the kernel wrappers `names` of `module` spied on.
    Returns, per wrapper name, copies of the arguments of its call number
    call_index (0-based)."""
    import torch

    origs = {n: getattr(module, n) for n in names}
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
        setattr(module, n, spy(n))
    try:
        run()
    finally:
        for n in names:
            setattr(module, n, origs[n])
    if len(saved) < len(names):
        raise AssertionError(f"wrapper calls {calls}: fewer than {call_index + 1}")
    return saved


def where_time_goes(device, kind, label, make_scene, width=720, height=480,
                    lanes=65536, spp=4, timer=time_ms):
    """Phase 6 for one scene: one render_samples call on one main-path tile
    under torch.profiler: wall time against device-busy time, the traversal
    kernels' share, and the kernel launches per bounce iteration.  Then the
    scene's closest-hit and any-hit kernels held and timed on the inputs
    that tile's second bounce iteration gave them.  Returns per-kernel
    records at that shape."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paths_tpu_torch import camera as C
    from paths_tpu_torch.ops import sphere_traverse as ST
    from paths_tpu_torch.ops import tri_traverse as TT
    from paths_tpu_torch.render import render_samples, tiled_pixel_order

    module, names, ch_name, src = {
        "sphere": (ST, ("closest_hit_spheres", "occludes_spheres"),
                   "sphere_closest_hit", "sphere_traverse"),
        "tri": (TT, ("closest_hit_tris", "occludes_tris"), "tri_closest_hit",
                "tri_traverse"),
    }[kind]
    static, scene, cam = make_scene()
    cam = C.resize(cam, width, height)
    pix = torch.as_tensor(
        tiled_pixel_order(width, height)[:lanes].astype(np.int64), device=device)
    px, py = (pix % width).to(torch.int32), (pix // width).to(torch.int32)
    # Warm-up, capturing the second bounce iteration's kernel inputs.
    cap = capture_inputs(
        lambda: render_samples(static, scene, cam, px, py, pix, 0, 1, 0), module, names)
    torch.cuda.synchronize()
    before = launch_counts()[ch_name]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t = time.perf_counter()
        render_samples(static, scene, cam, px, py, pix, 1, spp, 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    iters = launch_counts()[ch_name] - before  # one closest-hit per path_step

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # Device-side rows only (kernels, copies): the operator rows on the host
    # carry the same device time again.
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    if busy_ms == 0:
        log(f"[profile] {label}: wall {wall_ms:.1f} ms over {iters} bounce "
            "iterations; the profiler traced no device time")
    else:
        n_launch = sum(e.count for e in rows)
        kern_ms = sum(dev_us(e) for e in rows if src in e.key) / 1e3
        top = sorted(rows, key=dev_us, reverse=True)[:4]
        log(f"[profile] {label}, {lanes} lanes, {spp} spp: wall {wall_ms:.1f} ms, "
            f"{iters} bounce iterations; device busy {busy_ms:.1f} ms "
            f"({100 * busy_ms / wall_ms:.1f}% of wall); {src} kernels {kern_ms:.2f} ms "
            f"({100 * kern_ms / wall_ms:.2f}% of wall); {n_launch} device kernels "
            f"({n_launch / max(iters, 1):.0f} per iteration); top: "
            + "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.2f} ms x{e.count}" for e in top))

    ch_in, ah_in = cap[names[0]], cap[names[1]]
    return measure(kind, f"{label} main-path tile", ch_in[0], ch_in[1],
                   tuple(ch_in[2:]), tuple(ah_in[2:]), timer,
                   plain_reps=kind == "sphere")


def gpu_vs_cpu(device):
    """Phase 7: the whole path with kernels vs with the plain versions, on
    the mixed scene (all four kernels)."""
    import numpy as np

    from paths_tpu_torch import camera as C
    from paths_tpu_torch.render import render_image
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_mixed_scene

    imgs = []
    with tempfile.TemporaryDirectory() as tmp:
        for dev in (device, "cpu"):
            static, scene, cam = build_scene(generate_mixed_scene(tmp, n_spheres=40),
                                             device=dev)
            assert static.sph_chunks > 0 and static.tri_chunks > 0
            static = dataclasses.replace(static, max_bounces=3)
            imgs.append(render_image(static, scene, C.resize(cam, 48, 32), 48, 32,
                                     spp=2, seed=0))
    a, b = imgs
    rel = float(np.mean((a - b) ** 2) / (np.mean(b ** 2) + 1e-12))
    if not rel < 1e-4:
        raise AssertionError(f"GPU vs CPU relative MSE {rel:.3e} >= 1e-4")
    log(f"[gpu-vs-cpu] mixed scene 48x32 2 spp: relative MSE {rel:.3e} (< 1e-4)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAIL: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_lit_stress_scene
    from paths_tpu_torch.scene.yaml_loader import load_scene_description

    t_start = time.time()
    device = torch.device("cuda")
    smi = nvidia_smi("name,power.limit")
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t = time.time()
    built = build_all()
    log(f"[build] built and loaded in {time.time() - t:.1f} s (started together): "
        + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))

    frame = sphere_kernel_phases(device)
    mesh = {"doom": tri_kernel_phases(device, DOOM, "doom_standin"),
            "dragon": tri_kernel_phases(device, DRAGON, "dragon_standin")}

    with tempfile.TemporaryDirectory() as tmp:
        launches = main_path(device, tmp)
    log(f"[main] kernel launches over the four paths: {launches}")

    tile = where_time_goes(
        device, "sphere", "lit stress-500",
        lambda: build_scene(generate_lit_stress_scene(500), device=device))
    tile.update(where_time_goes(
        device, "tri", "doom_standin",
        lambda: build_scene(load_scene_description(DOOM), device=device)))
    gpu_vs_cpu(device)

    # ms, plain_ms and bound_ms are at the main path's shape (one tile of
    # bounce and shadow rays); frame_* at a full incoherent frame (spheres)
    # and doom_*/dragon_* at the 65,536-lane subsets (triangles; their
    # frame_ms at the full incoherent frame).
    recs = []
    for name in KERNELS:
        r = dict(name=name, route="cuda", **KERNELS[name], launches=launches[name],
                 max_abs_err=tile[name]["max_abs_err"], ms=tile[name]["ms"],
                 plain_ms=tile[name]["plain_ms"], bound_ms=tile[name]["bound_ms"],
                 bound_by=tile[name]["bound_by"], library_ms=None)
        if name.startswith("sphere"):
            r["max_abs_err"] = max(r["max_abs_err"], frame[name]["max_abs_err"])
            r.update(frame_ms=frame[name]["ms"], frame_plain_ms=frame[name]["plain_ms"],
                     frame_bound_ms=frame[name]["bound_ms"])
        else:
            for m, rec in mesh.items():
                r["max_abs_err"] = max(r["max_abs_err"], rec[name]["max_abs_err"])
                r.update({f"{m}_{k}": rec[name][k] for k in
                          ("ms", "plain_ms", "bound_ms", "bound_by", "frame_ms")})
        recs.append(r)
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": recs}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
