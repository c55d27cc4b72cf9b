#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paths_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero before the last line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels (csrc/sphere_traverse.cu, csrc/tri_traverse.cu,
     csrc/flat_spheres.cu, csrc/chunk_scan.cu; nvcc with ptxas -v) and the
     C++ BVH builder (csrc/bvh_builder.cc, g++), all started together, timed;
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
  3c/4c. the same for K5 (the flat kernels) on the same table and frames,
     and for K8 and K9's sphere form on the stress-500 spheres packed at 16
     rows per chunk; a bound belongs to the function, so K5's and K8/K9's
     are K1/K2's (counted on the scene's 2-row chunks of the same rows);
  3b/4b. parity and timing, triangles: K3/K4 on the doom_standin table (96k
     triangles, 8 rows per chunk) and the dragon_standin table (200k, 20 rows
     per chunk).  The kernels are timed on full 720x480 frames of primary
     and of incoherent rays; they are held equal to their plain versions
     (flat brute force, timed once) on 65,536 of those lanes -- every
     tenth-or-so primary ray and the first 32,768 incoherent rays -- where
     the bound is counted too;
  3d/4d. the same for K7 and K9's triangle form on the doom_standin table
     repacked at 32 rows per chunk (the same leaves), bounded as K3/K4 are,
     on the scene's 8-row chunks;
  5. main path: each path driven with the launch counts set to 0 just before
     it and read just after: the CLI renders the 500-sphere stress scene at
     720x480, 8 spp (K1); the lit stress scene renders at 720x480, 4 spp
     (K1, K2); the CLI renders scenes/doom_standin.yml at 720x480, 4 spp and
     scenes/dragon_standin.yml at 720x480, 2 spp (K3, K4); then, with
     PATHS_TPU_SPH_FLAT=1, the CLI on stress-500 at 720x480, 8 spp (K5
     closest-hit, and no K1/K2) and the lit stress scene at 720x480, 4 spp
     (both K5 forms), each image held to its walk-route counterpart (same
     seed) at relative MSE < 1e-4.  Images must be finite, non-negative and
     not all zero.  K7-K9 are reached through the ops API only (phases
     3c-4d), so their main-path launches are 0;
  6. profile: one main-path tile (65,536 lanes) of the lit stress scene, one
     of doom_standin and one of the lit stress scene on the flat route under
     torch.profiler (wall vs device-busy time, the kernels' share, launches
     per bounce); then each kernel held against its plain version and timed,
     as in 3/4, on the inputs that tile's second bounce iteration gave it;
  7. GPU vs CPU: the mixed sphere + mesh scene (40 spheres, 128 triangles, a
     sphere light) at 48x32, 2 spp, 3 bounces, rendered with the kernels and
     with the plain versions on the CPU, must agree to relative MSE < 1e-4:
     on the walk route (K1-K4) and on the flat route (K5, K3, K4).
Then a JSON line of per-kernel results (ms, plain_ms and bound_ms at the main
path's tile for K1-K5; at the doom subset for K7 and K9's triangle form and
at the incoherent stress-500 frame for K8 and K9's sphere form; frame_* and
doom_*/dragon_* at the shapes of 4, 4b and 4d), the nvidia-smi name/power
line, and the final JSON status line.  Needs one CUDA device.
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
    "flat_sphere_closest_hit": dict(
        replaces="paths_tpu/ops/pallas_traverse.py:1049",
        source="paths_tpu_torch/csrc/flat_spheres.cu"),
    "flat_sphere_any_hit": dict(
        replaces="paths_tpu/ops/pallas_traverse.py:1049",
        source="paths_tpu_torch/csrc/flat_spheres.cu"),
    "scan_tri_closest_hit": dict(
        replaces="paths_tpu/ops/pallas_traverse.py:538",
        source="paths_tpu_torch/csrc/chunk_scan.cu"),
    "scan_sphere_closest_hit": dict(
        replaces="paths_tpu/ops/pallas_traverse.py:995",
        source="paths_tpu_torch/csrc/chunk_scan.cu"),
    "scan_tri_any_hit": dict(
        replaces="paths_tpu/ops/pallas_traverse.py:840",
        source="paths_tpu_torch/csrc/chunk_scan.cu"),
    "scan_sphere_any_hit": dict(
        replaces="paths_tpu/ops/pallas_traverse.py:854",
        source="paths_tpu_torch/csrc/chunk_scan.cu"),
}
FLAT_ENV = "PATHS_TPU_SPH_FLAT"
DOOM = os.path.join(REPO, "scenes", "doom_standin.yml")
DRAGON = os.path.join(REPO, "scenes", "dragon_standin.yml")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _kernel_modules():
    from paths_tpu_torch.ops import chunk_scan as CS
    from paths_tpu_torch.ops import sphere_traverse as ST
    from paths_tpu_torch.ops import tri_traverse as TT

    return ST, TT, CS


def reset_launch_counts():
    for m in _kernel_modules():
        m.reset_launch_counts()


def launch_counts() -> dict:
    return {k: v for m in _kernel_modules() for k, v in m.LAUNCHES.items()}


class flat_route:
    """Builds inside the block choose the flat sphere kernel
    (PATHS_TPU_SPH_FLAT=1, read by the scene build)."""

    def __enter__(self):
        self.before = os.environ.get(FLAT_ENV)
        os.environ[FLAT_ENV] = "1"

    def __exit__(self, *exc):
        if self.before is None:
            os.environ.pop(FLAT_ENV, None)
        else:
            os.environ[FLAT_ENV] = self.before


# ---------------------------------------------------------------- phase 2

def build_all():
    """Build the four CUDA libraries and the C++ BVH builder at once (one
    compiler process each), then bind them; returns {source: seconds}."""
    from paths_tpu_torch import native
    from paths_tpu_torch.bvh import build as BB

    ST, TT, CS = _kernel_modules()

    def timed(fn):
        t = time.time()
        fn()
        return time.time() - t

    def nvcc(source):
        return lambda: native.load_library(source, native.nvcc(), native.NVCC_FLAGS,
                                           verbose=True)

    jobs = {"sphere_traverse.cu": lambda: ST.build_kernels(verbose=True),
            "tri_traverse.cu": lambda: TT.build_kernels(verbose=True),
            "flat_spheres.cu": nvcc("flat_spheres.cu"),
            "chunk_scan.cu": nvcc("chunk_scan.cu"),
            "bvh_builder.cc": BB._native_lib}
    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {name: ex.submit(timed, fn) for name, fn in jobs.items()}
        built = {name: f.result() for name, f in futures.items()}
    CS.build_kernels()  # binds the two libraries just built
    return built


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


def _families():
    """kind -> (row test, closest-hit (name, wrapper, plain), any-hit (name,
    wrapper, plain)).  Every wrapper and plain version takes (table,
    n_chunks, o, d, excl, t_init) or (table, n_chunks, o, d, excl, excl_ent,
    t_max); the flat kernels read table.tris only."""
    ST, TT, CS = _kernel_modules()
    rows_only = lambda fn: lambda tab, nc, *a: fn(tab.tris, *a)
    sph_ch = rows_only(ST.closest_hit_spheres_plain)
    sph_ah = rows_only(ST.occludes_spheres_plain)
    return {
        "sphere": ("sphere", ("sphere_closest_hit", ST.closest_hit_spheres, sph_ch),
                   ("sphere_any_hit", ST.occludes_spheres, sph_ah)),
        "tri": ("tri", ("tri_closest_hit", TT.closest_hit_tris, TT.closest_hit_tris_plain),
                ("tri_any_hit", TT.occludes_tris, TT.occludes_tris_plain)),
        "flat": ("sphere",
                 ("flat_sphere_closest_hit", rows_only(CS.flat_closest_hit), sph_ch),
                 ("flat_sphere_any_hit", rows_only(CS.flat_occludes), sph_ah)),
        "scan_sphere": ("sphere",
                        ("scan_sphere_closest_hit", CS.closest_hit_spheres, sph_ch),
                        ("scan_sphere_any_hit", CS.occludes_spheres, sph_ah)),
        "scan_tri": ("tri",
                     ("scan_tri_closest_hit", CS.closest_hit_chunked,
                      TT.closest_hit_tris_plain),
                     ("scan_tri_any_hit", CS.occludes_chunked, TT.occludes_tris_plain)),
    }


def measure(kind, label, table, nc, ch_args, ah_args, timer, plain_reps=True,
            bound_on=None):
    """Hold the closest-hit and any-hit kernels of one family (a key of
    _families()) against their plain versions on these inputs (equal outputs),
    time both, and bound both by the work these inputs need.  ch_args = (o,
    d, excl, t_init); ah_args = (o, d, excl, excl_ent, t_max).  The plain
    versions are timed like the kernels (plain_reps) or, for the triangle
    brute force, once.  The bound belongs to the function, not to the table
    the kernel reads: bound_on = (table, n_chunks) counts the needed work on
    the finest chunking of the same rows (default: the kernel's own table).
    Returns {name: dict(max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    import torch

    rows, (ch_name, ch, ch_plain), (ah_name, ah, ah_plain) = _families()[kind]
    bound_table, bound_nc = bound_on or (table, nc)
    peak_ops, peak_txt = fp32_peak(ch_args[0].device)
    lane_in = 24 + 4 + 4  # o, d, excl, seed

    t_hit = ch(table, nc, *ch_args)
    plain_ch_ms, want = time_once(lambda: ch_plain(table, nc, *ch_args))
    err_ch = check_equal(f"{ch_name} {label}", t_hit, want)
    occ = ah(table, nc, *ah_args)
    plain_ah_ms, want = time_once(lambda: ah_plain(table, nc, *ah_args))
    err_ah = check_equal(f"{ah_name} {label}", occ, want)
    t_occ = nearest_occluder(rows, table, nc, *ah_args)
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
        pairs, table_bytes = needed_work(bound_table.chunk_meta, bound_nc,
                                         SLOTS_PER_ROW[rows], args[0], args[1], answer)
        bytes_ = table_bytes + n * (lane_in + extra_in + out_bytes)
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = pairs * OPS_PER_PAIR[rows] / peak_ops * 1e3
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
    """Phases 3/4 and 3c/4c: parity and timing of K1/K2, K5 (the same
    table) and K8/K9 (the same spheres packed at 16 rows per chunk) at the
    stress-500 scene and width x height lanes.  All three compute one
    function, so all three are bounded on the scene's 2-row chunks.
    Returns per-kernel records."""
    import torch

    ST, _, CS = _kernel_modules()
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_stress_scene

    static, scene, cam = build_scene(generate_stress_scene(500), device=device)
    ps, nc = scene.psph, static.sph_chunks
    cpu = lambda x: x.cpu().double().numpy()
    ps16, nc16, _ = ST.pack_spheres_chunked(
        cpu(scene.sph_center), cpu(scene.sph_radius), ent=scene.sph_ent.cpu().numpy(),
        rows_per_chunk=CS.SPH_ROWS_PER_CHUNK, device=device)
    n = width * height
    po, pd = primary_rays(cam, width, height, device)
    o, d, excl, t_init, excl_ent, t_max = incoherent_rays(
        n, (-50.0, -50.0, 0.0), (50.0, 50.0, 100.0), static.n_spheres,
        static.n_entities, device, t_span=150.0)
    p_excl = torch.full((n,), -1, dtype=torch.int32, device=device)
    p_t = torch.full((n,), BIG, device=device)

    recs = {}
    for kind, label, table, chunks in (("sphere", "K1/K2", ps, nc),
                                       ("flat", "K5", ps, nc),
                                       ("scan_sphere", "K8/K9", ps16, nc16)):
        _, (ch_name, ch, ch_plain), (ah_name, ah, ah_plain) = _families()[kind]
        err = check_equal(f"{ch_name} primary", ch(table, chunks, po, pd, p_excl, p_t),
                          ch_plain(table, chunks, po, pd, p_excl, p_t))
        err = max(err, check_equal(
            f"{ah_name} primary", ah(table, chunks, po, pd, p_excl, excl_ent, t_max),
            ah_plain(table, chunks, po, pd, p_excl, excl_ent, t_max)))
        fam = measure(kind, "incoherent frame", table, chunks, (o, d, excl, t_init),
                      (o, d, excl, excl_ent, t_max), timer, bound_on=(ps, nc))
        hits = int((ch(table, chunks, o, d, excl, t_init)[0] < BIG).sum().item())
        occl = int(ah(table, chunks, o, d, excl, excl_ent, t_max).sum().item())
        log(f"[parity] {label} == plain at {n} lanes x {table.tris.shape[0] * 16} "
            f"slots, {chunks} chunks of {int(table.chunk_meta[0, 7].item())} rows "
            f"(primary + incoherent rays; incoherent: {hits} hits, {occl} occluded)")
        t_prim = timer(lambda: ch(table, chunks, po, pd, p_excl, p_t))
        log(f"[timing] {ch_name} on primary rays: {t_prim:.4f} ms")
        for r in fam.values():
            r["max_abs_err"] = max(r["max_abs_err"], err)
        recs.update(fam)
    return recs


def repack_tris(scene, rows_per_chunk, device):
    """The scene's triangle table repacked at rows_per_chunk rows per chunk,
    over the same leaves (one table row each, read back from the table's
    gids) and the scene's BVH-ordered triangles.  Returns (PackedTris,
    n_chunks)."""
    import types

    import numpy as np

    from paths_tpu_torch.ops import tri_traverse as TT

    gid = scene.ptris.tris.cpu().reshape(-1, TT.PACK_LEAF, TT.TRI_STRIDE)[:, :, 12]
    gid = gid.numpy().astype(np.int64)
    count = (gid >= 0).sum(1)
    leaves = count > 0
    flat = types.SimpleNamespace(prim_count=count[leaves], prim_start=gid[leaves, 0])
    f64 = lambda x: x.cpu().double().numpy()
    pt, nc = TT.pack_chunked(flat, f64(scene.tri_v0), f64(scene.tri_v1),
                             f64(scene.tri_v2), f64(scene.tri_n),
                             ent=scene.tri_ent.cpu().numpy(), rows_per_chunk=rows_per_chunk)
    return TT.PackedTris(*(x.to(device) for x in pt)), nc


def tri_kernel_phases(device, scene_path, label, width=720, height=480,
                      timer=time_ms, scan=False):
    """Phases 3b and 4b for one mesh scene: K3/K4 timed on a full frame of
    primary rays and one of incoherent rays, held equal to their plain
    versions and bounded on SUBSET of those lanes (every (n / (SUBSET/2))-th
    primary ray and the first SUBSET/2 incoherent rays; the primary lanes'
    any-hit queries take the incoherent set's excl_ent and t_max).  With
    scan, phases 3d/4d: the same for K7/K9 on the table repacked at 32 rows
    per chunk, bounded as K3/K4 are, on the scene's own chunks of the same
    leaves.  Returns per-kernel records at the subset, with frame_ms
    added."""
    import torch

    from paths_tpu_torch.ops import chunk_scan as CS
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.yaml_loader import load_scene_description

    t = time.time()
    static, scene, cam = build_scene(load_scene_description(scene_path), device=device)
    tables = [("tri", "K3/K4", scene.ptris, static.tri_chunks, static.tri_rows)]
    log(f"[build] {label}: {static.n_tris} triangles, {static.tri_chunks} chunks of "
        f"{static.tri_rows} rows, table {scene.ptris.tris.shape[0]} rows; scene "
        f"built in {time.time() - t:.1f} s")
    if scan:
        pt, nc = repack_tris(scene, CS.TRI_ROWS_PER_CHUNK, device)
        tables.append(("scan_tri", "K7/K9", pt, nc, CS.TRI_ROWS_PER_CHUNK))
        log(f"[build] {label} repacked: {nc} chunks of {CS.TRI_ROWS_PER_CHUNK} rows, "
            f"table {pt.tris.shape[0]} rows")
    n = width * height
    meta = scene.ptris.chunk_meta[:static.tri_chunks]
    po, pd = primary_rays(cam, width, height, device)
    o, d, excl, t_init, excl_ent, t_max = incoherent_rays(
        n, meta[:, 0:3].amin(0), meta[:, 3:6].amax(0), static.n_tris,
        static.n_entities, device)
    p_excl = torch.full((n,), -1, dtype=torch.int32, device=device)
    p_t = torch.full((n,), BIG, device=device)
    half = SUBSET // 2
    sel = torch.arange(half, device=device) * (n // half)
    cat = lambda a, b: torch.cat([a[sel], b[:half]]).contiguous()
    so, sd_, sx = cat(po, o), cat(pd, d), cat(p_excl, excl)

    recs = {}
    for kind, kernels, pt, nc, rows in tables:
        _, (ch_name, ch, _), (ah_name, ah, _) = _families()[kind]
        frame = {
            "primary": timer(lambda: ch(pt, nc, po, pd, p_excl, p_t)),
            ch_name: timer(lambda: ch(pt, nc, o, d, excl, t_init)),
            ah_name: timer(lambda: ah(pt, nc, o, d, excl, excl_ent, t_max)),
        }
        hits = int((ch(pt, nc, po, pd, p_excl, p_t)[0] < BIG).sum().item())
        log(f"[timing] {label} frame ({rows}-row chunks), {n} lanes: {ch_name} "
            f"primary {frame['primary']:.3f} ms ({hits} hits), incoherent "
            f"{frame[ch_name]:.3f} ms; {ah_name} incoherent {frame[ah_name]:.3f} ms")
        fam = measure(kind, f"{label} subset", pt, nc, (so, sd_, sx, cat(p_t, t_init)),
                      (so, sd_, sx, torch.cat([excl_ent[half:SUBSET], excl_ent[:half]]),
                       torch.cat([t_max[half:SUBSET], t_max[:half]])),
                      timer, plain_reps=False, bound_on=(scene.ptris, static.tri_chunks))
        log(f"[parity] {label}: {kernels} == plain at {SUBSET} lanes x "
            f"{pt.tris.shape[0] * 8} slots ({rows}-row chunks)")
        for name, r in fam.items():
            r["frame_ms"] = frame[name]
        recs.update(fam)
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


def drive(name, run, kernels, absent=()):
    """Drive one path with the launch counts set to 0 just before it and read
    just after; each of `kernels` must have launched, and none of `absent`.
    Returns (counts, what run returned)."""
    reset_launch_counts()
    out = run()
    counts = launch_counts()
    log(f"[main] {name}: kernel launches {counts}")
    for k in kernels:
        if counts[k] <= 0:
            raise AssertionError(f"{k} was not launched on the {name} path")
    for k in absent:
        if counts[k] != 0:
            raise AssertionError(f"{k} was launched on the {name} path")
    return counts, out


def rel_mse(a, b):
    import numpy as np

    return float(np.mean((a - b) ** 2) / (np.mean(b ** 2) + 1e-12))


def main_path(device, out_dir, width=720, height=480, spp=(8, 4, 4, 2)):
    """Phase 5: the CLI on the stress scene, the lit stress scene through the
    library entry points, the CLI on the two mesh scenes, then the stress
    and lit stress scenes again on the flat route, each image held to its
    walk-route counterpart.  Returns the summed launch counts of the six
    paths."""
    import numpy as np
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
        return img

    def lit(name):
        static, scene, cam = build_scene(generate_lit_stress_scene(500), device=device)
        t = time.time()
        img = render_image(static, scene, C.resize(cam, width, height), width,
                           height, spp=spp[1], seed=0)
        dt = time.time() - t
        check_image(name, img)
        log(f"[main] {name} {width}x{height} {spp[1]} spp: {dt:.2f} s "
            f"({width * height * spp[1] / dt / 1e6:.3f} M pixel-samples/s; "
            f"sph_flat={static.sph_flat})")
        return img

    walk = ["sphere_closest_hit", "sphere_any_hit"]
    runs = [
        drive("stress-500", lambda: timed_cli(
            "stress-500", cli_args("stress.png", spp[0]), spp[0]),
            ["sphere_closest_hit"]),
        drive("lit stress-500", lambda: lit("lit stress-500"), walk),
        drive("doom_standin", lambda: timed_cli(
            "doom_standin", [DOOM] + cli_args("doom.png", spp[2]), spp[2]),
            ["tri_closest_hit", "tri_any_hit"]),
        drive("dragon_standin", lambda: timed_cli(
            "dragon_standin", [DRAGON] + cli_args("dragon.png", spp[3]), spp[3]),
            ["tri_closest_hit", "tri_any_hit"]),
    ]
    with flat_route():
        runs += [
            drive("stress-500 flat", lambda: timed_cli(
                "stress-500 flat", cli_args("stress_flat.png", spp[0]), spp[0]),
                ["flat_sphere_closest_hit"], absent=walk),
            drive("lit stress-500 flat", lambda: lit("lit stress-500 flat"),
                  ["flat_sphere_closest_hit", "flat_sphere_any_hit"], absent=walk),
        ]
    for (_, walk_img), (_, flat_img), name in zip(runs[:2], runs[4:], ("stress-500", "lit stress-500")):
        rel = rel_mse(flat_img, walk_img)
        diff = float(np.abs(flat_img - walk_img).max())
        log(f"[main] {name}: flat route vs walk route, relative MSE {rel:.3e}, "
            f"largest absolute difference {diff:.3e}")
        if not rel < 1e-4:
            raise AssertionError(f"{name}: flat vs walk relative MSE {rel:.3e} >= 1e-4")
    total = {}
    for counts, _ in runs:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def capture_inputs(run, module, names, call_index=1):
    """Run run() with the kernel wrappers `names` of `module` spied on.
    Returns, per wrapper name, the arguments of its call number call_index
    (0-based), tensors cloned."""
    import torch

    origs = {n: getattr(module, n) for n in names}
    calls = {}
    saved = {}
    copy = lambda a: a.clone() if isinstance(a, torch.Tensor) else a

    def spy(name):
        def call(*args):
            if calls.get(name, 0) == call_index:
                saved[name] = [copy(a) for a in args]
            calls[name] = calls.get(name, 0) + 1
            return origs[name](*args)
        return call

    for n in names:
        setattr(module, n, spy(n))
    try:
        run()
    finally:
        for n in names:
            setattr(module, n, origs[n])
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
    from paths_tpu_torch.render import render_samples, tiled_pixel_order

    ST, TT, CS = _kernel_modules()
    module, names, ch_name, src = {
        "sphere": (ST, ("closest_hit_spheres", "occludes_spheres"),
                   "sphere_closest_hit", "sphere_traverse"),
        "tri": (TT, ("closest_hit_tris", "occludes_tris"), "tri_closest_hit",
                "tri_traverse"),
        "flat": (CS, ("flat_closest_hit", "flat_occludes"), "flat_sphere_closest_hit",
                 "flat_spheres"),
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

    if set(cap) != set(names):
        raise AssertionError(f"kernel calls captured: {sorted(cap)}")
    ch_a, ah_a = cap[names[0]], cap[names[1]]
    if kind == "flat":  # (rows, o, d, ...): the bound counts K1's chunks
        table, nc, ch_args, ah_args = scene.psph, static.sph_chunks, ch_a[1:], ah_a[1:]
    else:  # (table, n_chunks, o, d, ...)
        table, nc, ch_args, ah_args = ch_a[0], ch_a[1], ch_a[2:], ah_a[2:]
    return measure(kind, f"{label} main-path tile", table, nc, ch_args, ah_args,
                   timer, plain_reps=kind != "tri")


def gpu_vs_cpu(device, flat=False):
    """Phase 7: the whole path with kernels vs with the plain versions, on
    the mixed scene: K1-K4, or on the flat route (flat=True) K5, K3, K4."""
    from paths_tpu_torch import camera as C
    from paths_tpu_torch.render import render_image
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_mixed_scene

    imgs = []
    with tempfile.TemporaryDirectory() as tmp:
        for dev in (device, "cpu"):
            if flat:
                with flat_route():
                    static, scene, cam = build_scene(
                        generate_mixed_scene(tmp, n_spheres=40), device=dev)
            else:
                static, scene, cam = build_scene(
                    generate_mixed_scene(tmp, n_spheres=40), device=dev)
            assert static.sph_chunks > 0 and static.tri_chunks > 0
            assert static.sph_flat == flat
            static = dataclasses.replace(static, max_bounces=3)
            imgs.append(render_image(static, scene, C.resize(cam, 48, 32), 48, 32,
                                     spp=2, seed=0))
    rel = rel_mse(*imgs)
    route = "flat" if flat else "walk"
    if not rel < 1e-4:
        raise AssertionError(f"GPU vs CPU ({route} route) relative MSE {rel:.3e} >= 1e-4")
    log(f"[gpu-vs-cpu] mixed scene 48x32 2 spp, {route} route: relative MSE "
        f"{rel:.3e} (< 1e-4)")


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
    mesh = {"doom": tri_kernel_phases(device, DOOM, "doom_standin", scan=True),
            "dragon": tri_kernel_phases(device, DRAGON, "dragon_standin")}

    with tempfile.TemporaryDirectory() as tmp:
        launches = main_path(device, tmp)
    log(f"[main] kernel launches over the six paths: {launches}")

    tile = where_time_goes(
        device, "sphere", "lit stress-500",
        lambda: build_scene(generate_lit_stress_scene(500), device=device))
    tile.update(where_time_goes(
        device, "tri", "doom_standin",
        lambda: build_scene(load_scene_description(DOOM), device=device)))

    def flat_lit():
        with flat_route():
            return build_scene(generate_lit_stress_scene(500), device=device)

    tile.update(where_time_goes(device, "flat", "lit stress-500 flat route", flat_lit))
    gpu_vs_cpu(device)
    gpu_vs_cpu(device, flat=True)

    # ms, plain_ms and bound_ms are at the main path's shape (one tile of
    # bounce and shadow rays) for K1-K5; K7-K9 are off the main path, so
    # theirs are at the doom subset (triangles) and the incoherent stress-500
    # frame (spheres).  frame_* at a full incoherent frame (spheres) and
    # doom_*/dragon_* at the 65,536-lane subsets (triangles; their frame_ms
    # at the full incoherent frame).
    recs = []
    for name in KERNELS:
        at = tile.get(name) or (mesh["doom"] if name.startswith("scan_tri")
                                else frame)[name]
        r = dict(name=name, route="cuda", **KERNELS[name], launches=launches[name],
                 **{k: at[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by")}, library_ms=None)
        if name in frame:
            r["max_abs_err"] = max(r["max_abs_err"], frame[name]["max_abs_err"])
            r.update(frame_ms=frame[name]["ms"], frame_plain_ms=frame[name]["plain_ms"],
                     frame_bound_ms=frame[name]["bound_ms"])
        for m, rec in mesh.items():
            if name in rec:
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
