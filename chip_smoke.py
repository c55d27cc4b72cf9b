#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paths_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero before the last line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels (csrc/sphere_traverse.cu, csrc/tri_traverse.cu,
     csrc/flat_spheres.cu, csrc/packet_bvh.cu; nvcc with
     ptxas -v, whose registers, stack frame, spills and shared memory are
     printed per kernel) and the C++ BVH builder (csrc/bvh_builder.cc, g++),
     all started together, timed;
  3. parity, spheres: K1/K2 against their plain PyTorch versions on the
     card, at the stress-500 table and a full 720x480 frame of lanes
     (345,600): primary camera rays and incoherent rays (5% dead lanes, 20%
     exclusions, random excl_ent / t_max); the outputs must be equal;
  4. timing, spheres: CUDA events, median of 25 launches after warm-up, for
     each kernel and its plain version (a wrapper call from an idle card,
     the host's part included), and the kernel's device time (25 calls
     queued behind a spin kernel, so that the host's part is hidden),
     beside its bound: the larger of the
     needed bytes over 3.35 TB/s and FP32 operations per needed (ray, slot)
     pair over the FP32 peak SMs x 128 x max SM clock (an FMA counts as one).
     A leaf of K1's tree over the slots (at most 4 slots, the finest
     division of the same rows) is needed when some lane enters its box
     before the lane's answer is settled: its closest hit, its nearest
     occluder or the end of its ray.  The needed pairs are those leaves'
     slots for each such lane; the needed bytes are those slots and the
     tree nodes some lane enters, read once, and the lanes' inputs and
     outputs;
  3g. K1/K2 and both forms of K5 held equal to their plain versions on
     4,096 adversarial lanes of the stress-500 table, and K8 and K9's sphere
     form on the same lanes over the same spheres packed at 16 rows: rays
     aimed exactly at sphere centres and grazing spheres (the discriminant
     within rounding of 0), t_init and t_max at a lane's exact hit and
     occluder distances, t_max == 0, dead lanes, zero direction components,
     origins on a plane of the tree's boxes;
  3c/4c. the same for K5 (the flat kernels) on the same table and frames
     (each family also held on the frame's first 65,536 incoherent lanes),
     and for K8 and K9's sphere form on the stress-500 spheres packed at 16
     rows per chunk (K8 and K9 walk that table's tree with K1's and K2's
     kernels); a bound belongs to the function, so K5's and K8/K9's
     are K1/K2's (counted on the leaves of K1's tree over the same rows).
     K5 tests every slot for every lane, so its all-pairs floor (lanes x
     slots x OPS_PER_MISSED_PAIR over the FP32 peak) is printed beside;
  3b/4b. parity and timing, triangles: K3/K4 on the doom_standin table (96k
     triangles, 8 rows per chunk) and the dragon_standin table (200k, 20 rows
     per chunk).  The kernels are timed on full 720x480 frames of primary
     and of incoherent rays; they are held equal to their plain versions
     (flat brute force, timed once) on 65,536 of those lanes -- every
     tenth-or-so primary ray and the first 32,768 incoherent rays -- where
     the bound is counted too;
  3d/4d. the same for K7 and K9's triangle form on the doom_standin table
     repacked at 32 rows per chunk (the same BVH and leaves), and K3/K4 on
     that same table and subset beside them: K7/K9 launch K3/K4's walks, so
     the two time the same kernel through two wrappers;
  3f. K3/K4 held equal to their plain versions on 4,096 adversarial lanes
     of each table (doom at 8 and 32 rows, dragon at 20), and K7/K9 on the
     same lanes of doom at 32 rows: rays aimed exactly
     at vertices and edge midpoints (exact t ties between triangles), t_init
     and t_max at a lane's exact hit and occluder distances, t_max == 0,
     dead lanes, zero direction components, origins on a box plane;
  3e/4e. K6 on the BVH route's table of each mesh scene (the same BVH and
     leaves): held equal to its plain version on 65,536 primary rays and on
     65,536 incoherent rays (t_init 0 where t_max is 0), on both full
     frames and on 4,096 adversarial lanes (as 3f's, with origins on planes
     of K6's tree and t_init at K6's own exact hit distances), timed on the
     subsets and frames, with K3 timed on the same rays beside it.  Every
     triangle kernel is bounded on the BVH's leaves of at most 8 triangles,
     the finest division of the same rows: the needed pairs (the 8 slots of
     each leaf a lane enters before its answer) and the needed bytes (those
     leaves' rows and the compact nodes a lane enters, read once);
  5. main path: each path driven with the launch counts set to 0 just before
     it and read just after: the CLI renders the 500-sphere stress scene at
     720x480, 8 spp (K1); the lit stress scene renders at 720x480, 4 spp
     (K1, K2); the CLI renders scenes/doom_standin.yml at 720x480, 4 spp and
     scenes/dragon_standin.yml at 720x480, 2 spp (K3, K4); then, with
     PATHS_TPU_SPH_FLAT=1, the CLI on stress-500 at 720x480, 8 spp (K5
     closest-hit, and no K1/K2) and the lit stress scene at 720x480, 4 spp
     (both K5 forms), each image held to its walk-route counterpart (same
     seed) at relative MSE < 1e-4; then doom_standin (4 spp) and
     dragon_standin (2 spp) at 720x480 on the BVH route
     (build_scene(..., bvh_threshold=32768), render_image): K6 launched,
     K3/K4 not, each image compared with its kernel-route counterpart (same
     seed; relative MSE below BVH_VS_KERNEL_REL_MSE); then the HDRI sky
     with environment NEE: (a) the CLI on scenes/env_demo.yml --env-nee at
     720x480, 4 spp (three small spheres and the ground: no kernel may
     launch) and (b) the lit stress scene under scenes/assets/sunrise.hdr
     with env_nee on (hdri_lit_scene) at 720x480, 4 spp through
     build_scene and render_image (K1; K2 for the light's and the
     environment's shadow queries, so more K2 launches than the lit stress
     run).  Images must be finite, non-negative and not all zero.  K7-K9
     are reached through the ops API only (phases 3c-4d), so their
     main-path launches are 0;
  6. profile: one main-path tile (65,536 lanes) of the lit stress scene, of
     doom_standin, of the lit stress scene on the flat route, of
     doom_standin on the BVH route, and of dragon_standin (2 spp) on the
     kernel and the BVH route, and of configuration (b), under
     torch.profiler (wall vs device-busy time, the kernels' share, launches
     per bounce iteration); then each kernel held against its plain version
     and timed, as in 3/4, on the inputs that tile's second bounce
     iteration gave it (on the flat route also K1/K2 on the same rays; on
     (b) K2 on the environment NEE query: t_max BIG, excl_ent -1);
  7. GPU vs CPU: the mixed sphere + mesh scene (a 128-triangle grid, a
     sphere light) at 48x32, 2 spp, 3 bounces, rendered with the kernels and
     with the plain versions on the CPU, must agree to relative MSE < 1e-4:
     with 40 spheres on the walk route (K1-K4) and on the flat route (K5,
     K3, K4), and with 8 spheres on the BVH route (bvh_threshold=64: K6 on
     the card, its plain version on the CPU; each of the card's K6 queries
     held bit for bit against the plain version on its inputs); and
     scenes/env_demo.yml with environment NEE (the HDRI tables and lookups).
     On each, phase 8 (c): loss_and_grad of a 48x32 wave on the card and
     on the CPU, every gradient field finite and equal to rtol 2e-3, atol
     1e-5;
  8. gradients on the card (paths_tpu_torch.grad), 720x480, 1 spp: (a)
     loss_and_grad on the lit stress scene (K1, K2) over all 345,600 lanes
     against a target rendered with the albedo of its most-seen
     albedo-reading entity perturbed, in tiles if a probe tile's peak
     memory says the frame would not fit: the forward and backward times,
     peak memory and kernel launches of one step, then 10 steps of gradient
     descent on that albedo, the loss falling at every step to below 10% of
     its start; (b) doom_standin's kernel route (K3, K4): pixel_gradient
     with respect to tri_vc0 on a 65,536-lane tile, sum(g * tri_vc0)
     against a central difference with tri_vc0 scaled by 1 +- 1e-2, rtol
     2e-2;
  9. resume and progressive rendering: stress-500 at 720x480, 8 spp whole,
     and 4 spp checkpointed to a file, loaded and resumed to 8: equal bit
     for bit; 20 pumps of ProgressiveRenderer at 720x480 (a preview wave,
     then full waves), frames per second, the camera moved while a wave is
     in flight and that wave dropped; validate_radiance on every image.
Then a JSON line of per-kernel results (launches summed over the paths of
phases 5, 8 (a, b) and 9; ms, device_ms, plain_ms and bound_ms at the main
path's tile for K1-K6, env_tile_* at configuration (b)'s for K1/K2; at the
doom subset for K7 and K9's triangle form and
at the incoherent stress-500 frame for K8 and K9's sphere form; frame_* and
doom_*/dragon_* at the shapes of 4, 4b, 4d and 4e), the nvidia-smi name/power
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
# FP32 operations per (ray, slot) test, counted from the row tests, an FMA
# as one: a sphere slot ~25; a plane-form triangle slot 32 (six three-term
# dot products of one multiply and two FMAs, t's subtraction and division,
# bx/by's add and FMA, bz's two subtractions, six comparisons); a
# vertex-layout slot (K6) 53 (two dot products, 6; the cos == 0 test and
# select, 2; t's subtraction and division, 2; p's three FMAs; nine
# subtractions for pa, pb, pc; two n.(a x b) of three multiplies, three FMAs
# and a dot product, 18; bx, by's multiplies, 2; bz's subtractions, 2; nine
# comparisons).
OPS_PER_PAIR = {"sphere": 25, "tri": 32, "vtri": 53}
# FP32 operations of a sphere slot whose discriminant is negative, where the
# flat kernel (K5) stops: 3 subtractions for o - c, b's multiply and two
# FMAs, c2's multiply, two FMAs and subtraction, the discriminant's FMA and
# its comparison.  K5 tests every slot for every lane, so lanes x slots x
# this over the FP32 peak is the floor of its all-pairs design.
OPS_PER_MISSED_PAIR = 12
ROW_BYTES = 512  # a table, meta or node row of 128 floats
SLOT_BYTES = 64  # a triangle slot of 16 floats (both triangle layouts)
NODE_BYTES = 40  # a node's box, links, first primitive and count (10 floats)
SPHERE_SLOT_BYTES = 32  # a sphere slot of 8 floats
TREE_NODE_BYTES = 32  # a walk node [lo.xyz ref | hi.xyz aux]
BIG = 3.4e38
SUBSET = 65536  # lanes held against the plain triangle versions
BVH_THRESHOLD = 32768  # build_scene's bvh_threshold for the BVH route (the reference's default)
# A mesh scene's BVH-route image against its kernel-route image (same seed):
# K6 and K3/K4 round differently, so a path may part at a grazing hit; the
# repo's image tolerance.
BVH_VS_KERNEL_REL_MSE = 1e-4
# K6 against K3 on the same rays: two row tests (vertex layout, plane form)
# that round differently, so a lane may part at a triangle's edge: at most
# this share of lanes may part on hit or on id.  Where both hit the same
# triangle, t is held to the rounding of one ray-plane intersection, t =
# (n.v0 - n.o) / n.d in f32: about 4 units of 2^-24 (|o|_1 + |v0|_1 + t) /
# |n.d| to first order in each function (the f32 normal, the three-term
# dots, the subtraction and the division), so 8 between two; the gate
# allows twice that.  t relative to itself is no measure: the numerator
# cancels where the origin is far from a short hit.
K6_VS_K3_PART = 1e-4
K6_VS_K3_T_UNITS = 16

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
        source="paths_tpu_torch/csrc/tri_traverse.cu"),
    "scan_sphere_closest_hit": dict(
        replaces="paths_tpu/ops/pallas_traverse.py:995",
        source="paths_tpu_torch/csrc/sphere_traverse.cu"),
    "scan_tri_any_hit": dict(
        replaces="paths_tpu/ops/pallas_traverse.py:840",
        source="paths_tpu_torch/csrc/tri_traverse.cu"),
    "scan_sphere_any_hit": dict(
        replaces="paths_tpu/ops/pallas_traverse.py:854",
        source="paths_tpu_torch/csrc/sphere_traverse.cu"),
    "packet_closest_hit": dict(
        replaces="paths_tpu/ops/pallas_traverse.py:1094",
        source="paths_tpu_torch/csrc/packet_bvh.cu"),
}
FLAT_ENV = "PATHS_TPU_SPH_FLAT"
DOOM = os.path.join(REPO, "scenes", "doom_standin.yml")
DRAGON = os.path.join(REPO, "scenes", "dragon_standin.yml")
ENV_DEMO = os.path.join(REPO, "scenes", "env_demo.yml")
SUNRISE = os.path.join(REPO, "scenes", "assets", "sunrise.hdr")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _kernel_modules():
    from paths_tpu_torch.ops import chunk_scan as CS
    from paths_tpu_torch.ops import packet_traverse as PK
    from paths_tpu_torch.ops import sphere_traverse as ST
    from paths_tpu_torch.ops import tri_traverse as TT

    return ST, TT, CS, PK


def reset_launch_counts():
    for m in _kernel_modules():
        m.reset_launch_counts()


def launch_counts() -> dict:
    return {k: v for m in _kernel_modules() for k, v in m.LAUNCHES.items()}


def hdri_lit_scene(device):
    """Configuration (b): the lit stress scene (500 spheres, one sphere light)
    under the bundled sunrise HDRI, with environment NEE on: (static,
    scene, camera)."""
    from paths_tpu_torch.scene import desc as D
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_lit_stress_scene

    sd = generate_lit_stress_scene(500)
    sd.skybox = D.SkyboxD(kind="hdri", filename=SUNRISE)
    static, scene, cam = build_scene(sd, device=device)
    return dataclasses.replace(static, env_nee=True), scene, cam


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
    """Build the four CUDA libraries and csrc/bvh_builder.cc at once (one
    compiler process each), then bind them; returns {source: seconds}."""
    from paths_tpu_torch import native
    from paths_tpu_torch.bvh import build as BB

    ST, TT, CS, PK = _kernel_modules()

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
            "packet_bvh.cu": lambda: PK.build_kernels(verbose=True),
            "bvh_builder.cc": BB._native_lib}
    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {name: ex.submit(timed, fn) for name, fn in jobs.items()}
        built = {name: f.result() for name, f in futures.items()}
    CS.build_kernels()  # binds the library just built
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


def needed_work(lo, hi, slots, o, d, t_answer):
    """(pairs, entered): the (ray, slot) tests the function needs for these
    rays over boxes [lo, hi] (B, 3) holding `slots` (B,) slots each.  A box
    is needed by a lane when the lane's ray enters it before t_answer, the
    distance at which the lane's answer is settled (its closest hit, its
    nearest occluder, or the end of its segment); a front-to-back walk that
    stops there tests no fewer, and dead lanes and lanes with t_answer <= 0
    need none.  pairs counts each needed box's slots once per lane that
    needs it; entered (B,) marks the boxes some lane needs."""
    import torch

    total = 0
    entered = torch.zeros(lo.shape[0], dtype=torch.bool, device=lo.device)
    step = max(256, (1 << 23) // max(lo.shape[0], 1))
    for a in range(0, o.shape[0], step):
        oo, dd, tt = o[a:a + step], d[a:a + step], t_answer[a:a + step]
        inv = 1.0 / dd
        t0 = (lo[None] - oo[:, None]) * inv[:, None]
        t1 = (hi[None] - oo[:, None]) * inv[:, None]
        tmin = torch.nan_to_num(torch.minimum(t0, t1), nan=-BIG).amax(2)
        tmax = torch.nan_to_num(torch.maximum(t0, t1), nan=BIG).amin(2)
        cross = (tmin < tmax) & (tmin < tt[:, None]) & (tmax > 0)
        cross &= ((oo[:, 0] <= 1e29) & (tt > 0))[:, None]
        total += int((cross.double() @ slots.double()).sum().item())
        entered |= cross.any(0)
    return total, entered


def leaf_bound(pbvh):
    """The bound's work counted on the skip-link BVH's leaves of at most 8
    triangles (the BVH route's K6 table: pbvh.nodes holds each node's box
    and triangle count, one row for each of pbvh.tree's): the prim_count
    triangles of each needed leaf, and as bytes those triangles' slots (64
    B each) and the 10 floats a walk reads of every needed node, inner or
    leaf (box, links, first primitive and count: 40 B), each read once.  The
    leaves are the triangle table's rows in both routes, so this bounds
    K3/K4 and K6 alike."""
    nodes = pbvh.nodes[: pbvh.tree.shape[0]]
    count = nodes[:, 9]

    def bound(o, d, t_answer):
        pairs, entered = needed_work(nodes[:, 0:3], nodes[:, 3:6], count, o, d, t_answer)
        tris = int(count[entered].sum().item())
        return pairs, tris * SLOT_BYTES + int(entered.sum().item()) * NODE_BYTES
    return bound


def sphere_leaf_bound(ps):
    """The bound's work counted on the leaves of K1's tree over the sphere
    slots (ps.nodes: at most 4 slots a leaf, the finest division of the same
    rows), for every sphere kernel: each needed leaf's slots, and as bytes
    those slots (32 B each) and the 32 B of every node some lane enters,
    each read once.  A node's box here is unpadded: a leaf's, its spheres'
    box (centre -+ sqrt(r^2)); an inner node's, the union of its
    children's."""
    import numpy as np
    import torch

    nodes = ps.nodes.cpu().numpy()
    slots = ps.tris.cpu().numpy().reshape(-1, 8).astype(np.float64)
    rad = np.sqrt(np.maximum(slots[:, 3], 0.0))[:, None]
    slo, shi = slots[:, 0:3] - rad, slots[:, 0:3] + rad
    ref, aux = nodes[:, 3].astype(np.int64), nodes[:, 7].astype(np.int64)
    m = len(nodes)
    lo, hi, count = np.zeros((m, 3)), np.zeros((m, 3)), np.zeros(m)
    for i in range(m - 1, -1, -1):  # children after parents in preorder
        if ref[i] < 0:
            a = -1 - ref[i]
            lo[i], hi[i], count[i] = slo[a:a + aux[i]].min(0), shi[a:a + aux[i]].max(0), aux[i]
        else:
            lo[i] = np.minimum(lo[ref[i]], lo[aux[i]])
            hi[i] = np.maximum(hi[ref[i]], hi[aux[i]])
    dev = ps.tris.device
    lo, hi, count = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                     for x in (lo, hi, count))

    def bound(o, d, t_answer):
        pairs, entered = needed_work(lo, hi, count, o, d, t_answer)
        used = int(count[entered].sum().item()) * SPHERE_SLOT_BYTES
        return pairs, used + int(entered.sum().item()) * TREE_NODE_BYTES
    return bound


def bound_record(kind, n_lanes, lane_bytes, pairs, table_bytes, peak_ops):
    """(bound_ms, bound_by): the larger of the needed bytes (table_bytes and
    lane_bytes per lane) over the HBM rate and the needed pairs' FP32
    operations over the FP32 peak."""
    t_bytes = (table_bytes + n_lanes * lane_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * OPS_PER_PAIR[kind] / peak_ops * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


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


def k6_vs_k3(label, k6, k3, o, d, tri_v0, tri_n):
    """Hold K6's answers (t, idx, ent) against K3's on the same rays (o, d):
    the lanes that part on hit or miss and on id (at most K6_VS_K3_PART of
    them), and t where both hit the same triangle (within K6_VS_K3_T_UNITS
    of that triangle's intersection rounding; tri_v0, tri_n: the triangles
    in the order both tables share).  Returns (hit parts, id parts)."""
    import torch

    (ta, ia, _), (tb, ib, _) = k6, k3
    ha, hb = ta < BIG, tb < BIG
    both = ha & hb
    hit_parts = int((ha != hb).sum().item())
    id_parts = int((both & (ia != ib)).sum().item())
    same = both & (ia == ib)
    k = ib.long()[same]
    oo, dd, t = o[same], d[same], tb[same]
    cos = ((tri_n[k] * dd).sum(1) / dd.norm(dim=1)).abs()
    unit = 2.0 ** -24 * (oo.abs().sum(1) + tri_v0[k].abs().sum(1) + t.abs()) / cos
    dt = (ta[same] - t).abs()
    worst = float((dt / unit).max().item()) if k.numel() else 0.0
    rel = dt / t.abs()
    n = o.shape[0]
    log(f"[parity] {label}, {n} lanes: K6 vs K3 part on {hit_parts} lanes by hit "
        f"or miss and on {id_parts} by id ({int(ha.sum().item())} and "
        f"{int(hb.sum().item())} hits); same triangle: t within {worst:.3f} units "
        f"of its rounding (relative to t: largest "
        f"{float(rel.max().item()) if k.numel() else 0.0:.3e}, "
        f"{int((rel > 1e-5).sum().item())} lanes above 1e-5)")
    if hit_parts + id_parts > K6_VS_K3_PART * n:
        raise AssertionError(f"{label}: K6 and K3 part on {hit_parts + id_parts} of "
                             f"{n} lanes (more than {K6_VS_K3_PART:g} of them)")
    if not worst <= K6_VS_K3_T_UNITS:
        raise AssertionError(f"{label}: K6's t differs from K3's by {worst:.3f} units "
                             f"of its rounding (> {K6_VS_K3_T_UNITS})")
    return hit_parts, id_parts


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


def time_device_ms(fn, reps=25):
    """ms of one call's device work: reps calls queued behind a spin kernel
    (torch.cuda._sleep), so that the host's part of each call -- the
    wrapper's checks, allocations and launch, tens of microseconds -- runs
    while the card is still busy, timed by CUDA events around the reps and
    divided by reps.  time_ms, by contrast, times one call from an idle card,
    host part included, as the main path's host-bound loop pays it."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # about 25 ms at 2 GHz: longer than reps enqueues
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


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
    ST, TT, CS, _ = _kernel_modules()
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


def measure(kind, label, table, nc, ch_args, ah_args, timer, bound, plain_reps=True):
    """Hold the closest-hit and any-hit kernels of one family (a key of
    _families()) against their plain versions on these inputs (equal outputs),
    time both, and bound both by the work these inputs need.  ch_args = (o,
    d, excl, t_init); ah_args = (o, d, excl, excl_ent, t_max).  The plain
    versions are timed like the kernels (plain_reps) or, for the triangle
    brute force, once.  The bound belongs to the function, not to the table
    the kernel reads: bound(o, d, t_answer) -> (pairs, table_bytes) counts
    it on the finest division of the same rows (sphere_leaf_bound,
    leaf_bound).  Returns {name: dict(max_abs_err, ms, plain_ms, bound_ms,
    bound_by)}."""
    import torch

    rows, (ch_name, ch, ch_plain), (ah_name, ah, ah_plain) = _families()[kind]
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
        device_ms = time_device_ms(lambda: run(table, nc, *args))
        if plain_reps:
            plain_ms = timer(lambda: plain(table, nc, *args))
        pairs, table_bytes = bound(args[0], args[1], answer)
        bound_ms, bound_by = bound_record(rows, n, lane_in + extra_in + out_bytes,
                                          pairs, table_bytes, peak_ops)
        recs[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, device_ms=device_ms)
        floor = ""
        if kind == "flat":
            n_slots = table.tris.shape[0] * 16
            floor_ms = n * n_slots * OPS_PER_MISSED_PAIR / peak_ops * 1e3
            floor = (f"; all-pairs floor {floor_ms:.4f} ms ({n} x {n_slots} "
                     f"pairs x {OPS_PER_MISSED_PAIR} FP32 operations)")
        log(f"[timing] {name}, {label}, {n} lanes: {ms:.4f} ms, device "
            f"{device_ms:.4f} ms (plain "
            f"{plain_ms:.3f} ms), bound {bound_ms:.4f} ms by {bound_by} "
            f"({pairs} needed pair tests, {table_bytes} needed table bytes; FP32 "
            f"peak {peak_ops / 1e12:.2f} T op/s = {peak_txt}){floor}")
    return recs


def measure_packet(label, pbvh, args, timer, bound):
    """K6 on these inputs (o, d, excl, t_init): held equal to its plain
    version, the kernel timed (median of 25) and the plain version once,
    bounded by bound (leaf_bound).  Returns {name: record}."""
    import torch

    PK = _kernel_modules()[3]
    peak_ops, peak_txt = fp32_peak(args[0].device)
    got = PK.closest_hit_packet(pbvh, *args)
    plain_ms, want = time_once(lambda: PK.closest_hit_packet_plain(pbvh, *args))
    err = check_equal(f"packet_closest_hit {label}", got, want)
    ms = timer(lambda: PK.closest_hit_packet(pbvh, *args))
    device_ms = time_device_ms(lambda: PK.closest_hit_packet(pbvh, *args))
    n = args[0].shape[0]
    pairs, table_bytes = bound(args[0], args[1], torch.minimum(got[0], args[-1]))
    bound_ms, bound_by = bound_record("vtri", n, 24 + 4 + 4 + 12, pairs,
                                      table_bytes, peak_ops)
    hits = int((got[0] < BIG).sum().item())
    log(f"[timing] packet_closest_hit, {label}, {n} lanes ({hits} hits): {ms:.4f} ms, "
        f"device {device_ms:.4f} ms "
        f"(plain {plain_ms:.3f} ms, equal), bound {bound_ms:.4f} ms by {bound_by} "
        f"({pairs} needed pair tests, {table_bytes} needed table bytes; FP32 peak "
        f"{peak_ops / 1e12:.2f} T op/s = {peak_txt})")
    return {"packet_closest_hit": dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by,
                                       device_ms=device_ms)}


def sphere_kernel_phases(device, width=720, height=480, timer=time_ms):
    """Phases 3/4 and 3c/4c: parity and timing of K1/K2, K5 (the same
    table) and K8/K9 (the same spheres packed at 16 rows per chunk) at the
    stress-500 scene and width x height lanes, and 3g: K1/K2 on adversarial
    lanes of the same table.  All three compute one function, so all three
    are bounded on the leaves of K1's tree (sphere_leaf_bound).  Returns
    per-kernel records."""
    import torch

    ST, _, CS, _ = _kernel_modules()
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
        m = min(SUBSET, n)  # a main-path tile's size
        sub = [x[:m].contiguous() for x in (o, d, excl, t_init, excl_ent, t_max)]
        err = max(err, check_equal(f"{ch_name} tile-size subset", ch(table, chunks, *sub[:4]),
                                   ch_plain(table, chunks, *sub[:4])),
                  check_equal(f"{ah_name} tile-size subset",
                              ah(table, chunks, *sub[:3], *sub[4:]),
                              ah_plain(table, chunks, *sub[:3], *sub[4:])))
        fam = measure(kind, "incoherent frame", table, chunks, (o, d, excl, t_init),
                      (o, d, excl, excl_ent, t_max), timer, bound=sphere_leaf_bound(ps))
        hits = int((ch(table, chunks, o, d, excl, t_init)[0] < BIG).sum().item())
        occl = int(ah(table, chunks, o, d, excl, excl_ent, t_max).sum().item())
        log(f"[parity] {label} == plain at {n} lanes x {table.tris.shape[0] * 16} "
            f"slots, {chunks} chunks of {int(table.chunk_meta[0, 7].item())} rows "
            f"(primary + incoherent rays, and the first {m} incoherent lanes alone; "
            f"incoherent: {hits} hits, {occl} occluded)")
        t_prim = timer(lambda: ch(table, chunks, po, pd, p_excl, p_t))
        log(f"[timing] {ch_name} on primary rays: {t_prim:.4f} ms")
        for r in fam.values():
            r["max_abs_err"] = max(r["max_abs_err"], err)
        recs.update(fam)
        if kind == "flat":
            recs[ch_name]["primary_ms"] = t_prim
    err = hold_adversarial_spheres(ps, nc, ps16, nc16, static.n_entities, device)
    for name in ("sphere_closest_hit", "sphere_any_hit", "flat_sphere_closest_hit",
                 "flat_sphere_any_hit", "scan_sphere_closest_hit", "scan_sphere_any_hit"):
        recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], err)
    return recs


def adversarial_sphere_lanes(ps, nc, n, n_entities, device, seed=7):
    """n lanes that stress the sphere kernels' walks on a sphere table: rays
    from random points around a sphere aimed exactly at its centre (even
    lanes) or grazing it (odd lanes: aimed at the tangent point from the
    origin, moved to r (1 + e) from the centre, e a few units of 2^-24
    either way, so the discriminant lies within rounding of 0 and the
    square-root skip decides), a quarter excluding the aimed-at sphere; an eighth with a
    zero direction component, half of those starting exactly on a plane of
    K1's tree's boxes (a NaN slab distance); 1/16 dead; t_init set to the
    lane's exact closest-hit t on a quarter of the hitting lanes (the hit
    must not count) and t_max to its exact nearest occluder on a quarter
    of the occluded ones, an eighth 0.  Returns ((o, d, excl, t_init), (o,
    d, excl, excl_ent, t_max), counts)."""
    import torch

    ST = _kernel_modules()[0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g).to(device)
    slots = ps.tris.reshape(-1, 8)
    n_slots = int((slots[:, 4] >= 0).sum().item())
    k = torch.randint(0, n_slots, (n,), generator=g).to(device)
    c, r = slots[k, 0:3], slots[k, 3].sqrt()[:, None]
    lane = torch.arange(n, device=device)
    span = float((slots[:n_slots, 0:3].amax(0) - slots[:n_slots, 0:3].amin(0)).norm())
    off = torch.randn(n, 3, generator=g).to(device)
    off = off / off.norm(dim=1, keepdim=True)
    o = c + off * (r * 1.5 + u(n, 1) * span / 4)
    side = torch.randn(n, 3, generator=g).to(device)
    side = side - (side * off).sum(1, keepdim=True) * off  # across the ray
    side = side / side.norm(dim=1, keepdim=True)
    e = torch.randint(-4, 5, (n, 1), generator=g).to(device) * 2.0 ** -24
    cos = r / (o - c).norm(dim=1, keepdim=True)  # the tangent point's angle from off
    tangent = c + r * (1 + e) * (cos * off + (1 - cos * cos).sqrt() * side)
    aim = torch.where((lane % 2 == 0)[:, None], c, tangent)
    d = aim - o
    flat_axis = lane % 8 == 3
    axis = torch.randint(0, 3, (n,), generator=g).to(device)
    d[flat_axis, axis[flat_axis]] = 0.0
    on_plane = flat_axis & (lane % 16 == 3)
    pick = torch.randint(0, ps.nodes.shape[0], (n,), generator=g).to(device)
    o[on_plane, axis[on_plane]] = ps.nodes[pick[on_plane], axis[on_plane]]  # a box's lo
    d = d / d.norm(dim=1, keepdim=True)
    o[lane % 16 == 9] = 1e30
    excl = torch.where(lane % 4 == 1, slots[k, 4], -1.0).to(torch.int32)
    o, d = o.float().contiguous(), d.float().contiguous()
    big = torch.full((n,), BIG, device=device)
    first = ST.closest_hit_spheres_plain(ps.tris, o, d, excl, big)[0]
    exact = (lane % 4 == 2) & (first < BIG)
    t_init = torch.where(exact, first, big).contiguous()
    excl_ent = torch.randint(-1, n_entities, (n,), generator=g, dtype=torch.int32).to(device)
    near = nearest_occluder("sphere", ps, nc, o, d, excl, excl_ent, big)
    occl_exact = (lane % 4 == 0) & (near < float("inf"))
    t_max = torch.where(occl_exact, near,
                        torch.where(lane % 8 == 5, 0.0, u(n) * span)).contiguous()
    fields = ST._slot_fields(ps.tris)
    met, t = ST._row_test(fields, o, d, excl, torch.full((n,), float("inf"), device=device))
    t = torch.where(met, t, float("inf"))
    ties = int((((t == t.amin(1, keepdim=True)) & met).sum(1) > 1).sum().item())
    b = slots[k, 0:3] - o  # the discriminant of the aimed-at sphere, in f64
    along = (b.double() * d.double()).sum(1)
    disc = along ** 2 - ((b.double() ** 2).sum(1) - r[:, 0].double() ** 2)
    counts = dict(hits=int((first < BIG).sum().item()), exact_t_init=int(exact.sum().item()),
                  exact_t_max=int(occl_exact.sum().item()), ties=ties,
                  grazing=int(((lane % 2 == 1) & (disc.abs() < 1e-4 * r[:, 0].double() ** 2))
                              .sum().item()),
                  nan_slab=int(on_plane.sum().item()), zero_component=int(flat_axis.sum().item()))
    return (o, d, excl, t_init), (o, d, excl, excl_ent, t_max), counts


def hold_adversarial_spheres(ps, nc, ps16, nc16, n_entities, device, n=4096):
    """3g: K1, K2 and both forms of K5 against their plain versions on
    adversarial_sphere_lanes of the stress-500 table, and K8 and K9's sphere
    form on the same lanes over ps16 (the same spheres at 16 rows a chunk):
    equal outputs, bit for bit.  Returns the largest absolute difference
    (0)."""
    ST, _, CS, _ = _kernel_modules()
    ch_args, ah_args, counts = adversarial_sphere_lanes(ps, nc, n, n_entities, device)
    want_ch = ST.closest_hit_spheres_plain(ps.tris, *ch_args)
    want_ah = ST.occludes_spheres_plain(ps.tris, *ah_args)
    err = check_equal("sphere_closest_hit adversarial",
                      ST.closest_hit_spheres(ps, nc, *ch_args), want_ch)
    occ = ST.occludes_spheres(ps, nc, *ah_args)
    err = max(err, check_equal("sphere_any_hit adversarial", occ, want_ah))
    err = max(err, check_equal("flat_sphere_closest_hit adversarial",
                               CS.flat_closest_hit(ps.tris, *ch_args), want_ch),
              check_equal("flat_sphere_any_hit adversarial",
                          CS.flat_occludes(ps.tris, *ah_args), want_ah),
              check_equal("scan_sphere_closest_hit adversarial (16-row chunks)",
                          CS.closest_hit_spheres(ps16, nc16, *ch_args),
                          ST.closest_hit_spheres_plain(ps16.tris, *ch_args)),
              check_equal("scan_sphere_any_hit adversarial (16-row chunks)",
                          CS.occludes_spheres(ps16, nc16, *ah_args),
                          ST.occludes_spheres_plain(ps16.tris, *ah_args)))
    log(f"[parity] stress-500: K1/K2, K5 (G = {CS.FLAT_GROUP} threads a lane) and K8/K9 "
        f"(16-row chunks) == plain on "
        f"{n} adversarial lanes ({counts['hits']} "
        f"hits, {counts['grazing']} grazing lanes with the discriminant within 1e-4 r^2 "
        f"of 0, {counts['ties']} with an exact tie at the nearest hit, "
        f"{counts['exact_t_init']} with t_init at the exact hit t, {counts['exact_t_max']} "
        f"with t_max at the exact occluder t, {counts['zero_component']} with a zero "
        f"direction component, {counts['nan_slab']} of them on a box plane; "
        f"{int(occ.sum().item())} occluded)")
    return err


def repack_tris(scene, pbvh, rows_per_chunk, device):
    """The scene's triangle table repacked at rows_per_chunk rows per chunk,
    over the same BVH (pbvh: the BVH route's K6 table of the same mesh, so
    the same leaves and ids) and the scene's BVH-ordered triangles, with its
    hierarchy.  Returns (PackedTris, n_chunks)."""
    from paths_tpu_torch.ops import packet_traverse as PK
    from paths_tpu_torch.ops import tri_traverse as TT

    flat = PK.tree_shape(pbvh)
    f64 = lambda x: x.cpu().double().numpy()
    pt, nc = TT.pack_chunked(flat, f64(scene.tri_v0), f64(scene.tri_v1),
                             f64(scene.tri_v2), f64(scene.tri_n),
                             ent=scene.tri_ent.cpu().numpy(), rows_per_chunk=rows_per_chunk)
    return TT.PackedTris(*(x.to(device) for x in pt)), nc


def adversarial_lanes(scene, table, n_chunks, n, n_entities, device, seed=7):
    """n lanes that stress the walk kernels' tie and bound rules on a mesh
    table: rays aimed exactly at triangle vertices (shared by several
    triangles) and edge midpoints, from random points around them, a
    quarter excluding the aimed-at triangle; an eighth with a zero
    direction component, half of those starting exactly on a plane of the
    hierarchy's boxes (a NaN slab distance); 1/16 dead; t_init set to the
    lane's exact closest-hit t on a quarter of the hitting lanes (the hit
    must not count) and t_max to its exact nearest occluder on a quarter
    of the occluded ones, an eighth 0.  Returns ((o, d, excl, t_init),
    (o, d, excl, excl_ent, t_max), counts)."""
    import torch

    from paths_tpu_torch.ops import tri_traverse as TT

    o, d, excl, g, counts = adversarial_rays(scene, table.nodes, n, device, seed)
    u = lambda *s: torch.rand(*s, generator=g).to(device)
    lane = torch.arange(n, device=device)
    span = float((scene.tri_v0.amax(0) - scene.tri_v0.amin(0)).norm())
    t_init = torch.full((n,), BIG, device=device)
    first = TT.closest_hit_tris_plain(table, n_chunks, o, d, excl, t_init)[0]
    exact = (lane % 4 == 2) & (first < BIG)
    t_init = torch.where(exact, first, t_init).contiguous()
    excl_ent = torch.randint(-1, n_entities, (n,), generator=g, dtype=torch.int32).to(device)
    t_max = (u(n) * span).contiguous()
    near = nearest_occluder("tri", table, n_chunks, o, d, excl, excl_ent,
                            torch.full((n,), BIG, device=device))
    occl_exact = (lane % 4 == 0) & (near < float("inf"))
    t_max = torch.where(occl_exact, near, torch.where(lane % 8 == 5, 0.0, t_max)).contiguous()
    # Lanes whose nearest hit is shared by two or more slots: exact ties.
    f = TT._slots(table, n_chunks)
    ties = 0
    for a, b in TT._lane_steps(n, f["gid"].shape[0], o.device):
        met, t = TT._row_test(f, o[a:b], d[a:b], excl[a:b], torch.full((b - a,), BIG, device=device))
        t = torch.where(met, t, float("inf"))
        tmin = t.amin(1, keepdim=True)
        ties += int((((t == tmin) & met).sum(1) > 1).sum().item())
    counts.update(hits=int((first < BIG).sum().item()), exact_t_init=int(exact.sum().item()),
                  exact_t_max=int(occl_exact.sum().item()), ties=ties)
    return (o, d, excl, t_init), (o, d, excl, excl_ent, t_max), counts


def adversarial_rays(scene, nodes, n, device, seed):
    """The rays of adversarial_lanes over the scene's triangles (tri_v0..2,
    in the tables' order), with origins put on planes of the boxes of
    `nodes` ([lo.xyz ref | hi.xyz aux] rows).  Returns (o, d, excl, the
    generator, to draw the lanes' seeds from, counts)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g).to(device)
    v0, v1, v2 = scene.tri_v0, scene.tri_v1, scene.tri_v2
    k = torch.randint(0, v0.shape[0], (n,), generator=g).to(device)
    lane = torch.arange(n, device=device)
    aim = torch.where((lane % 2 == 0)[:, None], v0[k], 0.5 * (v1[k] + v2[k]))
    span = float((v0.amax(0) - v0.amin(0)).norm())
    off = torch.randn(n, 3, generator=g).to(device)
    o = aim + off / off.norm(dim=1, keepdim=True) * (1.0 + u(n, 1) * span / 4)
    d = aim - o
    flat_axis = lane % 8 == 3
    axis = torch.randint(0, 3, (n,), generator=g).to(device)
    d[flat_axis, axis[flat_axis]] = 0.0
    on_plane = flat_axis & (lane % 16 == 3)
    pick = torch.randint(0, nodes.shape[0], (n,), generator=g).to(device)
    o[on_plane, axis[on_plane]] = nodes[pick[on_plane], axis[on_plane]]  # a box's lo
    d = d / d.norm(dim=1, keepdim=True)
    o[lane % 16 == 9] = 1e30
    excl = torch.where(lane % 4 == 1, k, -1).to(torch.int32)
    counts = dict(nan_slab=int(on_plane.sum().item()), zero_component=int(flat_axis.sum().item()))
    return o.float().contiguous(), d.float().contiguous(), excl, g, counts


def hold_adversarial_packet(label, pbvh, scene, device, n=4096):
    """K6 against its plain version on the rays of adversarial_lanes (origins
    on planes of K6's tree), with t_init set to the lane's exact closest-hit
    t (K6's own row test) on a quarter of the hitting lanes: equal outputs,
    bit for bit.  Returns the largest absolute difference (0)."""
    import torch

    PK = _kernel_modules()[3]
    o, d, excl, _, counts = adversarial_rays(scene, pbvh.tree, n, device, seed=11)
    lane = torch.arange(n, device=device)
    big = torch.full((n,), BIG, device=device)
    first = PK.closest_hit_packet_plain(pbvh, o, d, excl, big)[0]
    exact = (lane % 4 == 2) & (first < BIG)
    t_init = torch.where(exact, first, big).contiguous()
    err = check_equal(f"packet_closest_hit {label} adversarial",
                      PK.closest_hit_packet(pbvh, o, d, excl, t_init),
                      PK.closest_hit_packet_plain(pbvh, o, d, excl, t_init))
    slots = pbvh.tris.reshape(-1, 16)
    ties = 0
    step = max(1, (1 << 24) // slots.shape[0])
    for a in range(0, n, step):
        b = min(a + step, n)
        met, t = PK._row_test(slots[None], o[a:b, None], d[a:b, None], excl[a:b, None],
                              torch.full((b - a, 1), float("inf"), device=device))
        met &= ~(o[a:b, 0:1] > 1e29)
        t = torch.where(met, t, float("inf"))
        ties += int((((t == t.amin(1, keepdim=True)) & met).sum(1) > 1).sum().item())
    log(f"[parity] {label}: K6 == plain on {n} adversarial lanes "
        f"({int((first < BIG).sum().item())} hits, {ties} with an exact tie at the "
        f"nearest hit, {int(exact.sum().item())} with t_init at the exact hit t, "
        f"{counts['zero_component']} with a zero direction component, "
        f"{counts['nan_slab']} of them on a box plane of K6's tree)")
    return err


def hold_adversarial(label, kind, table, n_chunks, scene, n_entities, device, n=4096):
    """K3 and K4 against their plain versions on adversarial_lanes, and with
    kind "scan_tri" K7 and K9 too: equal outputs, bit for bit.  Returns the
    largest absolute difference (0)."""
    from paths_tpu_torch.ops import tri_traverse as TT

    ch_args, ah_args, counts = adversarial_lanes(scene, table, n_chunks, n, n_entities,
                                                 device)
    want_ch = TT.closest_hit_tris_plain(table, n_chunks, *ch_args)
    want_ah = TT.occludes_tris_plain(table, n_chunks, *ah_args)
    kinds = ("tri", "scan_tri") if kind == "scan_tri" else ("tri",)
    err = 0.0
    for k in kinds:
        _, (ch_name, ch, _), (ah_name, ah, _) = _families()[k]
        occ = ah(table, n_chunks, *ah_args)
        err = max(err, check_equal(f"{ch_name} {label} adversarial",
                                   ch(table, n_chunks, *ch_args), want_ch),
                  check_equal(f"{ah_name} {label} adversarial", occ, want_ah))
    kernels = "K3/K4 and K7/K9" if kind == "scan_tri" else "K3/K4"
    log(f"[parity] {label}: {kernels} == plain on {n} adversarial lanes ({counts['hits']} "
        f"hits, {counts['ties']} with an exact tie at the nearest hit, "
        f"{counts['exact_t_init']} with t_init at the exact hit t, {counts['exact_t_max']} "
        f"with t_max at the exact occluder t, {counts['zero_component']} with a zero "
        f"direction component, {counts['nan_slab']} of them on a box plane; "
        f"{int(occ.sum().item())} occluded)")
    return err


def tri_kernel_phases(device, scene_path, label, width=720, height=480,
                      timer=time_ms, scan=False):
    """Phases 3b/4b and 3e/4e for one mesh scene, built on the kernel route
    and on the BVH route (the same BVH, so the same leaves and ids).

    3b/4b: K3/K4 timed on a full frame of primary rays and one of incoherent
    rays, held equal to their plain versions and bounded on SUBSET of those
    lanes (every (n / (SUBSET/2))-th primary ray and the first SUBSET/2
    incoherent rays; the primary lanes' any-hit queries take the incoherent
    set's excl_ent and t_max).  With scan, phases 3d/4d: the same for K7/K9
    on the table repacked at 32 rows per chunk.  3e/4e: K6 held equal to its
    plain version on SUBSET primary rays (every (n / SUBSET)-th) and on the
    first SUBSET incoherent rays (t_init 0 where t_max is), and timed there
    and on both full frames, with K3 timed on the same rays beside it and
    its answers held to K6's there (k6_vs_k3).  Every kernel is bounded on the BVH's leaves (leaf_bound): the finest
    division of the same rows, so one bound per function and rays.  Returns
    per-kernel records at the subsets, with frame_ms added (K6: at the
    incoherent subset, with primary_* and the K3 times beside)."""
    import torch

    from paths_tpu_torch.ops import chunk_scan as CS
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.yaml_loader import load_scene_description

    t = time.time()
    sd = load_scene_description(scene_path)
    static, scene, cam = build_scene(sd, device=device)
    tables = [("tri", "K3/K4", scene.ptris, static.tri_chunks, static.tri_rows)]
    log(f"[build] {label}: {static.n_tris} triangles, {static.tri_chunks} chunks of "
        f"{static.tri_rows} rows, table {scene.ptris.tris.shape[0]} rows; scene "
        f"built in {time.time() - t:.1f} s")
    t = time.time()
    bstatic, bscene, _ = build_scene(sd, device=device, bvh_threshold=BVH_THRESHOLD)
    assert bstatic.use_bvh and bstatic.tri_chunks == 0
    pbvh = bscene.pbvh
    log(f"[build] {label} BVH route: {pbvh.tree.shape[0]} nodes, "
        f"{int((pbvh.tree[:, 3] < 0).sum().item())} leaves, K6 table "
        f"{pbvh.tris.shape[0]} leaf rows; scene built in {time.time() - t:.1f} s")
    bound = leaf_bound(pbvh)
    if scan:
        pt, nc = repack_tris(scene, pbvh, CS.TRI_ROWS_PER_CHUNK, device)
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
    sub_ch = (so, sd_, sx, cat(p_t, t_init))
    sub_ah = (so, sd_, sx, torch.cat([excl_ent[half:SUBSET], excl_ent[:half]]),
              torch.cat([t_max[half:SUBSET], t_max[:half]]))

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
        fam = measure(kind, f"{label} subset", pt, nc, sub_ch, sub_ah, timer,
                      plain_reps=False, bound=bound)
        log(f"[parity] {label}: {kernels} == plain at {SUBSET} lanes x "
            f"{pt.tris.shape[0] * 8} slots ({rows}-row chunks)")
        for name, r in fam.items():
            r["frame_ms"] = frame[name]
        recs.update(fam)
        # 3f: K3/K4 on adversarial lanes of this table (on the repacked table
        # K7/K9 too); on the repacked table K3/K4 also on the subsets, held to
        # K7/K9, which equal the plain versions there (one table for both).
        err = hold_adversarial(f"{label} ({rows}-row chunks)", kind, pt, nc, scene,
                               static.n_entities, device)
        if kind == "scan_tri":
            _, (k3_name, k3, _), (k4_name, k4, _) = _families()["tri"]
            for name, fn, scan_fn, args in ((k3_name, k3, ch, sub_ch),
                                            (k4_name, k4, ah, sub_ah)):
                err = max(err, check_equal(f"{name} {label} subset ({rows}-row chunks)",
                                           fn(pt, nc, *args), scan_fn(pt, nc, *args)))
                recs[name][f"rows{rows}_ms"] = timer(lambda: fn(pt, nc, *args))
            log(f"[timing] {label} subset, {SUBSET} lanes, {rows}-row chunks: "
                f"{k3_name} {recs[k3_name][f'rows{rows}_ms']:.4f} ms, {k4_name} "
                f"{recs[k4_name][f'rows{rows}_ms']:.4f} ms (equal to K7/K9 and so to "
                "the plain versions; the same kernels as K7/K9, through K3/K4's "
                "wrappers)")
        for name in (ch_name, ah_name, "tri_closest_hit", "tri_any_hit"):
            recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], err)

    # 3e/4e: K6 on the BVH route's table, K3 on the same rays beside it.
    _, TT, _, PK = _kernel_modules()
    k6 = lambda *a: PK.closest_hit_packet(bscene.pbvh, *a)
    k3 = lambda *a: TT.closest_hit_tris(scene.ptris, static.tri_chunks, *a)
    psel = torch.arange(SUBSET, device=device) * (n // SUBSET)
    t0_inc = torch.where(t_max == 0, 0.0, t_init).contiguous()
    subsets = {
        "primary": tuple(x[psel].contiguous() for x in (po, pd, p_excl, p_t)),
        "incoherent": tuple(x[:SUBSET].contiguous() for x in (o, d, excl, t0_inc)),
    }
    packet = {}
    for which, args in subsets.items():
        r = measure_packet(f"{label} {which} subset", bscene.pbvh, args, timer, bound)
        r = r["packet_closest_hit"]
        r["k3_ms"] = timer(lambda: k3(*args))
        log(f"[timing] tri_closest_hit on the same {SUBSET} {which} lanes: "
            f"{r['k3_ms']:.4f} ms (K6 {r['ms']:.4f} ms)")
        r["k3_parts"] = k6_vs_k3(f"{label} {which} subset", k6(*args), k3(*args),
                                 args[0], args[1], scene.tri_v0, scene.tri_n)
        packet[which] = r
    frames = {"frame_primary_ms": (po, pd, p_excl, p_t),
              "frame_ms": (o, d, excl, t0_inc)}
    rec = dict(packet["incoherent"])
    for key, args in frames.items():
        rec[key] = timer(lambda: k6(*args))
        rec["k3_" + key] = timer(lambda: k3(*args))
        got = k6(*args)
        rec["max_abs_err"] = max(rec["max_abs_err"], check_equal(
            f"packet_closest_hit {label} {key[:-3].replace('_', ' ')}", got,
            PK.closest_hit_packet_plain(pbvh, *args)))
        hits = int((got[0] < BIG).sum().item())
        log(f"[timing] {label} {key[:-3].replace('_', ' ')}, {n} lanes: "
            f"packet_closest_hit {rec[key]:.3f} ms ({hits} hits), tri_closest_hit "
            f"{rec['k3_' + key]:.3f} ms")
        rec["k3_parts_" + key[:-3]] = k6_vs_k3(
            f"{label} {key[:-3].replace('_', ' ')}", got, k3(*args), args[0], args[1],
            scene.tri_v0, scene.tri_n)
    rec.update({f"primary_{k}": v for k, v in packet["primary"].items()
                if k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "k3_ms",
                         "k3_parts")})
    rec["max_abs_err"] = max(rec["max_abs_err"], *(r["max_abs_err"] for r in packet.values()),
                             hold_adversarial_packet(label, pbvh, bscene, device))
    log(f"[parity] {label}: K6 == plain at {SUBSET} primary and {SUBSET} incoherent "
        f"lanes, on both {n}-lane frames and on adversarial lanes "
        f"({pbvh.tris.shape[0]} leaf rows)")
    recs["packet_closest_hit"] = rec
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


def image_parts(name, a, b):
    """Log how image a differs from image b: the relative MSE, the pixels
    that differ at all, those that differ by more than 1e-3 of their value
    (paths that parted, not rounding), and the share of the squared error
    that the 100 worst pixels carry.  Returns the relative MSE."""
    import numpy as np

    err = ((a - b) ** 2).sum(-1).ravel()
    differ = int((err > 0).sum())
    parted = int((np.abs(a - b).max(-1) > 1e-3 * (np.abs(b).max(-1) + 1e-6)).sum())
    top = float(np.sort(err)[::-1][:100].sum() / max(float(err.sum()), 1e-30))
    rel = rel_mse(a, b)
    log(f"[main] {name}: relative MSE {rel:.3e}, {differ} of {err.size} pixels differ, "
        f"{parted} by more than 1e-3 of their value; the 100 worst pixels carry "
        f"{100 * top:.1f}% of the squared error")
    return rel


def main_path(device, out_dir, width=720, height=480, spp=(8, 4, 4, 2)):
    """Phase 5: the CLI on the stress scene, the lit stress scene through the
    library entry points, the CLI on the two mesh scenes, then the stress
    and lit stress scenes again on the flat route, each image held to its
    walk-route counterpart, the two mesh scenes again on the BVH route
    (build_scene(..., bvh_threshold=32768) and render_image, at the same
    spp and seed), each image compared with its kernel-route counterpart,
    then the CLI on env_demo with --env-nee (no kernel) and configuration
    (b), hdri_lit_scene, through the library entry points (K1, and K2 more
    often than on the lit stress scene).  Returns the summed launch counts
    of the ten paths."""
    import numpy as np
    import torch

    from paths_tpu_torch import camera as C
    from paths_tpu_torch import cli
    from paths_tpu_torch.render import render_image
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_lit_stress_scene
    from paths_tpu_torch.scene.yaml_loader import load_scene_description

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

    def lit(name, make=lambda: build_scene(generate_lit_stress_scene(500), device=device)):
        static, scene, cam = make()
        t = time.time()
        img = render_image(static, scene, C.resize(cam, width, height), width,
                           height, spp=spp[1], seed=0)
        dt = time.time() - t
        check_image(name, img)
        log(f"[main] {name} {width}x{height} {spp[1]} spp: {dt:.2f} s "
            f"({width * height * spp[1] / dt / 1e6:.3f} M pixel-samples/s; "
            f"sph_flat={static.sph_flat})")
        return img

    def bvh_route(name, path, n_spp):
        t = time.time()
        static, scene, cam = build_scene(load_scene_description(path), device=device,
                                         bvh_threshold=BVH_THRESHOLD)
        if not static.use_bvh:
            raise AssertionError(f"{name}: the build did not take the BVH route")
        t_build = time.time() - t
        t = time.time()
        img = render_image(static, scene, C.resize(cam, width, height), width,
                           height, spp=n_spp, seed=0)
        dt = time.time() - t
        check_image(name, img)
        log(f"[main] {name} {width}x{height} {n_spp} spp: {dt:.2f} s "
            f"({width * height * n_spp / dt / 1e6:.3f} M pixel-samples/s; scene "
            f"build {t_build:.2f} s more)")
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
    tri = ["tri_closest_hit", "tri_any_hit"]
    runs += [
        drive("doom_standin BVH route", lambda: bvh_route(
            "doom_standin BVH route", DOOM, spp[2]), ["packet_closest_hit"], absent=tri),
        drive("dragon_standin BVH route", lambda: bvh_route(
            "dragon_standin BVH route", DRAGON, spp[3]), ["packet_closest_hit"],
            absent=tri),
        # The HDRI sky with environment NEE: (a) the CLI on env_demo (three
        # small spheres and the ground: no kernel), (b) the lit stress
        # scene under the HDRI, whose second shadow query (t_max BIG, no
        # entity excluded) goes to K2 beside the light's.
        drive("env_demo --env-nee", lambda: timed_cli(
            "env_demo --env-nee", [ENV_DEMO, "--env-nee"] + cli_args("env_demo.png", spp[1]),
            spp[1]), [], absent=list(KERNELS)),
        drive("HDRI lit stress-500 env NEE", lambda: lit(
            "HDRI lit stress-500 env NEE", lambda: hdri_lit_scene(device)), walk),
    ]
    lit_k2, env_k2 = runs[1][0]["sphere_any_hit"], runs[9][0]["sphere_any_hit"]
    log(f"[main] sphere_any_hit launches: lit stress-500 {lit_k2}, with the HDRI sky "
        f"and environment NEE {env_k2} (closest hit {runs[9][0]['sphere_closest_hit']})")
    if not env_k2 > lit_k2:
        raise AssertionError("environment NEE did not add K2 launches to the lit "
                             f"stress scene ({env_k2} against {lit_k2})")
    for (_, walk_img), (_, flat_img), name in zip(runs[:2], runs[4:6], ("stress-500", "lit stress-500")):
        rel = rel_mse(flat_img, walk_img)
        diff = float(np.abs(flat_img - walk_img).max())
        log(f"[main] {name}: flat route vs walk route, relative MSE {rel:.3e}, "
            f"largest absolute difference {diff:.3e}")
        if not rel < 1e-4:
            raise AssertionError(f"{name}: flat vs walk relative MSE {rel:.3e} >= 1e-4")
    for (_, kernel_img), (_, bvh_img), name in zip(runs[2:4], runs[6:8],
                                                   ("doom_standin", "dragon_standin")):
        rel = image_parts(f"{name}: BVH route (K6) vs kernel route (K3/K4)", bvh_img,
                          kernel_img)
        if not rel < BVH_VS_KERNEL_REL_MSE:
            raise AssertionError(f"{name}: BVH vs kernel route relative MSE {rel:.3e} "
                                 f">= {BVH_VS_KERNEL_REL_MSE}")
    # Doom's difference split in two: the kernel route rendered again with
    # its shadow rays taken from K3's closest hit, as the BVH route takes
    # them from K6's.  Not a main path: its launches are not counted.
    from paths_tpu_torch import integrator as I

    def from_closest(static, scene, o, d, excl_kind, excl_idx, t_max, excl_ent):
        f, _, _, e, t = I.intersect_brief(static, scene, o, d, excl_kind, excl_idx)
        return f & (t < t_max) & (e != excl_ent)

    static, scene, cam = build_scene(load_scene_description(DOOM), device=device)
    any_hit, I.occluded_query = I.occluded_query, from_closest
    try:
        mixed = render_image(static, scene, C.resize(cam, width, height), width,
                             height, spp=spp[2], seed=0)
    finally:
        I.occluded_query = any_hit
    image_parts("doom_standin: shadows from K3's closest hit vs K4's any-hit, "
                "K3 closest hits", mixed, runs[2][1])
    image_parts("doom_standin: K6 vs K3 closest hits, shadows from the closest hit",
                runs[6][1], mixed)
    total = {}
    for counts, _ in runs:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def capture_inputs(run, module, names, call_indices):
    """Run run() with the kernel wrappers `names` of `module` spied on.
    Returns, per wrapper name, the arguments of its call number given by
    call_indices (0-based, one per name), tensors cloned."""
    import torch

    origs = {n: getattr(module, n) for n in names}
    call_index = dict(zip(names, call_indices))
    calls = {}
    saved = {}
    copy = lambda a: a.clone() if isinstance(a, torch.Tensor) else a

    def spy(name):
        def call(*args):
            if calls.get(name, 0) == call_index[name]:
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
                    lanes=65536, spp=4, timer=time_ms, bound=None):
    """Phase 6 for one scene: one render_samples call on one main-path tile
    under torch.profiler: wall time against device-busy time, the traversal
    kernels' share, and the kernel launches per bounce iteration.  Then the
    scene's traversal kernels held and timed on the inputs that tile's
    second bounce iteration gave them (closest-hit and any-hit; with kind
    "hdri", configuration (b), the any-hit query is that iteration's
    environment NEE query; on the BVH route, kind "packet", K6's
    closest-hit query of that iteration), bounded
    by `bound` (default: the leaves of K1's tree for the spheres and of the
    BVH for K6; the triangle kernels are given leaf_bound).  Returns
    per-kernel records at that shape."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paths_tpu_torch import camera as C
    from paths_tpu_torch import integrator as I
    from paths_tpu_torch.render import render_samples, tiled_pixel_order

    ST, TT, CS, PK = _kernel_modules()
    # (module, wrappers, kernel source in the profiler's names, call index of
    # the second bounce iteration's query, per wrapper): K6 takes the
    # closest-hit and the shadow query of every iteration; "hdri" (the lit
    # stress scene with environment NEE) makes two any-hit calls an
    # iteration, the light's and the environment's, so its fourth is the
    # environment's of the second iteration; the others one call per
    # wrapper.
    module, names, src, calls = {
        "sphere": (ST, ("closest_hit_spheres", "occludes_spheres"), "sphere_traverse", (1, 1)),
        "hdri": (ST, ("closest_hit_spheres", "occludes_spheres"), "sphere_traverse", (1, 3)),
        "tri": (TT, ("closest_hit_tris", "occludes_tris"), "tri_traverse", (1, 1)),
        "flat": (CS, ("flat_closest_hit", "flat_occludes"), "flat_spheres", (1, 1)),
        "packet": (PK, ("closest_hit_packet",), "packet_walk", (2,)),
    }[kind]
    static, scene, cam = make_scene()
    cam = C.resize(cam, width, height)
    pix = torch.as_tensor(
        tiled_pixel_order(width, height)[:lanes].astype(np.int64), device=device)
    px, py = (pix % width).to(torch.int32), (pix // width).to(torch.int32)
    # Warm-up, capturing the second bounce iteration's kernel inputs.
    cap = capture_inputs(
        lambda: render_samples(static, scene, cam, px, py, pix, 0, 1, 0), module,
        names, calls)
    torch.cuda.synchronize()
    step, iters = I.path_step, [0]

    def counted_step(*args):
        iters[0] += 1
        return step(*args)

    I.path_step = counted_step
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t = time.perf_counter()
            render_samples(static, scene, cam, px, py, pix, 1, spp, 0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        I.path_step = step
    iters = iters[0]

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
    if kind == "packet":  # (pbvh, o, d, excl, t_init)
        args = cap[names[0]]
        return measure_packet(f"{label} main-path tile", args[0], args[1:], timer,
                              bound or leaf_bound(scene.pbvh))
    ch_a, ah_a = cap[names[0]], cap[names[1]]
    if kind == "hdri":  # the environment's query: nothing bounds or excludes it
        excl_ent, t_max = ah_a[-2], ah_a[-1]
        if not (bool((t_max == BIG).all()) and bool((excl_ent == -1).all())):
            raise AssertionError(f"{label}: the captured any-hit call is not the "
                                 "environment's query")
        kind = "sphere"
    if kind == "flat":  # (rows, o, d, ...): the bound counts K1's tree's leaves
        table, nc, ch_args, ah_args = scene.psph, static.sph_chunks, ch_a[1:], ah_a[1:]
    else:  # (table, n_chunks, o, d, ...)
        table, nc, ch_args, ah_args = ch_a[0], ch_a[1], ch_a[2:], ah_a[2:]
    if kind != "tri":
        bound = bound or sphere_leaf_bound(scene.psph)
    recs = measure(kind, f"{label} main-path tile", table, nc, ch_args, ah_args,
                   timer, plain_reps=kind != "tri", bound=bound)
    if kind == "flat":  # K1/K2 on the same rays
        k1 = timer(lambda: ST.closest_hit_spheres(table, nc, *ch_args))
        k2 = timer(lambda: ST.occludes_spheres(table, nc, *ah_args))
        k1_dev = time_device_ms(lambda: ST.closest_hit_spheres(table, nc, *ch_args))
        k2_dev = time_device_ms(lambda: ST.occludes_spheres(table, nc, *ah_args))
        check_equal("sphere_closest_hit on the flat tile",
                    ST.closest_hit_spheres(table, nc, *ch_args),
                    CS.flat_closest_hit(ch_a[0], *ch_args))
        check_equal("sphere_any_hit on the flat tile",
                    ST.occludes_spheres(table, nc, *ah_args), CS.flat_occludes(ch_a[0], *ah_args))
        ch_rec, ah_rec = recs["flat_sphere_closest_hit"], recs["flat_sphere_any_hit"]
        ch_rec.update(k1_ms=k1, k1_device_ms=k1_dev)
        ah_rec.update(k2_ms=k2, k2_device_ms=k2_dev)
        log(f"[timing] {label} main-path tile, the same rays (ms, device ms): "
            f"sphere_closest_hit (K1) {k1:.4f}, {k1_dev:.4f} against K5's "
            f"{ch_rec['ms']:.4f}, {ch_rec['device_ms']:.4f}; sphere_any_hit (K2) "
            f"{k2:.4f}, {k2_dev:.4f} against K5's {ah_rec['ms']:.4f}, "
            f"{ah_rec['device_ms']:.4f}")
    return recs


def gpu_vs_cpu(device, route="walk"):
    """Phase 7: the whole path with kernels vs with the plain versions on the
    mixed scene, 48x32, 2 spp, 3 bounces.  route "walk": 40 spheres and the
    128-triangle grid, K1-K4; "flat": the same on the flat route, K5, K3,
    K4; "bvh": 8 spheres and the grid built with bvh_threshold=64, so the
    card runs K6 and the CPU its plain version, one function: every K6 call
    of the card's render is held bit for bit against the plain version on
    its inputs; "env": scenes/env_demo.yml with environment NEE (no
    kernel: the HDRI tables, sample_env and the lookups on the card against
    the CPU).  The images must agree to relative MSE < 1e-4 (the eager
    shading between the queries runs PyTorch's CUDA and CPU operators, whose
    transcendentals and reductions round differently).  Then phase 8 (c):
    loss_and_grad of one 48x32 wave (sample 0, against a zero target) on
    the card and on the CPU, every gradient field finite and equal to
    GRAD_RTOL / GRAD_ATOL (grads_agree); the card's launches of that
    gradient are logged, not counted with the main paths'."""
    import numpy as np

    from paths_tpu_torch import camera as C
    from paths_tpu_torch import sky as SK
    from paths_tpu_torch.render import render_image
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_mixed_scene
    from paths_tpu_torch.scene.yaml_loader import load_scene_description

    PK = _kernel_modules()[3]
    imgs, held, built = [], [0], []
    k6 = PK.closest_hit_packet

    def k6_held(pbvh, *args):
        got = k6(pbvh, *args)
        check_equal("packet_closest_hit in the bvh route's render", got,
                    PK.closest_hit_packet_plain(pbvh, *args))
        held[0] += 1
        return got

    with tempfile.TemporaryDirectory() as tmp:
        for dev in (device, "cpu"):
            if route == "flat":
                with flat_route():
                    static, scene, cam = build_scene(
                        generate_mixed_scene(tmp, n_spheres=40), device=dev)
            elif route == "bvh":
                static, scene, cam = build_scene(
                    generate_mixed_scene(tmp, n_spheres=8), device=dev, bvh_threshold=64)
            elif route == "env":
                static, scene, cam = build_scene(load_scene_description(ENV_DEMO),
                                                 device=dev)
                static = dataclasses.replace(static, env_nee=True)
            else:
                static, scene, cam = build_scene(
                    generate_mixed_scene(tmp, n_spheres=40), device=dev)
            if route == "bvh":
                assert static.use_bvh and static.tri_chunks == 0
            elif route == "env":
                assert static.sky_type == SK.HDRI and static.env_nee
            else:
                assert static.sph_chunks > 0 and static.tri_chunks > 0
                assert static.sph_flat == (route == "flat")
            static = dataclasses.replace(static, max_bounces=3)
            built.append((static, scene, C.resize(cam, 48, 32)))
            reset_launch_counts()
            if route == "bvh" and dev == device:
                PK.closest_hit_packet = k6_held
            try:
                imgs.append(render_image(static, scene, C.resize(cam, 48, 32), 48, 32,
                                         spp=2, seed=0))
            finally:
                PK.closest_hit_packet = k6
            if dev == device and route == "bvh" and launch_counts()["packet_closest_hit"] == 0:
                raise AssertionError("GPU vs CPU (bvh route): K6 was not launched")
    rel = rel_mse(*imgs)
    if not rel < 1e-4:
        raise AssertionError(f"GPU vs CPU ({route} route) relative MSE {rel:.3e} >= 1e-4")
    differ = int((np.abs(imgs[0] - imgs[1]).max(-1) > 0).sum())
    extra = (f"; each of the card's {held[0]} K6 queries equal to the plain version "
             "on its inputs" if route == "bvh" else "")
    scene_name = "env_demo --env-nee" if route == "env" else "mixed scene"
    log(f"[gpu-vs-cpu] {scene_name} 48x32 2 spp, {route} route: relative MSE "
        f"{rel:.3e} (< 1e-4), {differ} of {48 * 32} pixels differ{extra}")

    import torch

    from paths_tpu_torch import grad as G

    grads = []
    for dev, (static, scene, cam) in zip((device, "cpu"), built):
        lanes = wave_lanes(48, 32, dev)
        target = torch.zeros((48 * 32, 3), device=dev)
        reset_launch_counts()
        grads.append(G.loss_and_grad(static, scene, cam, *lanes, 0, target))
        if dev == device:
            counts = launch_counts()
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = grads
    worst, nonzero = grads_agree(f"{scene_name}, {route} route", g_gpu, g_cpu)
    log(f"[gpu-vs-cpu] {scene_name} 48x32 1 spp, {route} route: loss_and_grad on the "
        f"card {float(loss_gpu):.6e}, on the CPU {float(loss_cpu):.6e}; every field of "
        f"PARAM_FIELDS and SKY_PARAM_FIELDS finite and equal to rtol {GRAD_RTOL}, atol "
        f"{GRAD_ATOL} ({nonzero} values not zero; largest difference {worst:.3e}); "
        f"launches {counts}")


# ---------------------------------------------------------------- phases 8/9

# Phase 8 (a): the chosen entity's albedo is perturbed by this much per
# channel (towards the middle of [0, 1]) in the target, and recovered by
# GRAD_STEPS steps of gradient descent; the loss must fall at every step and
# end below GRAD_LOSS_END of its start.  The first step is taken at
# GRAD_LR0; the learning rate of the others is GRAD_RATE over the loss's
# curvature along that first step (a secant: (s . y) / (s . s) for the step
# s and the change of gradient y), so that each removes about GRAD_RATE of
# the albedo's error.  A fixed rate would not do: 1 spp frames at 90x60 and
# 180x120 on the CPU gave curvatures 1.22 and 0.35 (a few bright lanes
# carry the loss; scripts/grad_cpu_study.py), and a rate near 1 / curvature
# drives the loss to its rounding floor in a step or two, where it need not
# fall any more.
GRAD_DELTA = 0.3
GRAD_STEPS = 10
GRAD_LR0 = 0.1
GRAD_RATE = 0.3
GRAD_LOSS_END = 0.1
# A gradient tile may take at most this share of the card's free memory,
# as estimated from a probe tile of GRAD_PROBE lanes: the frame is split
# into tiles when the whole would not fit.
GRAD_MEMORY_SHARE = 0.5
GRAD_PROBE = 16384
# Phase 8 (b): central-difference step (a relative scale of tri_vc0) and
# tolerance; phase 8 (c): the reference's bound between its backends
# (tests/test_grad.py test_forced_pallas_grads_match_xla).
FD_EPS = 1e-2
FD_RTOL = 2e-2
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def wave_lanes(width, height, device, n=None):
    """(px, py, pixel_id, sample_id) of the first n lanes (every pixel when
    None) in the renderer's tiled pixel order, sample 0 each."""
    import torch

    from paths_tpu_torch.render import tiled_pixel_order

    pid = torch.as_tensor(tiled_pixel_order(width, height)[:n].astype("int64"),
                          device=device)
    return ((pid % width).to(torch.int32), (pid // width).to(torch.int32), pid,
            torch.zeros_like(pid))


def albedo_entity(static, scene, cam, lanes):
    """The entity seen by the most primary rays among those that are not
    lights and whose material reads its albedo (Lambertian, gloss,
    Cook-Torrance): (entity, its lanes, its material type)."""
    import numpy as np
    import torch

    from paths_tpu_torch import integrator as I
    from paths_tpu_torch import materials as M
    from paths_tpu_torch.render import gen_camera_rays

    o, d, _ = gen_camera_rays(cam, *lanes, 0)
    none = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    found, _, _, ent, _ = I.intersect_brief(static, scene, o, d, none, none)
    counts = torch.bincount(ent[found].long(), minlength=static.n_entities).cpu().numpy()
    mtype = scene.mat_mtype.cpu().numpy()
    reads = (np.isin(mtype, (M.LAMBERTIAN, M.GLOSS, M.COOK_TORRANCE))
             & ~scene.ent_is_light.cpu().numpy() & ~scene.mat_albedo_vertex.cpu().numpy())
    e = int(np.argmax(np.where(reads, counts, -1)))
    return e, int(counts[e]), int(mtype[e])


def grad_tiles(static, scene, cam, lanes, target, tile, entity, timed=False):
    """The l2 loss of the whole wave and its gradient with respect to
    mat_albedo[entity], tile by tile: loss_and_grad on each tile of `tile`
    lanes, each weighted by n_tile / N (the loss is a mean).  With timed,
    the forward and the backward of each tile are run and timed apart (on
    leaf copies of the parameters, as loss_and_grad runs them): returns
    (loss, grad, forward s, backward s); else (loss, grad)."""
    import torch

    from paths_tpu_torch import grad as G

    device = cam.location.device
    n = lanes[0].shape[0]
    loss, grad, t_fwd, t_bwd = 0.0, 0.0, 0.0, 0.0
    for a in range(0, n, tile):
        sub = [x[a:a + tile] for x in lanes]
        w = sub[0].shape[0] / n
        if timed:
            params = G.leaf_params(G.get_params(scene))
            _sync(device)
            t = time.perf_counter()
            l_t = G.l2_loss(static, params, scene, cam, *sub, 0, target[a:a + tile])
            _sync(device)
            t_fwd += time.perf_counter() - t
            t = time.perf_counter()
            leaves = ([params[f] for f in G.PARAM_FIELDS]
                      + [params["sky"][f] for f in G.SKY_PARAM_FIELDS])
            grads = torch.autograd.grad(l_t, leaves, allow_unused=True)
            _sync(device)
            t_bwd += time.perf_counter() - t
            g_t = grads[G.PARAM_FIELDS.index("mat_albedo")]
        else:
            l_t, g = G.loss_and_grad(static, scene, cam, *sub, 0, target[a:a + tile])
            g_t = g["mat_albedo"]
        loss += float(l_t.detach()) * w
        grad = grad + g_t[entity].detach() * w
    return (loss, grad, t_fwd, t_bwd) if timed else (loss, grad)


def gradient_step(device, width=720, height=480, steps=GRAD_STEPS, probe=GRAD_PROBE):
    """Phase 8 (a): loss_and_grad on lit stress-500 at a full frame, one
    sample a pixel, against a target rendered with the albedo of one entity
    perturbed (the entity with the most pixels among those whose material
    reads albedo); the first step timed (forward and backward apart), its
    peak memory and kernel launches logged; `steps` steps of gradient
    descent on that albedo in all, the loss falling at every step.  Returns the
    launch counts of the timed step."""
    import numpy as np
    import torch

    from paths_tpu_torch import camera as C
    from paths_tpu_torch import grad as G
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_lit_stress_scene

    cuda = torch.device(device).type == "cuda"
    static, scene, cam = build_scene(generate_lit_stress_scene(500), device=device)
    cam = C.resize(cam, width, height)
    lanes = wave_lanes(width, height, device)
    n = lanes[0].shape[0]
    e, seen, mtype = albedo_entity(static, scene, cam, lanes)
    start = scene.mat_albedo[e].clone()
    delta = torch.where(start < 0.5, GRAD_DELTA, -GRAD_DELTA)
    goal = start + delta
    params = G.get_params(scene)
    params["mat_albedo"] = scene.mat_albedo.clone()
    params["mat_albedo"][e] = goal
    with torch.no_grad():
        target = G.render_with_params(static, scene, params, cam, *lanes, 0)
    log(f"[grad] lit stress-500 {width}x{height}, 1 spp, {n} lanes, "
        f"{static.max_bounces + 1} bounce iterations at most: entity {e} "
        f"(material type {mtype}, {seen} primary-ray lanes, {100 * seen / n:.1f}% "
        f"of the frame); albedo {start.tolist()} -> target {goal.tolist()}")

    # The tile: a probe step's peak memory per lane against the free memory.
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grad_tiles(static, scene, cam, [x[:probe] for x in lanes], target[:probe],
                   probe, e)
        per_lane = (torch.cuda.max_memory_allocated() - base) / probe
        free = torch.cuda.mem_get_info()[0]
        tile = min(n, int(GRAD_MEMORY_SHARE * free // per_lane) // 1024 * 1024)
        log(f"[grad] probe of {probe} lanes: {per_lane / 1024:.1f} KiB a lane at peak; "
            f"{free / 2**30:.1f} GiB free, so tiles of {tile} lanes: "
            f"{-(-n // tile)} tile(s), each tile's gradient weighted by n_tile / {n}")
        torch.cuda.reset_peak_memory_stats()
    else:
        tile = n

    reset_launch_counts()
    loss0, g0, t_fwd, t_bwd = grad_tiles(static, scene, cam, lanes, target, tile, e,
                                         timed=True)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    log(f"[grad] loss_and_grad, lit stress-500, {n} lanes in {-(-n // tile)} tile(s): "
        f"forward {t_fwd:.2f} s, backward {t_bwd:.2f} s ({t_bwd / t_fwd:.2f}x the "
        f"forward); peak memory {peak:.2f} GiB (torch.cuda.max_memory_allocated); "
        f"kernel launches of the step {counts}")
    for k in ("sphere_closest_hit", "sphere_any_hit"):
        if counts[k] <= 0:
            raise AssertionError(f"{k} was not launched in the gradient step")
    if not (np.isfinite(loss0) and bool(torch.isfinite(g0).all())):
        raise AssertionError(f"non-finite loss or gradient: {loss0}, {g0.tolist()}")

    losses = []
    albedo, lr, first = start.clone(), GRAD_LR0, None
    t = time.perf_counter()
    for i in range(steps):
        params = G.get_params(scene)
        params["mat_albedo"] = scene.mat_albedo.clone()
        params["mat_albedo"][e] = albedo
        # The first step is the timed one's (the same albedo).
        loss, g = (loss0, g0) if i == 0 else grad_tiles(
            static, G.with_params(scene, params), cam, lanes, target, tile, e)
        losses.append(loss)
        if i == 1:  # the curvature along the first step sets the rate
            s_, y_ = albedo - first[0], g - first[1]
            curvature = float((s_ * y_).sum() / (s_ * s_).sum())
            if not curvature > 0:
                raise AssertionError(f"the loss is not convex along the first step "
                                     f"(curvature {curvature})")
            lr = GRAD_RATE / curvature
        first = first or (albedo, g)
        albedo = albedo - lr * g
    params["mat_albedo"][e] = albedo
    with torch.no_grad():
        losses.append(float(G.l2_loss(static, params, scene, cam, *lanes, 0, target)))
    dt = time.perf_counter() - t
    log(f"[grad] {steps} SGD steps on albedo[{e}], learning rate {GRAD_LR0} for the "
        f"first, then {lr:.4f} (= {GRAD_RATE} / the curvature {curvature:.4f} along "
        "the first step): loss "
        + ", ".join(f"{v:.4e}" for v in losses)
        + f" ({losses[-1] / losses[0]:.2e} of the start); albedo {albedo.tolist()} "
        f"(target {goal.tolist()}); {dt:.1f} s")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"the loss did not fall at every step: {losses}")
    if not losses[-1] < GRAD_LOSS_END * losses[0]:
        raise AssertionError(f"the loss ended at {losses[-1] / losses[0]:.3f} of its "
                             f"start, not below {GRAD_LOSS_END}")
    return counts


def vertex_colour_fd(device, width=720, height=480, lanes_n=SUBSET):
    """Phase 8 (b): on doom_standin's kernel route (K3, K4), pixel_gradient
    with respect to tri_vc0 on one tile, its directional derivative
    sum(g * tri_vc0) held against a central difference of the mean radiance
    with tri_vc0 scaled by 1 +- FD_EPS (the same seed).  Returns the launch
    counts of the gradient."""
    import torch

    from paths_tpu_torch import camera as C
    from paths_tpu_torch import grad as G
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.yaml_loader import load_scene_description

    static, scene, cam = build_scene(load_scene_description(DOOM), device=device)
    if not static.tri_chunks:
        raise AssertionError("doom_standin did not take the kernel route")
    cam = C.resize(cam, width, height)
    lanes = wave_lanes(width, height, device, lanes_n)
    reset_launch_counts()
    t = time.perf_counter()
    g = G.pixel_gradient(static, scene, cam, *lanes, 0, "tri_vc0")
    _sync(device)
    dt = time.perf_counter() - t
    counts = launch_counts()
    for k in ("tri_closest_hit", "tri_any_hit"):
        if counts[k] <= 0:
            raise AssertionError(f"{k} was not launched in doom's gradient")
    directional = float((g * scene.tri_vc0).sum())

    def mean_radiance(scale):
        params = G.get_params(scene)
        params["tri_vc0"] = params["tri_vc0"] * scale
        with torch.no_grad():
            return float(G.render_with_params(static, scene, params, cam, *lanes, 0).mean())

    fd = (mean_radiance(1 + FD_EPS) - mean_radiance(1 - FD_EPS)) / (2 * FD_EPS)
    rel = abs(directional - fd) / abs(fd)
    log(f"[grad] doom_standin kernel route, {lanes[0].shape[0]} lanes: pixel_gradient "
        f"wrt tri_vc0 in {dt:.2f} s ({int((g != 0).any(1).sum())} of {g.shape[0]} "
        f"triangles reached); sum(g * tri_vc0) {directional:.6e} against the central "
        f"difference {fd:.6e} (eps {FD_EPS}): relative difference {rel:.2e} "
        f"(< {FD_RTOL}); launches {counts}")
    if not (bool(torch.isfinite(g).all()) and directional > 0 and rel < FD_RTOL):
        raise AssertionError(f"doom tri_vc0 gradient: {directional} against {fd}")
    return counts


def grads_agree(label, got, want):
    """Phase 8 (c): every gradient field of the card's loss_and_grad finite
    and equal to the CPU's to GRAD_RTOL / GRAD_ATOL.  Returns (largest
    absolute difference, values compared that are not zero)."""
    import numpy as np

    from paths_tpu_torch import grad as G

    worst, nonzero = 0.0, 0
    for name in G.PARAM_FIELDS + G.SKY_PARAM_FIELDS:
        a = (got["sky"] if name in G.SKY_PARAM_FIELDS else got)[name].cpu().numpy()
        b = (want["sky"] if name in G.SKY_PARAM_FIELDS else want)[name].cpu().numpy()
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            raise AssertionError(f"{label}: non-finite gradient in {name}")
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{label}: card vs CPU gradient of {name}")
        worst = max(worst, float(np.abs(a - b).max(initial=0.0)))
        nonzero += int((b != 0).sum())
    return worst, nonzero


def resume_and_progressive(device, width=720, height=480, spp=8, pumps=20):
    """Phase 9: stress-500 rendered whole at `spp` and again as spp/2,
    checkpointed to a file, loaded and resumed to spp: bit for bit equal
    (batches of spp/2 both ways).  Then `pumps` pumps of ProgressiveRenderer
    (a preview wave, then full waves of one sample), the camera moved while
    a wave is in flight halfway, that stale wave dropped; frames per
    second.  validate_radiance on every image.  Returns the launch counts
    of the two paths."""
    import numpy as np
    import torch

    from paths_tpu_torch import camera as C
    from paths_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from paths_tpu_torch.debug import validate_radiance
    from paths_tpu_torch.progressive import ProgressiveRenderer
    from paths_tpu_torch.render import Estimator, render_image
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_stress_scene

    static, scene, cam = build_scene(generate_stress_scene(500), device=device)
    cam = C.resize(cam, width, height)
    half = spp // 2

    def resumed():
        t = time.perf_counter()
        whole = render_image(static, scene, cam, width, height, spp=spp, seed=0,
                             sample_batch=half)
        t_whole = time.perf_counter() - t
        est = Estimator(width, height)
        render_image(static, scene, cam, width, height, spp=half, seed=0, est=est,
                     sample_batch=half)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "ck.npz")
            save_checkpoint(path, est, half, 0)
            est2, start, seed = load_checkpoint(path)
        again = render_image(static, scene, cam, width, height, spp=spp, seed=seed,
                             est=est2, start_sample=start, sample_batch=half)
        return whole, again, t_whole

    counts, (whole, again, t_whole) = drive("stress-500 resumed render", resumed,
                                            ["sphere_closest_hit"])
    differ = int((whole != again).any(-1).sum())
    log(f"[resume] stress-500 {width}x{height}: {spp} spp whole in {t_whole:.2f} s; "
        f"{half} spp, checkpointed, loaded and resumed to {spp}: {differ} of "
        f"{width * height} pixels differ from the whole render")
    if differ:
        raise AssertionError("the resumed render is not bit-identical to the whole one")

    def progressive():
        r = ProgressiveRenderer(static, scene, cam, width, height)
        n_preview = len(r._prev_idx)
        t = time.perf_counter()
        for i in range(pumps):
            r.pump()
            if i == pumps // 2 - 1:
                # A wave is in flight: the move makes it stale.
                r.set_camera(cam.location.cpu().numpy() + [0.5, 0.0, 0.0],
                             cam.rot.cpu().numpy())
                moved = i
            elif i == pumps // 2 and r.estimator.count.sum() != 0:
                raise AssertionError("the stale wave was not dropped")
            elif i == pumps // 2 + 1 and r.estimator.count.sum() != n_preview:
                raise AssertionError("the new epoch's preview did not land")
        dt = time.perf_counter() - t
        want = n_preview + (pumps - moved - 3) * width * height
        if r.estimator.count.sum() != want:
            raise AssertionError(f"progressive: {r.estimator.count.sum()} samples, "
                                 f"not {want}")
        return r, dt, n_preview

    counts2, (r, dt, n_preview) = drive("stress-500 progressive", progressive,
                                        ["sphere_closest_hit"])
    log(f"[progressive] stress-500 {width}x{height}: {pumps} pumps in {dt:.2f} s, "
        f"{pumps / dt:.3f} frames per second (a preview wave of {n_preview} lanes "
        f"after each epoch reset, then full waves of {width * height} lanes, 1 "
        f"sample); the camera moved after pump {pumps // 2}, its wave in flight "
        f"dropped; epoch {r.epoch}, {r.num_rays_cast} rays since the move")
    for name, img in (("whole", whole), ("resumed", again), ("progressive", r.frame())):
        rep = validate_radiance(img.reshape(-1, 3))
        log(f"[check] {name}: {rep}")
        if not rep.ok:
            raise AssertionError(f"{name}: invalid radiance ({rep})")
    return {k: counts[k] + counts2[k] for k in counts}


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
    log(f"[main] kernel launches over the ten paths: {launches}")

    tile = where_time_goes(
        device, "sphere", "lit stress-500",
        lambda: build_scene(generate_lit_stress_scene(500), device=device))
    doom_bvh = build_scene(load_scene_description(DOOM), device=device,
                           bvh_threshold=BVH_THRESHOLD)
    tile.update(where_time_goes(
        device, "tri", "doom_standin",
        lambda: build_scene(load_scene_description(DOOM), device=device),
        bound=leaf_bound(doom_bvh[1].pbvh)))

    def flat_lit():
        with flat_route():
            return build_scene(generate_lit_stress_scene(500), device=device)

    tile.update(where_time_goes(device, "flat", "lit stress-500 flat route", flat_lit))
    tile.update(where_time_goes(device, "packet", "doom_standin BVH route",
                                lambda: doom_bvh))
    dragon_bvh = build_scene(load_scene_description(DRAGON), device=device,
                             bvh_threshold=BVH_THRESHOLD)
    dragon_tile = where_time_goes(
        device, "tri", "dragon_standin",
        lambda: build_scene(load_scene_description(DRAGON), device=device), spp=2,
        bound=leaf_bound(dragon_bvh[1].pbvh))
    dragon_tile.update(where_time_goes(device, "packet", "dragon_standin BVH route",
                                       lambda: dragon_bvh, spp=2))
    env_tile = where_time_goes(device, "hdri", "HDRI lit stress-500 env NEE",
                               lambda: hdri_lit_scene(device))
    for route in ("walk", "flat", "bvh", "env"):
        gpu_vs_cpu(device, route)

    # Phases 8 and 9: the gradient, resume and progressive paths, each read
    # with the counts set to 0 just before it; their launches join the ten
    # paths' (phase 8 (c)'s, a comparison with the CPU, do not).
    t = time.time()
    torch.cuda.empty_cache()
    for counts in (gradient_step(device), vertex_colour_fd(device),
                   resume_and_progressive(device)):
        for k, v in counts.items():
            launches[k] += v
    log(f"[main] phases 8 and 9 in {time.time() - t:.1f} s; kernel launches over "
        f"every path: {launches}")

    # ms, plain_ms and bound_ms are at the main path's shape (one tile of
    # bounce and shadow rays) for K1-K6 (dragon_tile_*: K3, K4 and K6 on
    # dragon's tile; env_tile_*: K1 and K2 on configuration (b)'s tile, K2
    # on its environment NEE query); K7-K9 are off the main path, so
    # theirs are at the doom subset (triangles) and the incoherent stress-500
    # frame (spheres).  frame_* at a full incoherent frame (spheres) and
    # doom_*/dragon_* at the 65,536-lane subsets (triangles; their frame_ms
    # at the full incoherent frame; K6's at the incoherent subset, with
    # primary_* at the primary subset and k3_* for K3 on the same rays).
    # ms is one wrapper call from an idle card, host part included (time_ms);
    # device_ms the card's own time for the same call (time_device_ms).
    recs = []
    for name in KERNELS:
        at = tile.get(name) or (mesh["doom"] if name.startswith("scan_tri")
                                else frame)[name]
        base = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")
        r = dict(name=name, route="cuda", **KERNELS[name], launches=launches[name],
                 **{k: at[k] for k in base}, library_ms=None)
        if name in tile:
            r.update({f"tile_{k}": v for k, v in tile[name].items() if k not in base})
        if name in frame:
            r["max_abs_err"] = max(r["max_abs_err"], frame[name]["max_abs_err"])
            r.update(frame_ms=frame[name]["ms"], frame_device_ms=frame[name]["device_ms"],
                     frame_plain_ms=frame[name]["plain_ms"],
                     frame_bound_ms=frame[name]["bound_ms"])
            r.update({f"frame_{k}": v for k, v in frame[name].items() if k not in base})
        for prefix, at_tile in (("dragon_tile", dragon_tile), ("env_tile", env_tile)):
            if name in at_tile:
                r["max_abs_err"] = max(r["max_abs_err"], at_tile[name]["max_abs_err"])
                r.update({f"{prefix}_{k}": at_tile[name][k]
                          for k in ("ms", "device_ms", "plain_ms", "bound_ms")})
        for m, rec in mesh.items():
            if name in rec:
                r["max_abs_err"] = max(r["max_abs_err"], rec[name]["max_abs_err"])
                r.update({f"{m}_{k}": v for k, v in rec[name].items()
                          if k != "max_abs_err"})
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
