#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paths_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero before the last line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels (csrc/sphere_traverse.cu, csrc/tri_traverse.cu,
     csrc/flat_spheres.cu, csrc/packet_bvh.cu, csrc/lane_rng.cu; nvcc with
     ptxas -v, whose registers, stack frame, spills and shared memory are
     printed per kernel), the C++ BVH builder (csrc/bvh_builder.cc, g++),
     the C++ mesh parsers (csrc/mesh_io.cc) and the C++ CPU tracer
     (csrc/cpu_tracer.cc), all started together, timed;
  2b. the mesh parsers: doom_standin's and dragon_standin's PLYs through the
     loaders' C++ parser (the default) and their pure-Python path, in turns,
     each call's seconds printed; vertices and faces equal bit for bit,
     uchar colours within one ulp in f64 and equal in f32;
  2c. the lane RNG (csrc/lane_rng.cu): a shading draw with a per-lane and
     with a scalar bounce, and a camera sample, held bit for bit against
     the plain functions (the eager hash and CMJ) on the same card tensors
     and timed as in 4, beside the byte bound (28, 20 and 32 B a lane over
     3.35 TB/s), on a main-path tile (65,536 lanes) and a 720x480 frame
     (345,600);
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
     and of incoherent rays, and timed and bounded on 65,536 of those lanes
     -- every tenth-or-so primary ray and the first 32,768 incoherent rays;
     there they are held equal to their plain versions (flat brute force,
     timed once) on every fourth lane (16,384: both kinds of ray), and on
     all 65,536 every lane the any-hit flags must have an occluder before
     its t_max (the plain row test's nearest, which bounds the any-hit);
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
     leaves): timed and bounded on 65,536 primary rays and on 65,536
     incoherent rays (t_init 0 where t_max is 0) and held equal to its plain
     version on every fourth of them, on both full frames and on 4,096
     adversarial lanes (as 3f's, with origins on planes of K6's tree and
     t_init at K6's own exact hit distances), timed on the subsets and
     frames, with K3 timed on the same rays beside it.  Every
     triangle kernel is bounded on the BVH's leaves of at most 8 triangles,
     the finest division of the same rows: the needed pairs (the 8 slots of
     each leaf a lane enters before its answer) and the needed bytes (those
     leaves' rows and the compact nodes a lane enters, read once);
  5. main path: each path driven with the launch counts set to 0 just before
     it and read just after, both lane RNG kernels launched on each: the CLI renders the 500-sphere stress scene at
     720x480, 8 spp (K1); the lit stress scene renders at 720x480, 4 spp
     (K1, K2); the CLI renders scenes/doom_standin.yml at 720x480, 4 spp and
     scenes/dragon_standin.yml at 720x480, 2 spp (K3, K4), their meshes
     parsed by the C++ parser (the CLI's first line gives the scene build's
     seconds); then, with
     PATHS_TPU_SPH_FLAT=1, the CLI on stress-500 at 720x480, 8 spp (K5
     closest-hit, and no K1/K2) and the lit stress scene at 720x480, 4 spp
     (both K5 forms), each image held to its walk-route counterpart (same
     seed) at relative MSE < 1e-4; then doom_standin (4 spp) and
     dragon_standin (2 spp) at 720x480 on the BVH route
     (build_scene(..., bvh_threshold=32768), render_image): K6 launched,
     K3/K4 not, each image compared with its kernel-route counterpart (same
     seed; relative MSE below BVH_VS_KERNEL_REL_MSE); then the HDRI sky
     with environment NEE: (a) the CLI on scenes/env_demo.yml --env-nee at
     720x480, 4 spp (three small spheres and the ground: no traversal
     kernel may launch) and (b) the lit stress scene under scenes/assets/sunrise.hdr
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
     in flight and that wave dropped; validate_radiance on every image;
  10. data parallel (paths_tpu_torch.dist) on ranks sharing the card over
     gloo: (a) two ranks render lit stress-500 (4 spp; K1, K2) and
     doom_standin on the kernel route (4 spp; K3, K4) at 720x480 with
     render_image(mesh=...), each image equal bit for bit to phase 5's
     single-process image of the same seed, each rank's launches printed;
     (b) one sharded_train_step on 65,536 lanes of lit stress-500 (zero
     target), the loss within rtol 1e-5 and the parameters within rtol
     1e-4, atol 1e-6 of the single process's loss_and_grad; (c) a finding,
     not a gate: the CLI on stress-500 at 720x480, 8 spp with --dp 1, 2, 4,
     4, 2, 1, each a process of its own: pixel-samples/s, the host's
     os.cpu_count() and the card's busy share (nvidia-smi utilization.gpu,
     sampled every 100 ms over the render);
  11. profiles (paths_tpu_torch.profiling): (a) trace around the forward and
     the backward of one loss_and_grad of lit stress-500 at 720x480, 1 spp:
     wall, device busy, and the ten device kernels and ten host operators
     with the most own time, each part apart; (b) the CLI's --profile on
     stress-500 at 180x120: the trace file names K1's kernel;
  12. the oracle (csrc/cpu_tracer.cc): the CLI's --native-cpu --threads
     os.cpu_count() on stress-500 (8 spp), doom_standin (4) and
     dragon_standin (2) at 720x480, pixel-samples/s; then the card's renders
     of stress-500 and doom_standin at 48x32, 48 spp against the tracer at
     192 spp, channel means and 8x4 tile means within
     tests/test_torch_oracle.py's bounds.
  After phase 7, environment NEE over a triangle table: doom_standin (kernel
  route) under scenes/assets/sunrise.hdr with env NEE at 16x12, 2 spp, 3
  bounces on the card and on the CPU, every environment K4 query (t_max BIG,
  excl_ent -1) of the card's render held bit for bit against its plain
  version, the images within relative MSE 1e-4.
Then a JSON line of per-kernel results (launches summed over the paths of
phases 5, 8 (a, b), 9 and 10 (a, b); ms, device_ms, plain_ms and bound_ms at the main
path's tile for K1-K6 and the lane RNG, env_tile_* at configuration (b)'s for K1/K2; at the
doom subset for K7 and K9's triangle form and
at the incoherent stress-500 frame for K8 and K9's sphere form; frame_* and
doom_*/dragon_* at the shapes of 2c, 4, 4b, 4d and 4e; the lane RNG's
scalar_tile_*/scalar_frame_* with a scalar bounce), the nvidia-smi name/power
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
import typing

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
SUBSET = 65536  # triangle lanes timed and bounded (phases 3b-3e)
# ... and held against the plain triangle versions on every PLAIN_EVERY-th
# of them (16,384 lanes: the brute force is most of those phases' time).
PLAIN_EVERY = 4
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
    # No TPU kernel: the reference computes these words with elementwise XLA
    # operations, which its compiler fuses.
    "rng_uniform": dict(
        replaces="paths_tpu/sampling/hashing.py:55 (no kernel)",
        source="paths_tpu_torch/csrc/lane_rng.cu"),
    "rng_camera": dict(
        replaces="paths_tpu/sampling/cmj.py:50 (no kernel)",
        source="paths_tpu_torch/csrc/lane_rng.cu"),
}
# The lane RNG's kernels: every path that renders on the card draws.
RNG_KERNELS = ["rng_uniform", "rng_camera"]
TRAVERSAL_KERNELS = [k for k in KERNELS if k not in RNG_KERNELS]
# Bytes a lane of the lane RNG's kernels moves: int64 pixel and sample ids
# in, and an int64 bounce where it is per lane, an f32 out (a draw); the
# two ids in and four f32 out (a camera sample).
RNG_LANE_BYTES = {"lanes": 28, "scalar": 20, "camera": 32}
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
    from paths_tpu_torch.ops import lane_rng as RNG
    from paths_tpu_torch.ops import packet_traverse as PK
    from paths_tpu_torch.ops import sphere_traverse as ST
    from paths_tpu_torch.ops import tri_traverse as TT

    return ST, TT, CS, PK, RNG


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
    """Build the five CUDA libraries, csrc/bvh_builder.cc, csrc/mesh_io.cc
    and csrc/cpu_tracer.cc at once (one compiler process each), then bind
    them; returns {source: seconds}."""
    from paths_tpu_torch import native

    return native.build_all(verbose=True)


# ---------------------------------------------------------------- phase 2b

def parse_meshes():
    """Phase 2b: both standins' PLYs through the loaders' two parsers, the
    C++ parser (the default) and the pure-Python path, in turns (C++,
    Python, Python, C++), each call timed on the host's clock.  Vertices
    and faces must be equal bit for bit, uchar colours within one ulp in f64
    and equal in f32 (the C++ parser scales by 1/255, the Python path
    divides by 255)."""
    import numpy as np

    from paths_tpu_torch.scene.ply_loader import load_ply_file

    for name in ("doom_standin", "dragon_standin"):
        path = os.path.join(REPO, "scenes", "assets", f"{name}.ply")
        secs = {True: [], False: []}
        got = {}
        for use_native in (True, False, False, True):
            t = time.perf_counter()
            got[use_native] = load_ply_file(path, use_native=use_native)
            secs[use_native].append(time.perf_counter() - t)
        c, p = got[True], got[False]
        for f in ("vertices", "faces"):
            a, b = getattr(c, f), getattr(p, f)
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise AssertionError(f"{name}: the two parsers' {f} differ")
        if (c.vertex_colours is None) != (p.vertex_colours is None):
            raise AssertionError(f"{name}: one parser found vertex colours")
        cols = ""
        if c.vertex_colours is not None:
            np.testing.assert_array_max_ulp(c.vertex_colours, p.vertex_colours, maxulp=1)
            if not np.array_equal(c.vertex_colours.astype(np.float32),
                                  p.vertex_colours.astype(np.float32)):
                raise AssertionError(f"{name}: the two parsers' f32 colours differ")
            cols = (f"; colours within 1 ulp in f64 ("
                    f"{int((c.vertex_colours != p.vertex_colours).sum())} of "
                    f"{c.vertex_colours.size} values apart) and equal in f32")
        cc, pp = secs[True], secs[False]
        log(f"[parse] {name}.ply, {c.vertices.shape[0]} vertices, {c.faces.shape[0]} "
            f"triangles: C++ parser {cc[0]:.4f}, {cc[1]:.4f} s; pure Python "
            f"{pp[0]:.4f}, {pp[1]:.4f} s ({min(pp) / min(cc):.1f}x); vertices and faces "
            f"bit for bit{cols}")


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


def lane_rng_phase(device, width=720, height=480, seed=7300000001):
    """Phase 2c: the lane RNG's kernels held bit for bit against the plain
    functions (the eager hash and CMJ) on the same card tensors, and timed
    as 3/4 time the traversal kernels, on a main-path tile (the first 65,536
    lanes of the tiled pixel order) and on a whole frame (345,600 lanes):
    a draw with a per-lane int64 bounce and with a scalar bounce, and a
    camera sample; sample ids 0-31 (both sides of a 4x4 pattern's batch),
    bounces 0-10.  Returns {kernel: record}: the tile's numbers (a draw's
    with the per-lane bounce) under the names of the traversal kernels'
    records, the frame's and the scalar bounce's prefixed."""
    import numpy as np
    import torch

    from paths_tpu_torch import render as R

    RNG = _kernel_modules()[4]
    rng = np.random.default_rng(seed)
    cam = (R.PAT_M, R.PAT_N, R._SQUARE_TAG, R._DISK_TAG)
    recs = {k: {"bound_by": "bytes", "max_abs_err": 0.0} for k in RNG_KERNELS}
    for at, n in (("tile", SUBSET), ("frame", None)):
        _, _, pid, _ = wave_lanes(width, height, device, n)
        lanes = pid.shape[0]
        sid = torch.as_tensor(rng.integers(0, 32, lanes), device=device)
        bounce = torch.as_tensor(rng.integers(0, 11, lanes), device=device)
        cases = (("rng_uniform", "lanes", RNG.shading_uniform, RNG.shading_uniform_plain,
                  (seed, pid, sid, bounce, 6)),
                 ("rng_uniform", "scalar", RNG.shading_uniform, RNG.shading_uniform_plain,
                  (seed, pid, sid, 3, 6)),
                 ("rng_camera", "camera", RNG.camera_cmj, RNG.camera_cmj_plain,
                  (seed, pid, sid, *cam)))
        for name, case, kernel, plain, args in cases:
            def bits(f, args=args):
                out = f(*args)
                out = (*out[0], *out[1]) if isinstance(out, tuple) else (out,)
                return tuple(x.view(torch.int32) for x in out)

            check_equal(f"{name} ({case}, {lanes} lanes)", bits(kernel), bits(plain))
            row = dict(ms=time_ms(lambda: kernel(*args)),
                       device_ms=time_device_ms(lambda: kernel(*args)),
                       plain_ms=time_ms(lambda: plain(*args)),
                       bound_ms=RNG_LANE_BYTES[case] * lanes / HBM_BYTES_PER_S * 1e3)
            log(f"[rng] {name} ({case}) == plain on {lanes} lanes; kernel "
                f"{row['ms']:.4f} ms a call, {row['device_ms'] * 1e3:.3f} us device "
                f"({100 * row['bound_ms'] / row['device_ms']:.1f}% of its byte bound "
                f"{row['bound_ms'] * 1e3:.3f} us, {RNG_LANE_BYTES[case]} B a lane); "
                f"the plain version {row['plain_ms']:.4f} ms a call")
            prefix = "" if (at, case) in (("tile", "lanes"), ("tile", "camera")) else (
                f"{at}_" if case != "scalar" else f"scalar_{at}_")
            recs[name].update({prefix + k: v for k, v in row.items()})
            if not prefix:
                recs[name]["plain_lanes"] = lanes
    return recs


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
    ST, TT, CS, _, _ = _kernel_modules()
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


def every(args, step):
    """Every step-th lane of each tensor in args."""
    return tuple(a[::step].contiguous() for a in args)


def measure(kind, label, table, nc, ch_args, ah_args, timer, bound, plain_reps=True,
            plain_every=1):
    """Hold the closest-hit and any-hit kernels of one family (a key of
    _families()) against their plain versions on these inputs (equal outputs;
    on every plain_every-th lane), time both, and bound both by the work
    these inputs need.  ch_args = (o, d, excl, t_init); ah_args = (o, d,
    excl, excl_ent, t_max).  The plain versions are timed like the kernels
    (plain_reps) or, for the triangle brute force, once.  The bound belongs
    to the function, not to the table the kernel reads: bound(o, d,
    t_answer) -> (pairs, table_bytes) counts it on the finest division of
    the same rows (sphere_leaf_bound, leaf_bound); the any-hit's answer is
    a lane's nearest occluder where the kernel flags it (which must exist)
    and its t_max elsewhere.  Returns {name:
    dict(max_abs_err, ms, plain_ms, plain_lanes, bound_ms, bound_by)}."""
    import torch

    rows, (ch_name, ch, ch_plain), (ah_name, ah, ah_plain) = _families()[kind]
    peak_ops, peak_txt = fp32_peak(ch_args[0].device)
    lane_in = 24 + 4 + 4  # o, d, excl, seed
    held = lambda args: every(args, plain_every)
    n_plain = held(ch_args)[0].shape[0]

    t_hit = ch(table, nc, *ch_args)
    plain_ch_ms, want = time_once(lambda: ch_plain(table, nc, *held(ch_args)))
    err_ch = check_equal(f"{ch_name} {label}", held(t_hit), want)
    occ = ah(table, nc, *ah_args)
    plain_ah_ms, want = time_once(lambda: ah_plain(table, nc, *held(ah_args)))
    err_ah = check_equal(f"{ah_name} {label}", held((occ,)), want)
    # The any-hit's answer: a flagged lane's nearest occluder (searched on
    # those lanes only: the search is a brute force), an unflagged lane's
    # t_max.
    t_max = ah_args[-1]
    flagged = torch.nonzero(occ & (t_max > 0))[:, 0]
    t_occ = torch.full_like(t_max, float("inf"))
    t_occ[flagged] = nearest_occluder(rows, table, nc, *(a[flagged] for a in ah_args))
    if not bool((t_occ[flagged] < float("inf")).all()):
        raise AssertionError(f"{ah_name} {label}: a flagged lane has no occluder "
                             "before its t_max")

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
            plain_ms = timer(lambda: plain(table, nc, *held(args)))
        pairs, table_bytes = bound(args[0], args[1], answer)
        bound_ms, bound_by = bound_record(rows, n, lane_in + extra_in + out_bytes,
                                          pairs, table_bytes, peak_ops)
        recs[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, plain_lanes=n_plain,
                          bound_ms=bound_ms, bound_by=bound_by, device_ms=device_ms)
        floor = ""
        if kind == "flat":
            n_slots = table.tris.shape[0] * 16
            floor_ms = n * n_slots * OPS_PER_MISSED_PAIR / peak_ops * 1e3
            floor = (f"; all-pairs floor {floor_ms:.4f} ms ({n} x {n_slots} "
                     f"pairs x {OPS_PER_MISSED_PAIR} FP32 operations)")
        on = "" if n_plain == n else f" on {n_plain} of the lanes, equal"
        log(f"[timing] {name}, {label}, {n} lanes: {ms:.4f} ms, device "
            f"{device_ms:.4f} ms (plain "
            f"{plain_ms:.3f} ms{on}), bound {bound_ms:.4f} ms by {bound_by} "
            f"({pairs} needed pair tests, {table_bytes} needed table bytes; FP32 "
            f"peak {peak_ops / 1e12:.2f} T op/s = {peak_txt}){floor}")
    return recs


def measure_packet(label, pbvh, args, timer, bound, plain_every=1):
    """K6 on these inputs (o, d, excl, t_init): held equal to its plain
    version (on every plain_every-th lane), the kernel timed (median of 25)
    and the plain version once, bounded by bound (leaf_bound) on every
    lane.  Returns {name: record}."""
    import torch

    PK = _kernel_modules()[3]
    peak_ops, peak_txt = fp32_peak(args[0].device)
    got = PK.closest_hit_packet(pbvh, *args)
    held = every(args, plain_every)
    plain_ms, want = time_once(lambda: PK.closest_hit_packet_plain(pbvh, *held))
    err = check_equal(f"packet_closest_hit {label}", every(got, plain_every), want)
    ms = timer(lambda: PK.closest_hit_packet(pbvh, *args))
    device_ms = time_device_ms(lambda: PK.closest_hit_packet(pbvh, *args))
    n = args[0].shape[0]
    pairs, table_bytes = bound(args[0], args[1], torch.minimum(got[0], args[-1]))
    bound_ms, bound_by = bound_record("vtri", n, 24 + 4 + 4 + 12, pairs,
                                      table_bytes, peak_ops)
    hits = int((got[0] < BIG).sum().item())
    n_plain = held[0].shape[0]
    on = "" if n_plain == n else f" on {n_plain} of the lanes"
    log(f"[timing] packet_closest_hit, {label}, {n} lanes ({hits} hits): {ms:.4f} ms, "
        f"device {device_ms:.4f} ms "
        f"(plain {plain_ms:.3f} ms{on}, equal), bound {bound_ms:.4f} ms by {bound_by} "
        f"({pairs} needed pair tests, {table_bytes} needed table bytes; FP32 peak "
        f"{peak_ops / 1e12:.2f} T op/s = {peak_txt})")
    return {"packet_closest_hit": dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                       plain_lanes=n_plain, bound_ms=bound_ms,
                                       bound_by=bound_by, device_ms=device_ms)}


def sphere_kernel_phases(device, width=720, height=480, timer=time_ms):
    """Phases 3/4 and 3c/4c: parity and timing of K1/K2, K5 (the same
    table) and K8/K9 (the same spheres packed at 16 rows per chunk) at the
    stress-500 scene and width x height lanes, and 3g: K1/K2 on adversarial
    lanes of the same table.  All three compute one function, so all three
    are bounded on the leaves of K1's tree (sphere_leaf_bound).  Returns
    per-kernel records."""
    import torch

    ST, _, CS, _, _ = _kernel_modules()
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
    ST, _, CS, _, _ = _kernel_modules()
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
    rays, and timed and bounded on SUBSET of those lanes (every (n /
    (SUBSET/2))-th primary ray and the first SUBSET/2 incoherent rays; the
    primary lanes' any-hit queries take the incoherent set's excl_ent and
    t_max), where they are held equal to their plain versions on every
    PLAIN_EVERY-th lane (both kinds of ray), and every lane the any-hit
    flags must have an occluder before its t_max.  With scan, phases
    3d/4d: the same for K7/K9 on the table repacked at 32 rows per chunk.
    3e/4e: K6
    timed and bounded on SUBSET primary rays (every (n / SUBSET)-th) and on
    the first SUBSET incoherent rays (t_init 0 where t_max is), held equal
    to its plain version on every PLAIN_EVERY-th of each, and timed and held
    on both full frames, with K3 timed on the same rays beside it and its
    answers held to K6's there (k6_vs_k3).  Every kernel is bounded on the BVH's leaves (leaf_bound): the finest
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
                      plain_reps=False, bound=bound, plain_every=PLAIN_EVERY)
        log(f"[parity] {label}: {kernels} == plain at {SUBSET // PLAIN_EVERY} of the "
            f"{SUBSET} lanes x {pt.tris.shape[0] * 8} slots ({rows}-row chunks), "
            f"an occluder for every lane the any-hit flags of all {SUBSET}")
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
    _, TT, _, PK, _ = _kernel_modules()
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
        r = measure_packet(f"{label} {which} subset", bscene.pbvh, args, timer, bound,
                           plain_every=PLAIN_EVERY)
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
    log(f"[parity] {label}: K6 == plain at {SUBSET // PLAIN_EVERY} of the {SUBSET} "
        f"primary and of the {SUBSET} incoherent lanes, on both {n}-lane frames and on "
        f"adversarial lanes "
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
    just after; each of `kernels` and of RNG_KERNELS must have launched,
    and none of `absent`.  Returns (counts, what run returned)."""
    reset_launch_counts()
    out = run()
    counts = launch_counts()
    log(f"[main] {name}: kernel launches {counts}")
    for k in [*kernels, *RNG_KERNELS]:
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
    of the ten paths and the images of lit stress-500 and doom_standin."""
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
            spp[1]), [], absent=TRAVERSAL_KERNELS),
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
        f, _, _, e, t = yield from I._intersect_brief(static, scene, o, d, excl_kind,
                                                      excl_idx)
        return f & (t < t_max) & (e != excl_ent)

    # A scene of its own: the step's graphs are captured with the patch on.
    static, scene, cam = build_scene(load_scene_description(DOOM), device=device)
    any_hit, I._occluded_query = I._occluded_query, from_closest
    try:
        mixed = render_image(static, scene, C.resize(cam, width, height), width,
                             height, spp=spp[2], seed=0)
    finally:
        I._occluded_query = any_hit
    image_parts("doom_standin: shadows from K3's closest hit vs K4's any-hit, "
                "K3 closest hits", mixed, runs[2][1])
    image_parts("doom_standin: K6 vs K3 closest hits, shadows from the closest hit",
                runs[6][1], mixed)
    total = {}
    for counts, _ in runs:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total, {"lit stress-500": runs[1][1], "doom_standin": runs[2][1]}


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


def dev_us(e):
    """A profiler row's own device time, microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)


def is_label(key, user_annotation):
    """A range the program opens (profiling.span), not an operator."""
    return user_annotation or key.startswith("paths_tpu_torch.")


class DeviceRow(typing.NamedTuple):
    """One name's device events in a profile, as a key_averages() row."""
    key: str
    count: int
    self_device_time_total: float  # microseconds


def device_rows(prof):
    """The device-side rows of a profile (kernels, copies) with device time,
    one per name, without the labelled ranges on the device's timeline (the
    operator rows on the host carry the same device time again).  Summed
    from the profiler's raw events as key_averages() sums them, without the
    event tree that key_averages() builds first: tens of seconds a
    main-path tile."""
    import torch

    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        key = torch._C._demangle(e.name())
        if is_label(key, e.is_user_annotation()):
            continue
        n, us = rows.get(key, (0, 0.0))
        rows[key] = (n + 1, us + e.duration_ns() / 1e3)
    return [DeviceRow(k, n, us) for k, (n, us) in rows.items() if us > 0]


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

    ST, TT, CS, PK, _ = _kernel_modules()
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            render_samples(static, scene, cam, px, py, pix, 1, spp, 0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        I.path_step = step
    iters = iters[0]

    rows = device_rows(prof)
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


# ---------------------------------------------------------------- phases 10-12

DP_RANKS = 2  # phase 10 (a, b): ranks sharing the one card
DP_SWEEP = (1, 2, 4, 4, 2, 1)  # phase 10 (c): --dp counts, in turns
TRAIN_LANES = 65536  # phase 10 (b)
TRAIN_LR = 0.05
ORACLE_SIZE, ORACLE_SPP = (48, 32), 48  # phase 12's parity: tests/test_torch_oracle.py's
# (build arguments, max_bounces, mean_rtol, tile_rtol) of phase 12's parity
# scenes: tests/test_torch_oracle.py's bounds (on the card each scene takes
# the CLI's route: doom the kernel route).
ORACLE_PARITY = {"stress-500": (5, 0.02, 0.06), "doom_standin": (4, 0.02, 0.12)}


def dp_rank(mesh, out_dir, width, height, spp, train_lanes):
    """Phase 10 (a, b) on one rank of `mesh`: render_image(mesh=) of lit
    stress-500 (spp[1]) and of doom_standin on the CLI's route and settings
    (spp[2]) at width x height, seed 0, then one sharded_train_step on the
    first `train_lanes` lanes of lit stress-500 at width x height, 1 spp,
    against a zero target.  Each rank prints its launches; rank 0 saves the
    images and the step's loss and parameters, every rank its launch counts,
    to out_dir."""
    import torch

    from paths_tpu_torch import camera as C
    from paths_tpu_torch import dist
    from paths_tpu_torch import grad as G
    from paths_tpu_torch.render import render_image
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_lit_stress_scene
    from paths_tpu_torch.scene.yaml_loader import load_scene_description

    out, counts = {}, {}
    lit = build_scene(generate_lit_stress_scene(500), device=mesh.device)
    doom = build_scene(load_scene_description(DOOM), device=mesh.device)
    for name, (static, scene, cam), n_spp in (("lit stress-500", lit, spp[1]),
                                              ("doom_standin", doom, spp[2])):
        reset_launch_counts()
        t = time.time()
        out[name] = render_image(static, scene, C.resize(cam, width, height), width,
                                 height, spp=n_spp, seed=0, mesh=mesh)
        counts[name] = launch_counts()
        log(f"[dp] rank {mesh.rank} of {mesh.size} on {mesh.device}: {name} "
            f"{width}x{height} {n_spp} spp in {time.time() - t:.2f} s; kernel "
            f"launches {counts[name]}")
    static, scene, cam = lit
    cam = C.resize(cam, width, height)
    lanes = wave_lanes(width, height, mesh.device, train_lanes)
    step = dist.sharded_train_step(static, mesh, lr=TRAIN_LR)
    reset_launch_counts()
    loss, params = step(G.get_params(scene), scene, cam, *lanes, 0,
                        torch.zeros((train_lanes, 3), device=mesh.device))
    counts["train step"] = launch_counts()
    log(f"[dp] rank {mesh.rank}: sharded_train_step on {train_lanes // mesh.size} of "
        f"{train_lanes} lanes, loss {float(loss):.6e}; kernel launches "
        f"{counts['train step']}")
    if mesh.rank == 0:
        out["loss"] = loss.cpu()
        out["params"] = [p.cpu() for p in G.flatten_params(params)]
        torch.save(out, os.path.join(out_dir, "rank0.pt"))
    torch.save(counts, os.path.join(out_dir, f"counts{mesh.rank}.pt"))


def dp_phase(device, images, width=720, height=480, spp=(8, 4, 4, 2),
             train_lanes=TRAIN_LANES):
    """Phase 10 (a, b): DP_RANKS ranks sharing the card over gloo run
    dp_rank; their images must equal the single-process images of phase 5
    (`images`: the same scenes, settings and seed) bit for bit, and the
    train step's loss and parameters must equal the single-process
    loss_and_grad on the same lanes at tests/test_torch_dist.py's bounds.
    Returns the ranks' launch counts, summed."""
    import numpy as np
    import torch

    from paths_tpu_torch import camera as C
    from paths_tpu_torch import dist
    from paths_tpu_torch import grad as G
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_lit_stress_scene

    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # the ranks' memory comes from the same card
    with tempfile.TemporaryDirectory() as tmp:
        t = time.time()
        dist.spawn(dp_rank, DP_RANKS, tmp, width, height, spp, train_lanes, device=device)
        dt = time.time() - t
        got = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
        counts = [torch.load(os.path.join(tmp, f"counts{r}.pt")) for r in range(DP_RANKS)]
    for name in ("lit stress-500", "doom_standin"):
        a, b = got[name], images[name]
        differ = int((a != b).any(-1).sum())
        log(f"[dp] {name} {width}x{height} on {DP_RANKS} ranks sharing the card: "
            f"{differ} of {width * height} pixels differ from the single-process "
            "image" + (" (bit for bit equal)" if differ == 0 else ""))
        if differ:
            image_parts(f"{name}: dp vs single process", a, b)
            raise AssertionError(f"{name}: the dp image is not the single-process image")
    static, scene, cam = build_scene(generate_lit_stress_scene(500), device=device)
    cam = C.resize(cam, width, height)
    lanes = wave_lanes(width, height, device, train_lanes)
    loss, grads = G.loss_and_grad(static, scene, cam, *lanes, 0,
                                  torch.zeros((train_lanes, 3), device=device))
    want = [p - TRAIN_LR * g for p, g in zip(G.flatten_params(G.get_params(scene)),
                                             G.flatten_params(grads))]
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    worst = 0.0
    for a, b in zip(got["params"], want):
        np.testing.assert_allclose(a.numpy(), b.cpu().numpy(), rtol=1e-4, atol=1e-6)
        worst = max(worst, float((a - b.cpu()).abs().max()))
    log(f"[dp] sharded_train_step on {DP_RANKS} ranks, lit stress-500, {train_lanes} "
        f"lanes: loss {float(got['loss']):.8e} against the single process's "
        f"{float(loss):.8e} (rtol 1e-5); new parameters equal p - {TRAIN_LR} g to rtol "
        f"1e-4, atol 1e-6 (largest difference {worst:.3e}); the phase took {dt:.1f} s "
        "with the ranks' start")
    total = {}
    for per_rank in counts:
        for c in per_rank.values():
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
    for k in ("sphere_closest_hit", "sphere_any_hit", "tri_closest_hit", "tri_any_hit"):
        if total[k] <= 0:
            raise AssertionError(f"{k} was not launched on the dp paths")
    return total


class UtilizationSampler:
    """nvidia-smi's utilization.gpu (the share of a sample period in which a
    kernel ran), sampled every 100 ms by a child process while the block
    runs; mean(t0, t1) averages the samples taken between two times of
    time.time()."""

    def __enter__(self):
        import threading

        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, text=True)

        def read():
            for line in self.proc.stdout:
                if line.strip().isdigit():
                    self.samples.append((time.time(), int(line)))

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        self.proc.wait(timeout=30)
        self.reader.join(timeout=30)

    def mean(self, t0, t1):
        inside = [u for t, u in self.samples if t0 <= t <= t1]
        return (statistics.mean(inside), len(inside)) if inside else (float("nan"), 0)


def dp_sweep(device, width=720, height=480, spp=8):
    """Phase 10 (c), a finding and not a gate: the CLI on stress-500 at
    width x height, spp with --dp N for N in DP_SWEEP on the one card (each
    a process of its own, in turns), its pixel-samples/s and the card's busy
    share (nvidia-smi utilization.gpu over the render's window, which ends at
    the rendered line and lasts the time it reports)."""
    import re

    import torch

    rates = {}
    with tempfile.TemporaryDirectory() as tmp, UtilizationSampler() as util:
        for n in DP_SWEEP:
            cmd = [sys.executable, "-m", "paths_tpu_torch.cli", "--dp", str(n), "--spp",
                   str(spp), "--size", f"{width}x{height}", "-o",
                   os.path.join(tmp, f"dp{n}.png")]
            if torch.device(device).type == "cpu":
                cmd.append("--cpu")
            proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            t_end, seen = None, []
            for line in proc.stdout:
                seen.append(line)
                if " rendered " in line:
                    t_end = time.time()
                    m = re.search(r"in ([0-9.]+)s \(([0-9.]+) M pixel-samples/s\)", line)
                    elapsed, rate = float(m.group(1)), float(m.group(2))
            if proc.wait() != 0 or t_end is None:
                raise AssertionError(f"--dp {n} failed:\n{''.join(seen)}")
            busy, n_samples = util.mean(t_end - elapsed, t_end)
            rates.setdefault(n, []).append(rate)
            log(f"[dp sweep] --dp {n}: stress-500 {width}x{height} {spp} spp in "
                f"{elapsed:.2f} s, {rate:.3f} M pixel-samples/s; card busy {busy:.1f}% "
                f"(nvidia-smi utilization.gpu, {n_samples} samples over the render)")
    log(f"[dp sweep] host os.cpu_count() {os.cpu_count()}; M pixel-samples/s by --dp: "
        + "; ".join(f"{n}: {', '.join(f'{r:.3f}' for r in v)}" for n, v in rates.items()))


def profile_gradient(device, logdir, width=720, height=480, top=10):
    """Phase 11 (a): profiling.trace around one loss_and_grad of lit
    stress-500 at width x height, 1 spp (phase 8 (a)'s frame, zero target),
    its forward and its backward traced apart; for each, the wall and
    device-busy times and the `top` device kernels and host operators by
    their own time."""
    import torch

    from paths_tpu_torch import camera as C
    from paths_tpu_torch import grad as G
    from paths_tpu_torch.profiling import trace
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_lit_stress_scene

    static, scene, cam = build_scene(generate_lit_stress_scene(500), device=device)
    cam = C.resize(cam, width, height)
    lanes = wave_lanes(width, height, device)
    target = torch.zeros((lanes[0].shape[0], 3), device=device)
    G.loss_and_grad(static, scene, cam, *lanes, 0, target)  # warm-up
    params = G.leaf_params(G.get_params(scene))
    _sync(device)

    for part in ("forward", "backward"):
        with trace(os.path.join(logdir, part), device=device) as prof:
            t = time.perf_counter()
            if part == "forward":
                loss = G.l2_loss(static, params, scene, cam, *lanes, 0, target)
            else:
                torch.autograd.grad(loss, G.flatten_params(params), allow_unused=True)
            _sync(device)
            wall_ms = (time.perf_counter() - t) * 1e3
        dev = device_rows(prof)
        host = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.self_cpu_time_total > 0
                and not is_label(e.key, getattr(e, "is_user_annotation", False))]
        busy_ms = sum(dev_us(e) for e in dev) / 1e3
        host_ms = sum(e.self_cpu_time_total for e in host) / 1e3
        n_kernels = sum(e.count for e in dev)
        n_ops = sum(e.count for e in host)
        log(f"[profile] loss_and_grad {part}, lit stress-500 {width}x{height} 1 spp: wall "
            f"{wall_ms:.1f} ms; device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% "
            f"of wall) in {n_kernels} device kernels; host operators' own time "
            f"{host_ms:.1f} ms in {n_ops} calls")
        for kind, sel, key in (("device", dev, dev_us),
                               ("host", host, lambda e: e.self_cpu_time_total)):
            best = sorted(sel, key=key, reverse=True)[:top]
            log(f"[profile] {part} top {top} {kind}: " + "; ".join(
                f"{e.key[:60]} {key(e) / 1e3:.2f} ms x{e.count}" for e in best))


def profile_cli(device, logdir, width=180, height=120):
    """Phase 11 (b): the CLI's --profile on stress-500 at width x height,
    1 spp: the trace file must exist and name K1's kernel."""
    import glob

    from paths_tpu_torch import cli

    import torch

    cpu = ["--cpu"] if torch.device(device).type == "cpu" else []
    with tempfile.TemporaryDirectory() as tmp:
        cli.main(["--spp", "1", "--size", f"{width}x{height}", "--profile", logdir,
                  "-o", os.path.join(tmp, "p.png")] + cpu)
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        text = f.read()
    n_k1 = text.count("sphere_traverse<false>")
    log(f"[profile] CLI --profile, stress-500 {width}x{height} 1 spp: {path} "
        f"({len(text) / 2**20:.1f} MiB) names K1's kernel sphere_traverse<false> "
        f"{n_k1} times")
    if n_k1 == 0:
        raise AssertionError("the CLI's trace does not name K1's kernel")


def oracle_phase(device, width=720, height=480, spp=(8, 4, 2)):
    """Phase 12: the C++ tracer through the CLI (--native-cpu --threads
    os.cpu_count()) on stress-500, doom_standin and dragon_standin at
    width x height and each scene's spp of phase 5: pixel-samples/s, the
    host's anchor.  Then converged-mean parity of the card's render against
    the tracer on ORACLE_PARITY's scenes at ORACLE_SIZE: global channel
    means and 8x4 tile means, tests/test_torch_oracle.py's bounds."""
    import numpy as np

    from paths_tpu_torch import camera as C
    from paths_tpu_torch import cli, native
    from paths_tpu_torch.render import render_image
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_stress_scene
    from paths_tpu_torch.scene.yaml_loader import load_scene_description

    threads = os.cpu_count()
    with tempfile.TemporaryDirectory() as tmp:
        for name, path, n_spp in (("stress-500", None, spp[0]), ("doom_standin", DOOM, spp[1]),
                                  ("dragon_standin", DRAGON, spp[2])):
            argv = ([path] if path else []) + [
                "--native-cpu", "--threads", str(threads), "--spp", str(n_spp), "--size",
                f"{width}x{height}", "-o", os.path.join(tmp, "oracle.png")]
            t = time.time()
            img = cli.main(argv)
            dt = time.time() - t
            check_image(f"{name} --native-cpu", img)
            log(f"[oracle] {name} {width}x{height} {n_spp} spp, --native-cpu --threads "
                f"{threads}: {dt:.2f} s with the scene build (the CLI's line above gives "
                "the render's own time and pixel-samples/s)")
    w, h = ORACLE_SIZE
    for name, (mb, mean_rtol, tile_rtol) in ORACLE_PARITY.items():
        sd = generate_stress_scene(500) if name == "stress-500" else load_scene_description(DOOM)
        static, scene, cam = build_scene(sd, device=device)
        static = dataclasses.replace(static, max_bounces=mb)
        cam = C.resize(cam, w, h)
        oracle = native.cpu_render(static, scene, cam, w, h, 4 * ORACLE_SPP, seed=11,
                                   n_threads=threads, max_bounces=mb)
        img = render_image(static, scene, cam, w, h, spp=ORACLE_SPP, seed=0)
        m_o, m_c = oracle.mean(axis=(0, 1)), img.mean(axis=(0, 1))
        mean_err = float((np.abs(m_c - m_o) / m_o).max())

        def tiles(a):
            return a.reshape(4, h // 4, 8, w // 8, 3).mean(axis=(1, 3))

        tile_err = float((np.abs(tiles(img) - tiles(oracle)) / float(m_o.mean())).max())
        log(f"[oracle] {name} {w}x{h}, {mb} bounces: the card at {ORACLE_SPP} spp against "
            f"the tracer at {4 * ORACLE_SPP} spp: channel means within {mean_err:.4f} "
            f"(< {mean_rtol}), 8x4 tiles within {tile_err:.4f} of the mean (< {tile_rtol})")
        if not (mean_err < mean_rtol and tile_err < tile_rtol):
            raise AssertionError(f"{name}: the card's render is not the oracle's")


def hdri_doom_scene(device):
    """doom_standin (kernel route) under scenes/assets/sunrise.hdr with
    environment NEE on: (static, scene, camera)."""
    from paths_tpu_torch.scene import desc as D
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.yaml_loader import load_scene_description

    sd = load_scene_description(DOOM)
    sd.skybox = D.SkyboxD(kind="hdri", filename=SUNRISE)
    static, scene, cam = build_scene(sd, device=device)
    if not static.tri_chunks:
        raise AssertionError("HDRI doom did not take the kernel route")
    return dataclasses.replace(static, env_nee=True), scene, cam


def hdri_doom(device, width=16, height=12, spp=2, bounces=3):
    """Environment NEE over a triangle table: doom_standin under the HDRI
    with env NEE at width x height, spp, `bounces` bounces, on the card with
    every environment K4 query (t_max BIG, no entity excluded) held bit for
    bit against its plain version on its inputs, and on the CPU; the images
    agree to relative MSE < 1e-4 (phase 7's bound)."""
    from paths_tpu_torch import camera as C
    from paths_tpu_torch.render import render_image

    TT = _kernel_modules()[1]
    k4, held = TT.occludes_tris, [0]

    def k4_held(pt, n_chunks, o, d, excl_idx, excl_ent, t_max):
        got = k4(pt, n_chunks, o, d, excl_idx, excl_ent, t_max)
        if bool((t_max == BIG).all()) and bool((excl_ent == -1).all()):
            check_equal("tri_any_hit on the environment's query", got,
                        TT.occludes_tris_plain(pt, n_chunks, o, d, excl_idx, excl_ent, t_max))
            held[0] += 1
        return got

    imgs = []
    for dev in (device, "cpu"):
        static, scene, cam = hdri_doom_scene(dev)
        static = dataclasses.replace(static, max_bounces=bounces)
        if dev == device:
            TT.occludes_tris = k4_held
            reset_launch_counts()
        try:
            imgs.append(render_image(static, scene, C.resize(cam, width, height), width,
                                     height, spp=spp, seed=0))
        finally:
            TT.occludes_tris = k4
        if dev == device:
            counts = launch_counts()
    if held[0] == 0:
        raise AssertionError("no environment K4 query was made")
    if counts["tri_any_hit"] == 0:
        raise AssertionError("tri_any_hit was not launched on HDRI doom")
    rel = rel_mse(*imgs)
    log(f"[gpu-vs-cpu] doom_standin under the sunrise HDRI with env NEE, {width}x{height} "
        f"{spp} spp, {bounces} bounces: each of the card's {held[0]} environment K4 "
        f"queries (t_max BIG, excl_ent -1) equal to the plain version on its inputs; "
        f"relative MSE against the CPU {rel:.3e} (< 1e-4); launches {counts}")
    if not rel < 1e-4:
        raise AssertionError(f"HDRI doom: card vs CPU relative MSE {rel:.3e} >= 1e-4")


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
    t = time.time()
    parse_meshes()
    log(f"[main] phase 2b in {time.time() - t:.1f} s")
    t = time.time()
    rng = lane_rng_phase(device)
    log(f"[main] phase 2c in {time.time() - t:.1f} s")

    t = time.time()
    frame = sphere_kernel_phases(device)
    log(f"[main] phases 3/4, 3c/4c and 3g in {time.time() - t:.1f} s")
    mesh = {}
    for key, path, label, scan in (("doom", DOOM, "doom_standin", True),
                                   ("dragon", DRAGON, "dragon_standin", False)):
        t = time.time()
        mesh[key] = tri_kernel_phases(device, path, label, scan=scan)
        log(f"[main] phases 3b-3f on {label} in {time.time() - t:.1f} s")

    t = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        launches, images = main_path(device, tmp)
    log(f"[main] kernel launches over the ten paths: {launches}; phase 5 in "
        f"{time.time() - t:.1f} s")
    t = time.time()

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
    log(f"[main] phase 6 in {time.time() - t:.1f} s")
    t = time.time()
    for route in ("walk", "flat", "bvh", "env"):
        gpu_vs_cpu(device, route)
    log(f"[main] phase 7 in {time.time() - t:.1f} s")
    t = time.time()
    hdri_doom(device)
    log(f"[main] HDRI doom in {time.time() - t:.1f} s")

    # Phases 8 and 9: the gradient, resume and progressive paths, each read
    # with the counts set to 0 just before it; their launches join the ten
    # paths' (phase 8 (c)'s, a comparison with the CPU, do not).
    t = time.time()
    torch.cuda.empty_cache()
    for counts in (gradient_step(device), vertex_colour_fd(device),
                   resume_and_progressive(device)):
        for k, v in counts.items():
            launches[k] += v
    log(f"[main] phases 8 and 9 in {time.time() - t:.1f} s")

    # Phase 10: data-parallel rendering and training on ranks sharing the
    # card (their launches join the main paths'), then the --dp sweep;
    # phase 11: profiles; phase 12: the oracle.
    t = time.time()
    for k, v in dp_phase(device, images).items():
        launches[k] += v
    log(f"[main] phase 10 (a, b) in {time.time() - t:.1f} s")
    t = time.time()
    dp_sweep(device)
    log(f"[main] phase 10 (c) in {time.time() - t:.1f} s")
    t = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        profile_gradient(device, tmp)
        profile_cli(device, os.path.join(tmp, "cli"))
    log(f"[main] phase 11 in {time.time() - t:.1f} s")
    t = time.time()
    oracle_phase(device)
    log(f"[main] phase 12 in {time.time() - t:.1f} s; kernel launches over every "
        f"path: {launches}")

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
    # plain_lanes: the lanes plain_ms ran on (K7/K9's doom subset: every
    # PLAIN_EVERY-th of its SUBSET lanes; every other: all of them).
    # The lane RNG's kernels: ms, device_ms, plain_ms (the eager hash and
    # CMJ on the same card tensors) and bound_ms at a main-path tile,
    # frame_* at a frame, scalar_* with a scalar bounce (phase 2c).
    recs = []
    for name in KERNELS:
        at = rng.get(name) or tile.get(name) or (
            mesh["doom"] if name.startswith("scan_tri") else frame)[name]
        base = ("max_abs_err", "ms", "device_ms", "plain_ms", "plain_lanes", "bound_ms",
                "bound_by")
        r = dict(name=name, route="cuda", **KERNELS[name], launches=launches[name],
                 **{k: at[k] for k in base}, library_ms=None)
        if name in rng:
            r.update({k: v for k, v in rng[name].items() if k not in base})
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
