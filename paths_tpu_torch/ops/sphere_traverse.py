"""Small-sphere traversal: the packed sphere table, the CUDA closest-hit and
any-hit kernels that walk it, and their plain PyTorch versions.

Ports ``paths_tpu/ops/pallas_traverse.py::pack_spheres_chunked`` (bit-exact)
and the sphere forms of ``paths_tpu/ops/sorted_traverse.py``
(``closest_hit_spheres_sorted`` -> ``closest_hit_spheres``,
``occludes_spheres_sorted`` -> ``occludes_spheres``).  The kernels in
``csrc/sphere_traverse.cu`` replace ``sorted_traverse.py::_make_sorted_kernel``
(sphere forms, row test ``pallas_traverse.py::_sphere_row_test``).

What bounds them on an H100: FP32 issue.  A (ray, slot) pair costs about 25
FP32 operations while a lane moves about 36 bytes of ray input and output,
and the table (16 KB at 500 spheres) stays in cache.  The design keeps it
simple: one thread per ray, warp-wide broadcast reads of each slot, a
per-lane chunk slab test to skip chunks the ray does not cross before its
current best, and early return for any-hit.  The arithmetic is IEEE with
exactly three fused multiply-adds -- where XLA's CPU compilation of the
reference kernel contracts (see ``_row_test``) -- so the plain versions, the
kernels and the reference in interpret mode agree bit for bit.

Dispatch: a wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises -- it never falls back.  Each
wrapper counts its kernel launches in ``LAUNCHES``.  The kernels are built
with ``nvcc`` at first use into ``build/`` beside the package and loaded
with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from paths_tpu_torch.math import vec

SPH_STRIDE = 8  # floats per sphere slot: [cx cy cz r^2 gid ent 0 0]
SPH_PER_ROW = 128 // SPH_STRIDE  # 16
# Rows per chunk (2 rows = 32 sphere slots), as the reference's sorted walk.
SPH_ROWS_PER_CHUNK = 2
BIG = 3.4e38
DEAD = 1e29  # a lane whose origin x is past this is dead (a miss)

# Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES = {"sphere_closest_hit": 0, "sphere_any_hit": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class PackedSpheres(NamedTuple):
    tris: torch.Tensor  # (R, 128) f32 rows of 16 sphere slots
    chunk_meta: torch.Tensor  # (Cpad, 128) f32: [lo.xyz, hi.xyz, row0, nrows]


def pack_spheres_chunked(centers, radii, ent=None, gid0: int = 0,
                         device="cpu"):
    """Pack spheres (numpy (S,3), (S,)) into chunks of SPH_ROWS_PER_CHUNK
    rows.  Slot layout
    [cx cy cz r^2 gid ent 0 0]; empty slots have r^2 = -1 and gid = -1.
    Spheres are morton-sorted so chunk AABBs stay tight; the gid written is
    gid0 + position in the sorted order.  Returns (PackedSpheres, n_chunks,
    order).  Bit-exact with the reference package's packer."""
    S = len(radii)
    c = np.asarray(centers, np.float64)
    r = np.asarray(radii, np.float64)
    if ent is None:
        ent = np.zeros(S, np.int64)
    ent = np.asarray(ent)
    lo, hi = c.min(0), c.max(0)
    ext = np.where(hi - lo > 0, hi - lo, 1.0)
    q = np.clip(((c - lo) / ext * 1023).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    order = np.argsort(spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2))
    c, r, ent = c[order], r[order], ent[order]

    R = -(-S // SPH_PER_ROW)
    n_chunks = -(-R // SPH_ROWS_PER_CHUNK)
    # Every row, padding included, gets the canonical empty fill: an
    # all-zero row would act as r=0 spheres at the origin with gid 0.
    rpad = -(-max(n_chunks * SPH_ROWS_PER_CHUNK, 1) // 8) * 8
    rows = np.zeros((rpad, 128), np.float32)
    rows[:, 3::SPH_STRIDE] = -1.0  # r^2 = -1 in empty slots
    rows[:, 4::SPH_STRIDE] = -1.0
    for i in range(S):
        row, slot = divmod(i, SPH_PER_ROW)
        s = slot * SPH_STRIDE
        rows[row, s: s + 3] = c[i]
        rows[row, s + 3] = r[i] * r[i]
        rows[row, s + 4] = gid0 + i
        rows[row, s + 5] = ent[i]

    meta = np.zeros((n_chunks, 128), np.float32)
    for k in range(n_chunks):
        i0 = k * SPH_ROWS_PER_CHUNK * SPH_PER_ROW
        i1 = min(i0 + SPH_ROWS_PER_CHUNK * SPH_PER_ROW, S)
        cc, rr = c[i0:i1], r[i0:i1, None]
        meta[k, 0:3] = (cc - rr).min(0)
        meta[k, 3:6] = (cc + rr).max(0)
        meta[k, 6] = k * SPH_ROWS_PER_CHUNK
        meta[k, 7] = min((k + 1) * SPH_ROWS_PER_CHUNK, R) - k * SPH_ROWS_PER_CHUNK
    meta = np.pad(meta, ((0, (-len(meta)) % 8), (0, 0)))  # 8-row multiple
    packed = PackedSpheres(tris=torch.from_numpy(rows).to(device),
                           chunk_meta=torch.from_numpy(meta).to(device))
    return packed, n_chunks, order


# ---------------------------------------------------------------------------
# Plain PyTorch versions: flat brute force over every slot of the table, in
# the kernel's arithmetic order, with a first-index tie-break.  Used on CPU
# tensors, and by the tests and the chip smoke run to hold the kernels.
# ---------------------------------------------------------------------------

# Lanes per step of the plain versions (bounds the (lanes, slots) temporaries).
_PLAIN_PAIRS_PER_STEP = 1 << 22


def _slot_fields(table: torch.Tensor):
    slots = table.reshape(-1, SPH_STRIDE)
    return (slots[:, 0], slots[:, 1], slots[:, 2], slots[:, 3],
            slots[:, 4].to(torch.int32), slots[:, 5].to(torch.int32))


def _fma(a, b, c):
    """Correctly rounded f32 fused multiply-add.  The product of two f32 is
    exact in f64; the f64 sum is made round-to-odd (from its exact error
    term) so that the one rounding to f32 is correct -- a plain f64 sum
    would round twice and miss a true FMA now and then."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # p + c == s + err exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _row_test(fields, o, d, excl, t_seed):
    """(lanes, slots) qualifying mask and t, as _sphere_row_test computes
    them against the lane's seed -- with the three fused multiply-adds the
    reference kernel gets when XLA compiles it for the CPU, which the CUDA
    kernel issues as fmaf."""
    cx, cy, cz, r2, gid, _ = fields
    ocx = o[:, 0:1] - cx
    ocy = o[:, 1:2] - cy
    ocz = o[:, 2:3] - cz
    b = _fma(d[:, 2:3], ocz, _fma(d[:, 0:1], ocx, d[:, 1:2] * ocy))
    c2 = _fma(ocz, ocz, _fma(ocx, ocx, ocy * ocy)) - r2
    disc = _fma(b, b, -c2)
    root = vec.sqrt(torch.clamp_min(disc, 0.0))
    d1 = -b + root
    d2 = -b - root
    t = torch.where(d2 > 0.0, d2, d1)
    live = ~(o[:, 0:1] > DEAD)
    ok = ((disc >= 0.0) & (d1 >= 0.0) & (t < t_seed[:, None])
          & (gid != excl[:, None]) & (gid >= 0) & live)
    return ok, t


def _lane_steps(n: int, n_slots: int):
    step = max(1, _PLAIN_PAIRS_PER_STEP // max(n_slots, 1))
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def closest_hit_spheres_plain(table, o, d, excl_idx, t_init):
    """Plain version of the closest-hit kernel: (t, gid, ent) with t = BIG,
    gid = ent = 0 where no slot beats t_init."""
    fields = _slot_fields(table)
    n = o.shape[0]
    t_out = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    gid_out = torch.zeros(n, dtype=torch.int32, device=o.device)
    ent_out = torch.zeros(n, dtype=torch.int32, device=o.device)
    for a, b in _lane_steps(n, fields[0].shape[0]):
        ok, t = _row_test(fields, o[a:b], d[a:b], excl_idx[a:b], t_init[a:b])
        tm = torch.where(ok, t, float("inf"))
        arg = torch.argmin(tm, dim=1)  # first index among equal minima
        tmin = torch.gather(tm, 1, arg[:, None])[:, 0]
        found = tmin < float("inf")
        t_out[a:b] = torch.where(found, tmin, BIG)
        gid_out[a:b] = torch.where(found, fields[4][arg], 0)
        ent_out[a:b] = torch.where(found, fields[5][arg], 0)
    return t_out, gid_out, ent_out


def occludes_spheres_plain(table, o, d, excl_idx, excl_ent, t_max):
    """Plain version of the any-hit kernel: True where some slot with
    gid != excl and ent != excl_ent is hit at t < t_max.  A lane seeded with
    t_max == 0 reports occluded, as the kernel's collapsed-t output does."""
    fields = _slot_fields(table)
    n = o.shape[0]
    occ = t_max == 0.0
    for a, b in _lane_steps(n, fields[0].shape[0]):
        ok, _ = _row_test(fields, o[a:b], d[a:b], excl_idx[a:b], t_max[a:b])
        ok = ok & (fields[5] != excl_ent[a:b, None])
        occ[a:b] |= ok.any(dim=1)
    return occ


# ---------------------------------------------------------------------------
# CUDA kernels: build, bind, launch.
# ---------------------------------------------------------------------------

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "sphere_traverse.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paths_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build_kernels(verbose: bool = False) -> ctypes.CDLL:
    """Compile csrc/sphere_traverse.cu (once per source version) and load
    it.  The library name carries a hash of the source and flags, so an
    edited source is rebuilt."""
    global _lib
    if _lib is not None:
        return _lib
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"sphere_traverse_{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        if verbose and res.stderr:
            print(res.stderr.strip())
        os.replace(tmp, so)  # atomic: a concurrent build never sees a partial file
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sphere_closest_hit.argtypes = [p, p, i, p, p, p, p, i, p, p, p, p]
    lib.sphere_closest_hit.restype = i
    lib.sphere_any_hit.argtypes = [p, p, i, p, p, p, p, p, i, p, p]
    lib.sphere_any_hit.restype = i
    _lib = lib
    return lib


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_launch(ps: PackedSpheres, n_chunks, o, d, excl_idx, lane_args):
    dev = o.device
    n = o.shape[0]
    _check("table", ps.tris, torch.float32, (ps.tris.shape[0], 128), dev)
    _check("chunk_meta", ps.chunk_meta, torch.float32,
           (ps.chunk_meta.shape[0], 128), dev)
    if not 0 <= n_chunks <= ps.chunk_meta.shape[0]:
        raise ValueError(f"n_chunks {n_chunks} exceeds the meta's "
                         f"{ps.chunk_meta.shape[0]} rows")
    _check("o", o, torch.float32, (n, 3), dev)
    _check("d", d, torch.float32, (n, 3), dev)
    _check("excl_idx", excl_idx, torch.int32, (n,), dev)
    for name, x, dtype in lane_args:
        _check(name, x, dtype, (n,), dev)
    if n >= 2 ** 31:
        raise ValueError("too many lanes for one launch")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def closest_hit_spheres(ps: PackedSpheres, n_chunks: int, o, d, excl_idx,
                        t_init):
    """Closest small-sphere hit per lane: (t, gid, ent), t == BIG (gid = ent
    = 0) where nothing beats t_init.  o, d (N,3) f32; excl_idx (N,) i32 sphere
    id to skip (-1 none); t_init (N,) f32."""
    if o.device.type == "cpu":
        return closest_hit_spheres_plain(ps.tris, o, d, excl_idx, t_init)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    _check_launch(ps, n_chunks, o, d, excl_idx,
                  [("t_init", t_init, torch.float32)])
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    gid = torch.empty(n, dtype=torch.int32, device=o.device)
    ent = torch.empty(n, dtype=torch.int32, device=o.device)
    if n == 0:
        return t, gid, ent
    lib = build_kernels()
    err = lib.sphere_closest_hit(
        ps.tris.data_ptr(), ps.chunk_meta.data_ptr(), n_chunks,
        o.data_ptr(), d.data_ptr(), excl_idx.data_ptr(), t_init.data_ptr(), n,
        t.data_ptr(), gid.data_ptr(), ent.data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream,
    )
    _raise_on(err, "sphere_closest_hit")
    LAUNCHES["sphere_closest_hit"] += 1
    return t, gid, ent


def occludes_spheres(ps: PackedSpheres, n_chunks: int, o, d, excl_idx,
                     excl_ent, t_max):
    """Any-hit occlusion per lane (bool): some sphere other than excl_idx,
    of an entity other than excl_ent, is hit at t < t_max."""
    if o.device.type == "cpu":
        return occludes_spheres_plain(ps.tris, o, d, excl_idx, excl_ent, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    _check_launch(ps, n_chunks, o, d, excl_idx,
                  [("excl_ent", excl_ent, torch.int32),
                   ("t_max", t_max, torch.float32)])
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n == 0:
        return occ
    lib = build_kernels()
    err = lib.sphere_any_hit(
        ps.tris.data_ptr(), ps.chunk_meta.data_ptr(), n_chunks,
        o.data_ptr(), d.data_ptr(), excl_idx.data_ptr(), excl_ent.data_ptr(),
        t_max.data_ptr(), n, occ.data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream,
    )
    _raise_on(err, "sphere_any_hit")
    LAUNCHES["sphere_any_hit"] += 1
    return occ
