"""The flat sphere kernels (K5) and the linear chunk-scan kernels (K7, K8,
K9): their CUDA launches and their plain PyTorch versions.

Ports the K5, K7, K8 and K9 parts of ``paths_tpu/ops/pallas_traverse.py``
under the reference's names, used module-qualified:

- ``flat_closest_hit`` and ``flat_occludes`` (K5, the two forms of
  ``_launch_flat_spheres``): brute force over every slot of a small sphere
  table, no meta and no cull;
  the render path's sphere route when ``PATHS_TPU_SPH_FLAT=1`` and the table
  has at most ``SPH_FLAT_MAX_ROWS`` rows (``scene/build.py``);
- ``closest_hit_chunked`` (K7) over the plane-form triangle table
  (``ops/tri_traverse.py::pack_chunked``, 32 rows per chunk by default);
- ``closest_hit_spheres`` (K8) over the sphere table
  (``ops/sphere_traverse.py::pack_spheres_chunked``, 16 rows per chunk here);
  ``sphere_traverse.closest_hit_spheres`` stays K1;
- ``occludes_chunked`` and ``occludes_spheres`` (K9).

They compute exactly the functions of the plain versions that K1-K4 are held
against -- flat brute force in the kernels' arithmetic
(``sphere_traverse.closest_hit_spheres_plain``, ``occludes_spheres_plain``,
``tri_traverse.closest_hit_tris_plain``, ``occludes_tris_plain``) -- so those
are their plain versions here, and the tests hold them against the
reference's kernels in interpret mode.  The kernels are
``csrc/flat_spheres.cu`` (K5) and ``csrc/chunk_scan.cu`` (K7-K9; the row
tests are ``csrc/row_tests.cuh``, shared with K1-K4).

Dispatch, as for K1-K4: a wrapper given CPU tensors runs the plain version;
given CUDA tensors it launches the kernel or raises -- it never falls back.
Each wrapper counts its kernel launches in ``LAUNCHES``.  The kernels are
built with ``nvcc`` at first use into ``build/`` beside the package and
loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from paths_tpu_torch import native
from paths_tpu_torch.ops import sphere_traverse as ST
from paths_tpu_torch.ops import tri_traverse as TT

# Largest sphere table (rows) the flat kernel takes: 64 rows = 1,024 slots,
# 32 KB staged in shared memory (the reference's SPH_FLAT_MAX_ROWS).
SPH_FLAT_MAX_ROWS = 64
# Rows per chunk of the linear scan's tables (the reference packers'
# defaults): 32 triangle rows (256 slots), 16 sphere rows (256 slots).
TRI_ROWS_PER_CHUNK = 32
SPH_ROWS_PER_CHUNK = 16

# Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES = {"flat_sphere_closest_hit": 0, "flat_sphere_any_hit": 0,
            "scan_tri_closest_hit": 0, "scan_sphere_closest_hit": 0,
            "scan_tri_any_hit": 0, "scan_sphere_any_hit": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# CUDA kernels: build, bind, launch.
# ---------------------------------------------------------------------------

_libs = {}


def build_kernels(verbose: bool = False) -> dict:
    """Build csrc/flat_spheres.cu and csrc/chunk_scan.cu (once per source
    version) and load them: {"flat": CDLL, "scan": CDLL}."""
    if not _libs:
        p, i = ctypes.c_void_p, ctypes.c_int
        flat, scan = (native.load_library(src, native.nvcc(), native.NVCC_FLAGS, verbose)
                      for src in ("flat_spheres.cu", "chunk_scan.cu"))
        closest = [p, p, i, p, p, p, p, i, p, p, p, p]
        anyhit = [p, p, i, p, p, p, p, p, i, p, p]
        for fn, argtypes in (
                (flat.flat_sphere_closest_hit, [p, i, p, p, p, p, i, p, p, p, p]),
                (flat.flat_sphere_any_hit, [p, i, p, p, p, p, p, i, p, p]),
                (scan.scan_tri_closest_hit, closest), (scan.scan_sphere_closest_hit, closest),
                (scan.scan_tri_any_hit, anyhit), (scan.scan_sphere_any_hit, anyhit)):
            fn.argtypes, fn.restype = argtypes, i
        _libs.update(flat=flat, scan=scan)
    return _libs


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_cuda(o):
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")


def _check_table(packed, n_chunks, o, d, excl_idx, lane_args):
    """K1-K4's launch checks (device, dtype, shape, contiguity, chunk
    count), and the table's 16-byte alignment (the kernel reads slots as
    float4)."""
    ST._check_launch(packed, n_chunks, o, d, excl_idx, lane_args)
    if packed.tris.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned (the kernel "
                         "reads slots as float4)")


def _launch_closest(name, packed, n_chunks, o, d, excl_idx, t_init):
    _check_table(packed, n_chunks, o, d, excl_idx,
                 [("t_init", t_init, torch.float32)])
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    gid = torch.empty(n, dtype=torch.int32, device=o.device)
    ent = torch.empty(n, dtype=torch.int32, device=o.device)
    if n == 0:
        return t, gid, ent
    err = getattr(build_kernels()["scan"], name)(
        packed.tris.data_ptr(), packed.chunk_meta.data_ptr(), n_chunks,
        o.data_ptr(), d.data_ptr(), excl_idx.data_ptr(), t_init.data_ptr(), n,
        t.data_ptr(), gid.data_ptr(), ent.data_ptr(), _stream(o))
    ST._raise_on(err, name)
    LAUNCHES[name] += 1
    return t, gid, ent


def _launch_any(name, packed, n_chunks, o, d, excl_idx, excl_ent, t_max):
    _check_table(packed, n_chunks, o, d, excl_idx,
                 [("excl_ent", excl_ent, torch.int32),
                  ("t_max", t_max, torch.float32)])
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n == 0:
        return occ
    err = getattr(build_kernels()["scan"], name)(
        packed.tris.data_ptr(), packed.chunk_meta.data_ptr(), n_chunks,
        o.data_ptr(), d.data_ptr(), excl_idx.data_ptr(), excl_ent.data_ptr(),
        t_max.data_ptr(), n, occ.data_ptr(), _stream(o))
    ST._raise_on(err, name)
    LAUNCHES[name] += 1
    return occ


def closest_hit_chunked(pt: TT.PackedTris, n_chunks: int, o, d, excl_idx,
                        t_init):
    """K7: closest triangle hit per lane by the linear culled-chunk scan:
    (t, gid, ent), t == BIG (gid = ent = 0) where nothing beats t_init.
    o, d (N,3) f32; excl_idx (N,) i32 triangle id to skip (-1 none);
    t_init (N,) f32."""
    if o.device.type == "cpu":
        return TT.closest_hit_tris_plain(pt, n_chunks, o, d, excl_idx, t_init)
    _check_cuda(o)
    return _launch_closest("scan_tri_closest_hit", pt, n_chunks, o, d,
                           excl_idx, t_init)


def closest_hit_spheres(ps: ST.PackedSpheres, n_chunks: int, o, d, excl_idx,
                        t_init):
    """K8: closest small-sphere hit per lane by the linear culled-chunk
    scan; the contract of closest_hit_chunked, sphere ids as packed."""
    if o.device.type == "cpu":
        return ST.closest_hit_spheres_plain(ps.tris, o, d, excl_idx, t_init)
    _check_cuda(o)
    return _launch_closest("scan_sphere_closest_hit", ps, n_chunks, o, d,
                           excl_idx, t_init)


def occludes_chunked(pt: TT.PackedTris, n_chunks: int, o, d, excl_idx,
                     excl_ent, t_max):
    """K9, triangle form: True per lane iff some triangle other than
    excl_idx, of an entity other than excl_ent, is hit at t < t_max (a lane
    seeded with t_max == 0 reports occluded)."""
    if o.device.type == "cpu":
        return TT.occludes_tris_plain(pt, n_chunks, o, d, excl_idx, excl_ent,
                                      t_max)
    _check_cuda(o)
    return _launch_any("scan_tri_any_hit", pt, n_chunks, o, d, excl_idx,
                       excl_ent, t_max)


def occludes_spheres(ps: ST.PackedSpheres, n_chunks: int, o, d, excl_idx,
                     excl_ent, t_max):
    """K9, sphere form: any-hit occlusion over the sphere table (see
    occludes_chunked)."""
    if o.device.type == "cpu":
        return ST.occludes_spheres_plain(ps.tris, o, d, excl_idx, excl_ent,
                                         t_max)
    _check_cuda(o)
    return _launch_any("scan_sphere_any_hit", ps, n_chunks, o, d, excl_idx,
                       excl_ent, t_max)


def _check_flat(table, o, d, excl_idx, lane_args):
    """The flat kernel's launch checks (device, dtype, shape, contiguity, at
    most SPH_FLAT_MAX_ROWS table rows).  Returns the table's row count."""
    dev, n = o.device, o.shape[0]
    rows = table.shape[0] if table.dim() == 2 else -1
    ST._check("table", table, torch.float32, (rows, 128), dev)
    if not 0 < rows <= SPH_FLAT_MAX_ROWS:
        raise ValueError(f"the flat kernel takes 1 to {SPH_FLAT_MAX_ROWS} "
                         f"table rows, not {rows}")
    ST._check("o", o, torch.float32, (n, 3), dev)
    ST._check("d", d, torch.float32, (n, 3), dev)
    ST._check("excl_idx", excl_idx, torch.int32, (n,), dev)
    for name, x, dtype in lane_args:
        ST._check(name, x, dtype, (n,), dev)
    if n >= 2 ** 31:
        raise ValueError("too many lanes for one launch")
    return rows


def flat_closest_hit(table, o, d, excl_idx, t_init):
    """K5, closest-hit form: every slot of the sphere table (R, 128) f32,
    R <= 64, against every lane: (t, gid, ent), t == BIG (gid = ent = 0)
    where nothing beats t_init."""
    if o.device.type == "cpu":
        return ST.closest_hit_spheres_plain(table, o, d, excl_idx, t_init)
    _check_cuda(o)
    rows = _check_flat(table, o, d, excl_idx, [("t_init", t_init, torch.float32)])
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    gid = torch.empty(n, dtype=torch.int32, device=o.device)
    ent = torch.empty(n, dtype=torch.int32, device=o.device)
    if n == 0:
        return t, gid, ent
    err = build_kernels()["flat"].flat_sphere_closest_hit(
        table.data_ptr(), rows, o.data_ptr(), d.data_ptr(), excl_idx.data_ptr(),
        t_init.data_ptr(), n, t.data_ptr(), gid.data_ptr(), ent.data_ptr(),
        _stream(o))
    ST._raise_on(err, "flat_sphere_closest_hit")
    LAUNCHES["flat_sphere_closest_hit"] += 1
    return t, gid, ent


def flat_occludes(table, o, d, excl_idx, excl_ent, t_max):
    """K5, any-hit form: True per lane iff some sphere of the table other
    than excl_idx, of an entity other than excl_ent, is hit at t < t_max (a
    lane seeded with t_max == 0 reports occluded)."""
    if o.device.type == "cpu":
        return ST.occludes_spheres_plain(table, o, d, excl_idx, excl_ent, t_max)
    _check_cuda(o)
    rows = _check_flat(table, o, d, excl_idx, [("excl_ent", excl_ent, torch.int32),
                                               ("t_max", t_max, torch.float32)])
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n == 0:
        return occ
    err = build_kernels()["flat"].flat_sphere_any_hit(
        table.data_ptr(), rows, o.data_ptr(), d.data_ptr(), excl_idx.data_ptr(),
        excl_ent.data_ptr(), t_max.data_ptr(), n, occ.data_ptr(), _stream(o))
    ST._raise_on(err, "flat_sphere_any_hit")
    LAUNCHES["flat_sphere_any_hit"] += 1
    return occ
