"""The one place where the port's native sources (``csrc/``) are declared,
built, bound and called: the CUDA kernels, built with ``nvcc`` for
``sm_90a``, and with ``g++`` the host C++ BVH builder, the OBJ and PLY
parsers (``load_obj_native``, ``load_ply_native``) and the CPU path tracer
(the oracle, ``cpu_render``).

``LIBRARIES`` declares each source once: its compiler and flags and each
``extern "C"`` entry point with its ctypes restype and argument types, and
for a kernel the keys it is counted under.  ``library(source)`` builds and
binds a library at its first use; ``launch`` calls a kernel: its tensors
by pointer, on the current stream, raising on a CUDA error and counting
the launch in ``profiling.LAUNCHES``.  ``check`` and ``check_rays`` are the
kernel wrappers' argument checks.

Each library is compiled once per version of its source and flags into
``build/paths_tpu_torch/`` beside the package (the file name carries a hash
of both, of the kernels' shared headers ``csrc/*.cuh``, and for
``-march=native`` of the host CPU's target, so an edited source or header is
rebuilt and a library built for another CPU is not loaded).  A build writes
a temporary file and renames it into place, so processes that build at the
same time never load a partial library.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from paths_tpu_torch import profiling as P

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "paths_tpu_torch"

# -fmad=false: nvcc contracts no multiply-add on its own; the kernels issue
# exactly the fused multiply-adds their contract names, as fmaf.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
# The reference's flags for its native BVH builder, mesh parsers and CPU
# tracer (paths_tpu/native/Makefile); ISO C++17 keeps GCC from contracting
# multiply-adds.
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-pthread", "-shared"]


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("no C++ compiler (g++) found: the BVH builder, "
                           "the mesh parsers and the CPU tracer cannot be built")
    return found


class Entry(NamedTuple):
    """An ``extern "C"`` entry point: its ctypes restype and argument types
    and, for a kernel, the keys of ``profiling.LAUNCHES`` its wrappers
    count it under."""
    restype: object
    argtypes: list
    keys: tuple = ()


class Library(NamedTuple):
    """A source of ``csrc/``: its compiler (a function that finds it), its
    flags and its entry points by name."""
    compiler: Callable[[], str]
    flags: list
    entries: dict


_p, _i, _u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_i32, _i64 = ctypes.c_int32, ctypes.c_int64
_fp, _dp = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
_i32p, _i64p = ctypes.POINTER(_i32), ctypes.POINTER(_i64)

# Every library of csrc/.  A kernel takes its tensors by pointer, its counts
# as int or uint32, the stream last, and returns a cudaError_t.
LIBRARIES = {
    "sphere_traverse.cu": Library(nvcc, NVCC_FLAGS, {
        # table, nodes, o, d, excl, t_init, n, t, gid, ent, stream: K1, K8
        "sphere_closest_hit": Entry(_i, [_p, _p, _p, _p, _p, _p, _i, _p, _p, _p, _p],
                                    ("sphere_closest_hit", "scan_sphere_closest_hit")),
        # table, nodes, o, d, excl, excl_ent, t_max, n, occluded, stream: K2, K9
        "sphere_any_hit": Entry(_i, [_p, _p, _p, _p, _p, _p, _p, _i, _p, _p],
                                ("sphere_any_hit", "scan_sphere_any_hit"))}),
    "tri_traverse.cu": Library(nvcc, NVCC_FLAGS, {
        # tris, meta, nodes, o, d, excl, t_init, n, t, gid, ent, stream: K3, K7
        "tri_closest_hit": Entry(_i, [_p, _p, _p, _p, _p, _p, _p, _i, _p, _p, _p, _p],
                                 ("tri_closest_hit", "scan_tri_closest_hit")),
        # tris, meta, nodes, o, d, excl, excl_ent, t_max, n, occluded, stream: K4, K9
        "tri_any_hit": Entry(_i, [_p, _p, _p, _p, _p, _p, _p, _p, _i, _p, _p],
                             ("tri_any_hit", "scan_tri_any_hit"))}),
    "flat_spheres.cu": Library(nvcc, NVCC_FLAGS, {
        # table, rows, o, d, excl, t_init, n, t, gid, ent, stream: K5
        "flat_sphere_closest_hit": Entry(_i, [_p, _i, _p, _p, _p, _p, _i, _p, _p, _p, _p],
                                         ("flat_sphere_closest_hit",)),
        # table, rows, o, d, excl, excl_ent, t_max, n, occluded, stream: K5
        "flat_sphere_any_hit": Entry(_i, [_p, _i, _p, _p, _p, _p, _p, _i, _p, _p],
                                     ("flat_sphere_any_hit",))}),
    "packet_bvh.cu": Library(nvcc, NVCC_FLAGS, {
        # tree, tris, o, d, excl, t_init, n, t, gid, ent, stream: K6
        "packet_closest_hit": Entry(_i, [_p, _p, _p, _p, _p, _p, _i, _p, _p, _p, _p],
                                    ("packet_closest_hit",))}),
    "lane_rng.cu": Library(nvcc, NVCC_FLAGS, {
        # seed, seed word, pixel, sample, bounce, bounce_all, dim, n, out, stream
        "lane_shading_uniform": Entry(_i, [_u32, _p, _p, _p, _p, _u32, _u32, _i, _p, _p],
                                      ("rng_uniform",)),
        # seed, seed word, pixel, sample, m, n_pat, square_tag, disk_tag, n, out, stream
        "lane_camera_cmj": Entry(_i, [_u32, _p, _p, _p, _u32, _u32, _u32, _u32, _i, _p, _p],
                                 ("rng_camera",))}),
    "sphere_ds.cu": Library(nvcc, NVCC_FLAGS, {
        # center, center_lo, radius, lo, hi, o, d, excl, excl_idx, t_in, i_in, n,
        # t_out, i_out, stream
        "sphere_ds_closest": Entry(_i, [_p, _p, _p, _i, _i, _p, _p, _p, _p, _p, _p, _i,
                                        _p, _p, _p], ("sphere_ds_closest",)),
        # center, center_lo, radius, ent, n_spheres, o, d, excl, excl_idx, t_max,
        # excl_ent, occ_in, n, occ_out, stream
        "sphere_ds_any_hit": Entry(_i, [_p, _p, _p, _p, _i, _p, _p, _p, _p, _p, _p, _p,
                                        _i, _p, _p], ("sphere_ds_any_hit",)),
        # o, d, center, radius, n, t, hit, stream
        "sphere_ds_intersect": Entry(_i, [_p, _p, _p, _p, _i, _p, _p, _p],
                                     ("sphere_ds_intersect",))}),
    "bvh_builder.cc": Library(cxx, CXX_FLAGS, {
        # tri_min, tri_max, n, leaf_size, node_min, node_max, hit, miss, start,
        # count, order, n_nodes, depth
        "paths_build_bvh": Entry(_i, [_fp, _fp, _i64, _i32, _fp, _fp, _i32p, _i32p,
                                      _i32p, _i32p, _i64p, _i64p, _i32p])}),
    "mesh_io.cc": Library(cxx, CXX_FLAGS, {
        "paths_obj_load": Entry(_p, [ctypes.c_char_p, _i64p]),
        "paths_obj_model_info": Entry(_i, [_p, _i64, _i64p, _i64p, _i32p, _i32p]),
        "paths_obj_model_data": Entry(_i, [_p, _i64, _dp, _i64p, _dp, _dp]),
        "paths_obj_free": Entry(None, [_p]),
        "paths_ply_load": Entry(_p, [ctypes.c_char_p, _i64p, _i64p, _i32p]),
        "paths_ply_data": Entry(_i, [_p, _dp, _i64p, _dp]),
        "paths_ply_free": Entry(None, [_p])}),
    "cpu_tracer.cc": Library(cxx, CXX_FLAGS, {
        # Sizes and counts as int, the seed as uint64, every array a pointer.
        "paths_cpu_render": Entry(_i, (
            [_i, _i, _i, ctypes.c_uint64, _i, _i, _p]  # width .. max_bounces, cam17
            + [_i, _p, _p, _p]  # spheres
            + [_i, _p, _p, _p, _p, _p, _p, _p, _p]  # triangles
            + [_i, _p, _p, _p, _p, _p, _p, _p, _p]  # entities
            + [_i, _p, _p, _p, _p, _p, _p]  # lights
            + [_i, _p, _p, _i, _i, _p]  # sky
            + [_p]))}),  # out
}
_SOURCE = {name: source for source, lib in LIBRARIES.items() for name in lib.entries}
P.LAUNCHES.update(dict.fromkeys(
    (k for lib in LIBRARIES.values() for e in lib.entries.values() for k in e.keys), 0))


def _native_target(compiler: str) -> bytes:
    """What ``-march=native`` means to ``compiler`` on this host: its target
    options as the compiler resolves them, so a library built for another
    CPU is never loaded here."""
    res = subprocess.run([compiler, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{compiler} -march=native -Q --help=target failed "
                           f"({res.returncode}):\n{res.stderr}")
    return res.stdout.encode()


def load_library(source: str, compiler: str, flags: list[str],
                 verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` with ``compiler`` and ``flags`` into a
    shared library (unless this version is already built) and load it.
    verbose prints the compiler's messages (``-Xptxas=-v`` for nvcc).
    Adds its seconds and compiles to ``profiling.NATIVE_LOAD_S`` and
    ``NATIVE_BUILDS`` under `source`."""
    t = time.perf_counter()
    src = CSRC / source
    # A CUDA source's key covers the headers the kernels share (csrc/*.cuh).
    headers = sorted(CSRC.glob("*.cuh")) if src.suffix == ".cu" else []
    key = b"".join(p.read_bytes() for p in [src, *headers])
    key += " ".join(flags).encode()
    if "-march=native" in flags:
        key += _native_target(compiler)
    tag = hashlib.sha256(key).hexdigest()[:16]
    so = BUILD_DIR / f"{src.stem}_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *flags, "-o", str(tmp), str(src)]
        if verbose and Path(compiler).name == "nvcc":
            cmd.insert(1, "-Xptxas=-v")
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {source} failed ({res.returncode}):\n"
                               f"{res.stderr}")
        if verbose and res.stderr:
            print(res.stderr.strip())
        os.replace(tmp, so)  # atomic: a concurrent build never sees a partial file
        P.NATIVE_BUILDS[source] = P.NATIVE_BUILDS.get(source, 0) + 1
    lib = ctypes.CDLL(str(so))
    P.NATIVE_LOAD_S[source] = P.NATIVE_LOAD_S.get(source, 0.0) + time.perf_counter() - t
    return lib


_libs: dict = {}  # source -> its bound library
_calls: dict = {}  # kernel entry point -> its call (_bind)


def library(source: str, verbose: bool = False) -> ctypes.CDLL:
    """The library of ``csrc/<source>``, built (``load_library``) and its
    entry points bound as ``LIBRARIES`` declares them at the first call."""
    lib = _libs.get(source)
    if lib is None:
        decl = LIBRARIES[source]
        lib = load_library(source, decl.compiler(), decl.flags, verbose)
        for name, e in decl.entries.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = e.restype, e.argtypes
        _libs[source] = lib
    return lib


def build_all(verbose: bool = False) -> dict:
    """Build (or find built) and bind every library of ``LIBRARIES`` at
    once, one compiler process each.  Processes that will render together
    on the card call it first, so that none of them compiles while the
    others wait.  verbose prints the compilers' messages (ptxas's report of
    each kernel).  Returns {source: seconds}."""
    def timed(source):
        t = time.time()
        library(source, verbose)
        return time.time() - t

    with ThreadPoolExecutor(len(LIBRARIES)) as ex:
        futures = {source: ex.submit(timed, source) for source in LIBRARIES}
        return {source: f.result() for source, f in futures.items()}


def _bind(entry: str):
    """A kernel's call: its arguments converted as its declaration says,
    decided here once -- a pointer argument's tensor passed as its
    ``data_ptr()`` and None as a null pointer, every other as itself."""
    fn = getattr(library(_SOURCE[entry]), entry)
    ptr = tuple(t is _p for t in LIBRARIES[_SOURCE[entry]].entries[entry].argtypes[:-1])

    def call(args, stream):
        return fn(*[a.data_ptr() if p and a is not None else a
                    for p, a in zip(ptr, args)], stream)

    _calls[entry] = call
    return call


def launch(entry: str, key: str, device, *args) -> None:
    """Launch kernel `entry` with `args` (its arguments before the stream:
    tensors, None for a null pointer, integers) on the current stream of
    `device`, the lanes' device; raises RuntimeError on a CUDA error and
    counts the launch under `key` (``profiling.launched``).  The caller
    has checked the arguments (``check``)."""
    call = _calls.get(entry) or _bind(entry)
    err = call(args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{key} launch failed: cudaError_t {err}")
    P.launched(key)


def check(name: str, x, dtype, shape, device, align16: bool = False) -> None:
    """A kernel argument as its launch takes it: on `device`, of `dtype`
    (else TypeError) and `shape`, contiguous and, with align16, 16-byte
    aligned (the kernel reads it as float4); raises ValueError."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align16 and x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (the kernel reads float4)")


def check_rays(o, d, excl_idx, lane_args=()) -> int:
    """A traversal kernel's lanes (K1-K9): o, d (N, 3) f32, excl_idx (N,)
    i32 and each (name, x, dtype) of lane_args (N,), on o's device
    (``check``), and N below 2**31.  Returns N."""
    dev, n = o.device, o.shape[0]
    check("o", o, torch.float32, (n, 3), dev)
    check("d", d, torch.float32, (n, 3), dev)
    check("excl_idx", excl_idx, torch.int32, (n,), dev)
    for name, x, dtype in lane_args:
        check(name, x, dtype, (n,), dev)
    if n >= 2 ** 31:
        raise ValueError("too many lanes for one launch")
    return n


def _ptr(a, ctype):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctype))


def load_obj_native(path: str):
    """Parse an OBJ with the C++ parser (``csrc/mesh_io.cc``, port of
    ``paths_tpu/native/__init__.py::load_obj_native``): a list of dicts, one
    a model (vertices (V, 3) f64, faces (F, 3) i64, texcoords (V, 2) f64 or
    None, diffuse (3,) f64 or None), or None where the parser gives up (a
    file it cannot read), so that the caller parses it in Python.  A failed
    build raises."""
    lib = library("mesh_io.cc")
    n_models = ctypes.c_int64(0)
    h = lib.paths_obj_load(os.fsencode(path), ctypes.byref(n_models))
    if not h:
        return None
    try:
        out = []
        for i in range(n_models.value):
            nv, nf = ctypes.c_int64(0), ctypes.c_int64(0)
            has_uv, has_kd = ctypes.c_int32(0), ctypes.c_int32(0)
            if lib.paths_obj_model_info(h, i, ctypes.byref(nv), ctypes.byref(nf),
                                        ctypes.byref(has_uv), ctypes.byref(has_kd)):
                return None
            verts = np.empty((nv.value, 3), np.float64)
            faces = np.empty((nf.value, 3), np.int64)
            uvs = np.empty((nv.value, 2), np.float64) if has_uv.value else None
            kd = np.empty(3, np.float64) if has_kd.value else None
            if lib.paths_obj_model_data(h, i, _ptr(verts, ctypes.c_double),
                                        _ptr(faces, ctypes.c_int64),
                                        _ptr(uvs, ctypes.c_double),
                                        _ptr(kd, ctypes.c_double)):
                return None
            out.append(dict(vertices=verts, faces=faces, texcoords=uvs, diffuse=kd))
        return out
    finally:
        lib.paths_obj_free(h)


def load_ply_native(path: str):
    """Parse a PLY with the C++ parser (``csrc/mesh_io.cc``, port of
    ``paths_tpu/native/__init__.py::load_ply_native``): a dict (vertices
    (V, 3) f64, faces (F, 3) i64, vertex_colours (V, 3) f64 or None), or
    None where the parser gives up (a file it cannot read, no end_header, a
    binary body shorter than its header says), so that the caller parses it
    in Python.  A failed build raises."""
    lib = library("mesh_io.cc")
    nv, nf = ctypes.c_int64(0), ctypes.c_int64(0)
    has_col = ctypes.c_int32(0)
    h = lib.paths_ply_load(os.fsencode(path), ctypes.byref(nv), ctypes.byref(nf),
                           ctypes.byref(has_col))
    if not h:
        return None
    try:
        verts = np.empty((nv.value, 3), np.float64)
        faces = np.empty((nf.value, 3), np.int64)
        cols = np.empty((nv.value, 3), np.float64) if has_col.value else None
        if lib.paths_ply_data(h, _ptr(verts, ctypes.c_double),
                              _ptr(faces, ctypes.c_int64), _ptr(cols, ctypes.c_double)):
            return None
        return dict(vertices=verts, faces=faces, vertex_colours=cols)
    finally:
        lib.paths_ply_free(h)


def cpu_render(static, scene, cam, width: int, height: int, spp: int,
               seed: int = 0, n_threads: int = 4, max_bounces: int = 10):
    """Render with the C++ CPU tracer (``csrc/cpu_tracer.cc``, port of
    ``paths_tpu/native/__init__.py::cpu_render``): the host anchor and the
    independent oracle.  Takes the (static, scene, cam) triple that
    ``scene.build.build_scene`` returns, on any device, and hands the tracer
    host copies (f64, int32, uint8).  Returns the (H, W, 3) f64
    linear-radiance means, or None when the scene uses a material the
    Rust renderer cannot BSDF-sample (Cook-Torrance, Fresnel:
    material.rs:81-88), which the tracer refuses.  A failed build
    raises."""
    lib = library("cpu_tracer.cc")

    def host(t, dtype, n=None):
        a = t.detach().cpu().numpy()
        return np.ascontiguousarray(a if n is None else a[:n], dtype)

    f64 = lambda t, n=None: host(t, np.float64, n)
    i32 = lambda t, n=None: host(t, np.int32, n)
    u8 = lambda t, n=None: host(t, np.uint8, n)

    # The camera: 17 doubles [loc 3, rot 9 row-major, f, v, aperture, sw, sh].
    cam17 = np.concatenate([
        f64(cam.location).ravel(), f64(cam.rot).ravel(),
        [float(x) for x in (cam.focal_length, cam.distance_from_lens, cam.aperture,
                            cam.sensor_width, cam.sensor_height)]])
    n_sph, n_tri, n_lights = static.n_spheres, static.n_tris, static.n_lights
    sph = (f64(scene.sph_center, n_sph) + f64(scene.sph_center_lo, n_sph),
           f64(scene.sph_radius, n_sph),
           i32(scene.sph_ent, n_sph))
    tris = (f64(scene.tri_v0, n_tri), f64(scene.tri_v1, n_tri), f64(scene.tri_v2, n_tri),
            f64(scene.tri_n, n_tri),
            np.concatenate([f64(getattr(scene, f"tri_vn{k}"), n_tri) for k in range(3)], 1),
            np.concatenate([f64(getattr(scene, f"tri_vc{k}"), n_tri) for k in range(3)], 1),
            i32(scene.tri_ent, n_tri), u8(scene.tri_smooth, n_tri))
    ents = (i32(scene.mat_mtype), f64(scene.mat_albedo), u8(scene.mat_albedo_vertex),
            f64(scene.mat_emit), f64(scene.mat_r0), f64(scene.mat_metalness),
            u8(scene.ent_is_light), f64(scene.ent_light_emission))
    lights = tuple(conv(getattr(scene, f), n_lights) for conv, f in (
        (i32, "light_ltype"), (f64, "light_pos"), (f64, "light_radius"),
        (f64, "light_colour"), (f64, "light_intensity"), (i32, "light_ent")))
    sky_a = np.resize(f64(scene.sky.colour_a).ravel(), 3)
    sky_b = np.resize(f64(scene.sky.colour_b).ravel(), 3)
    sky_img = host(scene.sky.image, np.float32)
    out = np.zeros((height, width, 3), np.float64)

    ptr = lambda a: a.ctypes.data  # every array above outlives the call
    rc = lib.paths_cpu_render(
        width, height, spp, seed, n_threads, max_bounces, ptr(cam17),
        n_sph, *map(ptr, sph),
        n_tri, *map(ptr, tris),
        len(ents[0]), *map(ptr, ents),
        n_lights, *map(ptr, lights),
        static.sky_type, ptr(sky_a), ptr(sky_b), sky_img.shape[1], sky_img.shape[0],
        ptr(sky_img),
        ptr(out))
    return None if rc else out
