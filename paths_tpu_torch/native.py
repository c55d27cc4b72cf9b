"""Builds the port's native sources (``csrc/``) at first use and loads them
with ``ctypes``: the CUDA kernels with ``nvcc`` for ``sm_90a``, and with
``g++`` the host C++ BVH builder, the OBJ and PLY parsers
(``load_obj_native``, ``load_ply_native``) and the CPU path tracer (the
oracle, ``cpu_render``).

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

import numpy as np

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


def build_all(verbose: bool = False) -> dict:
    """Build (or find built) and bind every library of ``csrc/`` at once,
    one compiler process each: the five CUDA libraries, the host BVH
    builder, the mesh parsers and the CPU tracer.  Processes that will render together on the
    card call it first, so that none of them compiles while the others
    wait.  verbose prints ptxas's report of each kernel.  Returns {source:
    seconds}."""
    from paths_tpu_torch.bvh import build as BB
    from paths_tpu_torch.ops import chunk_scan as CS
    from paths_tpu_torch.ops import lane_rng as RNG
    from paths_tpu_torch.ops import packet_traverse as PK
    from paths_tpu_torch.ops import sphere_traverse as ST
    from paths_tpu_torch.ops import tri_traverse as TT

    jobs = {"sphere_traverse.cu": lambda: ST.build_kernels(verbose),
            "tri_traverse.cu": lambda: TT.build_kernels(verbose),
            "flat_spheres.cu": lambda: CS.build_kernels(verbose),
            "packet_bvh.cu": lambda: PK.build_kernels(verbose),
            "lane_rng.cu": lambda: RNG.build_kernels(verbose),
            "bvh_builder.cc": BB._native_lib,
            "mesh_io.cc": _mesh_lib,
            "cpu_tracer.cc": _tracer_lib}

    def timed(fn):
        t = time.time()
        fn()
        return time.time() - t

    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {name: ex.submit(timed, fn) for name, fn in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


_mesh = None


def _mesh_lib() -> ctypes.CDLL:
    global _mesh
    if _mesh is None:
        lib = load_library("mesh_io.cc", cxx(), CXX_FLAGS)
        c = ctypes
        i64p, i32p = c.POINTER(c.c_int64), c.POINTER(c.c_int32)
        dp = c.POINTER(c.c_double)
        lib.paths_obj_load.restype = c.c_void_p
        lib.paths_obj_load.argtypes = [c.c_char_p, i64p]
        lib.paths_obj_model_info.restype = c.c_int
        lib.paths_obj_model_info.argtypes = [c.c_void_p, c.c_int64, i64p, i64p,
                                             i32p, i32p]
        lib.paths_obj_model_data.restype = c.c_int
        lib.paths_obj_model_data.argtypes = [c.c_void_p, c.c_int64, dp, i64p, dp, dp]
        lib.paths_obj_free.restype = None
        lib.paths_obj_free.argtypes = [c.c_void_p]
        lib.paths_ply_load.restype = c.c_void_p
        lib.paths_ply_load.argtypes = [c.c_char_p, i64p, i64p, i32p]
        lib.paths_ply_data.restype = c.c_int
        lib.paths_ply_data.argtypes = [c.c_void_p, dp, i64p, dp]
        lib.paths_ply_free.restype = None
        lib.paths_ply_free.argtypes = [c.c_void_p]
        _mesh = lib
    return _mesh


def _ptr(a, ctype):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctype))


def load_obj_native(path: str):
    """Parse an OBJ with the C++ parser (``csrc/mesh_io.cc``, port of
    ``paths_tpu/native/__init__.py::load_obj_native``): a list of dicts, one
    a model (vertices (V, 3) f64, faces (F, 3) i64, texcoords (V, 2) f64 or
    None, diffuse (3,) f64 or None), or None where the parser gives up (a
    file it cannot read), so that the caller parses it in Python.  A failed
    build raises."""
    lib = _mesh_lib()
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
    lib = _mesh_lib()
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


_tracer = None


def _tracer_lib() -> ctypes.CDLL:
    global _tracer
    if _tracer is None:
        lib = load_library("cpu_tracer.cc", cxx(), CXX_FLAGS)
        i, u64 = ctypes.c_int, ctypes.c_uint64
        p = ctypes.c_void_p
        # paths_cpu_render's arguments, in order (csrc/cpu_tracer.cc):
        # sizes and counts as int, the seed as uint64, every array a pointer.
        lib.paths_cpu_render.argtypes = (
            [i, i, i, u64, i, i, p]  # width .. max_bounces, cam17
            + [i, p, p, p]  # spheres
            + [i, p, p, p, p, p, p, p, p]  # triangles
            + [i, p, p, p, p, p, p, p, p]  # entities
            + [i, p, p, p, p, p, p]  # lights
            + [i, p, p, i, i, p]  # sky
            + [p])  # out
        lib.paths_cpu_render.restype = i
        _tracer = lib
    return _tracer


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
    lib = _tracer_lib()

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
