"""Builds the port's native sources (``csrc/``) at first use and loads them
with ``ctypes``: the CUDA kernels with ``nvcc`` for ``sm_90a``, and the host
C++ BVH builder with ``g++``.

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
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "paths_tpu_torch"

# -fmad=false: nvcc contracts no multiply-add on its own; the kernels issue
# exactly the fused multiply-adds their contract names, as fmaf.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
# The reference's flags for its native BVH builder (paths_tpu/native/Makefile);
# ISO C++17 keeps GCC from contracting multiply-adds.
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
        raise RuntimeError("no C++ compiler (g++) found: the BVH builder "
                           "cannot be built")
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
    verbose prints the compiler's messages (``-Xptxas=-v`` for nvcc)."""
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
    return ctypes.CDLL(str(so))
