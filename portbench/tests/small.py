"""Small cells for the CPU tests: the benchmark's configurations cut to a
size a test run holds, run through the harness on the CPU with the
program's plain versions of its kernels."""

from __future__ import annotations

import copy
import os
import time

import numpy as np

from portbench import harness

# The end-to-end metric of each kind of traffic.
E2E = {"render": ("pixel_samples_per_s", "pixel-samples/s"), "grad": ("grad_step_s", "s"),
       "interactive": ("frame_ms_p90", "ms")}


def bench_for(kind: str, per_layer=()) -> dict:
    name, unit = E2E[kind]
    return {"workloads": [], "per_layer": list(per_layer),
            "end_to_end": [{"name": name, "unit": unit}, {"name": "setup_s", "unit": "s"}]}


def small_stress(n_spheres: int = 40, size=(48, 32)) -> dict:
    """stress500's first n_spheres spheres (more than 32: the walk route)
    at a small size."""
    cfg = copy.deepcopy(harness.load_config("stress500"))
    cfg["scene"]["objects"] = cfg["scene"]["objects"][:n_spheres]
    cfg["scene"]["camera"].update(image_width=size[0], image_height=size[1])
    return cfg


def write_grid_ply(path: str, n: int = 9, seed: int = 3) -> None:
    """A bumpy n x n vertex grid, 2 (n-1)^2 triangles, with random uchar
    vertex colours, as a binary PLY like doom's."""
    r = np.random.default_rng(seed)
    xs = np.linspace(-200.0, 200.0, n)
    x, z = np.meshgrid(xs, xs, indexing="ij")
    y = 30.0 * np.sin(x / 60.0) * np.cos(z / 50.0)
    v = np.zeros(n * n, [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                         ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    v["x"], v["y"], v["z"] = x.ravel(), y.ravel(), z.ravel()
    for c in ("red", "green", "blue"):
        v[c] = r.integers(0, 256, n * n)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = i * n + j, (i + 1) * n + j, i * n + j + 1, (i + 1) * n + j + 1
            faces += [(a, b, c), (c, b, d)]
    f = np.zeros(len(faces), [("n", "u1"), ("i", "<i4", (3,))])
    f["n"], f["i"] = 3, faces
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n * n}\nproperty float x\nproperty float y\n"
              "property float z\nproperty uchar red\nproperty uchar green\n"
              f"property uchar blue\nelement face {len(faces)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as fh:
        fh.write(header.encode() + v.tobytes() + f.tobytes())


def small_mesh(tmpdir: str, size=(32, 24)) -> dict:
    """doom's scene (its camera, light, ground sphere and material) with a
    128-triangle grid (more than 64: the kernel route) in place of the
    96k-triangle mesh."""
    write_grid_ply(os.path.join(tmpdir, "grid.ply"))
    cfg = copy.deepcopy(harness.load_config("doom"))
    cfg["scene"]["models"] = {"doom": {"file": "grid.ply"}}
    cfg["scene"]["camera"].update(image_width=size[0], image_height=size[1])
    cfg["base_dir"] = tmpdir
    return cfg


def run(config: dict, mix: dict, limits: dict, seed: int = 1234567890123,
        seconds: float = 0.5, trace: bool = False, bench=None, name: str = "small") -> dict:
    """One run on the CPU of a cell named `name` with the given
    configuration, mix and limits."""
    import torch

    cell = {"name": name, "config": config.get("name", "small"), "traffic": mix["kind"],
            "chips": 1}
    return harness.run_cell(bench or bench_for(mix["kind"]), cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), given=dict(config=config, mix=mix,
                                                            limits=limits))
