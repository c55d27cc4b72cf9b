"""The benchmark's driver: finds a cell's configuration, traffic mix and
metrics by name, runs the set-up, the measured window and the check, and
assembles the result line.

Everything that belongs to one configuration, mix, kind of traffic or
per-layer metric sits in a file of its own, found by name:

- ``configs/<config>.json``: the scene as it is run (the upstream YAML
  schema held as JSON) with its source, ``reduced`` and ``assumed``;
- ``traffic/<mix>.json``: the mix's parameters, with ``kind`` naming its
  generator;
- ``kinds/<kind>.py``: the generator of a kind of traffic (``setup``,
  ``window``, ``check``; see ``kinds/render.py``);
- ``metrics/<metric>.py``: ``read(obs)`` of one per-layer metric, None
  where the run has nothing for it to read; optionally ``install(ctx)``,
  called before a traced window, which sets the metric's own probes and
  returns the functions that take them off;
- ``limits/<cell>.json``: the limit of each number the cell's check
  compares, with the readings it was set from.

The end-to-end metrics come from the host clock with tracing off.  A
``--trace 1`` run wraps the program's module attributes (``probes.py``),
profiles a bounded first part of the window (``devtrace.py``) and reports
the per-layer metrics instead.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# Top-level module names that must not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "paths_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def load_mix(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def load_limits(cell: str) -> dict:
    """The limit of each number a cell's check compares
    (``limits/<cell>.json``: {"limits": {name: limit}}, with the readings
    each was set from)."""
    return load_json(os.path.join(BENCH_DIR, "limits", f"{cell}.json"))["limits"]


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(kind: str):
    return _load_module(os.path.join(BENCH_DIR, "kinds", f"{kind}.py"),
                        f"portbench.kinds.{kind}")


def load_metric(name: str):
    return _load_module(os.path.join(BENCH_DIR, "metrics", f"{name}.py"),
                        "portbench.metrics." + name.replace(".", "_"))


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The metrics of `section` that `cell` reports: those whose
    ``workloads`` list it, or that have no such list."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``paths_tpu_torch`` is not ``paths_tpu``."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def p90(values) -> float:
    """The 90th percentile of all values (linear between order statistics,
    as statistics.quantiles(method="inclusive") puts it)."""
    import statistics

    return statistics.quantiles(values, n=10, method="inclusive")[8]


def parted_pct(a: np.ndarray, b: np.ndarray, tol: float = 1e-4) -> float:
    """% of pixels whose value parts from the reference's: the largest
    channel difference over tol times (the reference's largest channel +
    1e-3).  Rounding in the last bits stays under it; a sample traced along
    another path, or a pixel given another's samples, does not."""
    a = np.asarray(a, np.float64).reshape(-1, 3)
    b = np.asarray(b, np.float64).reshape(-1, 3)
    d = np.abs(a - b).max(axis=1)
    return float(100.0 * (d > tol * (np.abs(b).max(axis=1) + 1e-3)).mean())


def rel_mse(a: np.ndarray, b: np.ndarray) -> float:
    """Sum of squared differences over the reference's sum of squares."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-300))


@dataclass
class Obs:
    """What a run observed: values (one number each), counts, host spans
    (lists of seconds) and, in a traced run, the parsed profile.  After the
    window the harness adds the value "memory_peak_bytes" and the span
    "unit" (the seconds of each frame or step of the window)."""
    values: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    profile: object = None

    def count(self, key: str, n: float = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def span(self, key: str, seconds: float) -> None:
        self.spans.setdefault(key, []).append(seconds)


@dataclass
class Ctx:
    """One run's inputs and observations, handed to a kind's functions."""
    device: object
    config_name: str
    config: dict
    mix: dict
    seed: int
    obs: Obs = field(default_factory=Obs)
    profiler: object = None  # a devtrace.Window in a traced run

    @property
    def base_dir(self) -> str:
        """Where the scene's model files resolve: the configs folder (a
        test's own small configuration may name another)."""
        return self.config.get("base_dir") or os.path.join(BENCH_DIR, "configs")

    @property
    def size(self) -> tuple:
        cam = self.config["scene"]["camera"]
        return int(cam["image_width"]), int(cam["image_height"])

    def port_scene(self):
        """The program's (static, scene, camera) from the configuration's
        scene, by its own parser and build, timed as scene_build_s."""
        from paths_tpu_torch.scene.build import build_scene
        from paths_tpu_torch.scene.yaml_loader import parse_scene_dict

        t = time.perf_counter()
        sd = parse_scene_dict(self.config["scene"], base_dir=self.base_dir)
        out = build_scene(sd, device=self.device)
        self.sync()
        self.obs.values["scene_build_s"] = time.perf_counter() - t
        return out

    def ref_scene(self):
        from portbench.reference import scene as RS

        return RS.build(self.config["scene"], self.base_dir, self.device)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self) -> None:
        """Called after each unit of work: ends the profiled part of a
        traced window once it has run long enough."""
        if self.profiler is not None:
            self.profiler.tick(self)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device, t0: float, given: dict | None = None) -> dict:
    """One run of a cell on `device`: set-up, window, check.  Returns the
    result line's object (without the device's name, which main adds).
    `given` may hold a "config", "mix" or "limits" dictionary in place of
    the files the cell names (the tests' small cells)."""
    import torch

    from portbench import probes
    from portbench import devtrace as P

    cfg_name = cell["config"]
    given = given or {}
    ctx = Ctx(device=device, config_name=cfg_name,
              config=given.get("config") or load_config(cfg_name),
              mix=given.get("mix") or load_mix(cell["traffic"]), seed=seed)
    kind = load_kind(ctx.mix["kind"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = kind.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t0

    per_layer = cell_metrics(bench, cell["name"], "per_layer") if trace else []
    readers = [load_metric(m["name"]) for m in per_layer]
    undo = []
    if trace:
        undo += probes.install(ctx)
        for r in readers:
            if hasattr(r, "install"):
                undo += r.install(ctx)
        ctx.profiler = P.Window(P.PROFILE_SECONDS, device)
        ctx.profiler.start()
    try:
        out = kind.window(state, ctx, seconds)
        ctx.sync()
    finally:
        if trace:
            ctx.profiler.stop(ctx)
        for u in reversed(undo):  # the last set comes off first
            u()
    units = sorted(out.get("unit_s", []))
    if units:
        print(f"[window] {len(units)} units (frames or steps), seconds: min {units[0]:.4f}, "
              f"median {units[len(units) // 2]:.4f}, max {units[-1]:.4f}", file=sys.stderr)
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    ctx.obs.values["memory_peak_bytes"] = memory_peak
    ctx.obs.spans["unit"] = list(out.get("unit_s", []))
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    limits = given.get("limits") or load_limits(cell["name"])
    compared = {k: (float(v), float(limits[k])) for k, v in kind.check(out["records"], ctx).items()}
    correct = all(np.isfinite(v) and v <= lim for v, lim in compared.values())
    metrics = {}
    if trace:
        ctx.obs.profile = ctx.profiler.parsed
        for m, r in zip(per_layer, readers):
            v = r.read(ctx.obs)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = dict(out["metrics"], setup_s=setup_s)
        for m in cell_metrics(bench, cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": int(out["attempted"]),
        "failed": int(out.get("failed", 0)),
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "count": 1, "memory_peak_bytes": memory_peak},
    }
    if trace and ctx.obs.profile is not None:
        prof = ctx.obs.profile
        result["device"].update(busy_s=prof.busy_s, window_s=prof.window_s)
        result["breakdown"] = prof.breakdown
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    result["setup_s"] = setup_s
    return result


def main(root: str, workload: str, seed: int, seconds: float, trace: bool,
         t0: float) -> int:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        print(f"no workload {workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[workload]
    import torch

    t_import = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    torch.zeros(1, device=device)
    t_cuda = time.perf_counter()
    result = run_cell(bench, cell, seed, seconds, trace, device, t0)
    print(f"[setup] import {t_import - t0:.2f} s, CUDA init {t_cuda - t_import:.2f} s, "
          f"set-up in all {result.pop('setup_s'):.2f} s", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the run's process: {', '.join(bad)}", file=sys.stderr)
        return 3
    result["device"]["kind"] = torch.cuda.get_device_name(device)
    for k, c in result["compared"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        if not np.isfinite(c["value"]):
            c["value"] = None  # a NaN reading: strict JSON has no NaN
    print(json.dumps(result, allow_nan=False))
    return 0
