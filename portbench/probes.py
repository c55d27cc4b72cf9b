"""Wrappers that a traced run sets on the program's module attributes, and
takes off again after the window: the counters and host spans that the
per-layer metrics read.  The program calls each of these through its
module (``I.path_step``, ``ST.closest_hit_spheres``, ...), so a wrapper on
the attribute sees every call.

- ``integrator.path_step``: counts bounce iterations ("path_step"; while
  the profiler runs also "path_step.profiled"), and outside the profiled
  part the host's time inside each call ("path_step" span: the enqueue of
  one iteration, nothing synchronises in it);
- ``render.render_samples``: counts waves ("render_samples") and ends the
  profiled part once it has run long enough;
- the traversal wrappers of ``ops/``: while the profiler runs, a range
  ``portbench.traversal`` around each call and the least bytes the call
  must move (``roofline.py``) in "traversal_bytes.profiled";
- ``grad.render_with_params``: synchronises after the forward and keeps
  its end, so the grad mix can time the backward;
- ``ProgressiveRenderer._dispatch`` and ``.pump``: lane-samples sent, and
  those dropped as stale when collected.
"""

from __future__ import annotations

import functools
import time

from portbench import roofline

# (module, attribute, bytes per lane) of every traversal wrapper.
TRAVERSAL = (
    ("paths_tpu_torch.ops.sphere_traverse", "closest_hit_spheres", roofline.CLOSEST_HIT_BYTES),
    ("paths_tpu_torch.ops.sphere_traverse", "occludes_spheres", roofline.ANY_HIT_BYTES),
    ("paths_tpu_torch.ops.tri_traverse", "closest_hit_tris", roofline.CLOSEST_HIT_BYTES),
    ("paths_tpu_torch.ops.tri_traverse", "occludes_tris", roofline.ANY_HIT_BYTES),
    ("paths_tpu_torch.ops.packet_traverse", "closest_hit_packet", roofline.CLOSEST_HIT_BYTES),
    ("paths_tpu_torch.ops.chunk_scan", "flat_closest_hit", roofline.CLOSEST_HIT_BYTES),
    ("paths_tpu_torch.ops.chunk_scan", "flat_occludes", roofline.ANY_HIT_BYTES),
)


def _patch(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    return lambda: setattr(obj, name, orig)


def _lanes(args) -> int:
    """Lanes of a traversal call: the first (N, 3) tensor argument."""
    for a in args:
        if getattr(a, "dim", None) and a.dim() == 2 and a.shape[-1] == 3:
            return int(a.shape[0])
    raise ValueError("a traversal call without (N, 3) rays")


def install(ctx) -> list:
    """Sets every wrapper; returns the functions that take them off."""
    import importlib

    import torch

    from paths_tpu_torch import grad, integrator, render
    from paths_tpu_torch.progressive import ProgressiveRenderer

    obs = ctx.obs
    profiling = lambda: ctx.profiler is not None and ctx.profiler.active
    undo = []

    def step(orig):
        @functools.wraps(orig)
        def call(*args, **kwargs):
            obs.count("path_step")
            if profiling():
                obs.count("path_step.profiled")
                return orig(*args, **kwargs)
            t = time.perf_counter()
            out = orig(*args, **kwargs)
            obs.span("path_step", time.perf_counter() - t)
            return out
        return call

    def wave(orig):
        @functools.wraps(orig)
        def call(*args, **kwargs):
            out = orig(*args, **kwargs)
            obs.count("render_samples")
            ctx.tick()
            return out
        return call

    def traversal(orig, per_lane):
        @functools.wraps(orig)
        def call(*args, **kwargs):
            if not profiling():
                return orig(*args, **kwargs)
            obs.count("traversal_bytes.profiled", per_lane * _lanes(args))
            with torch.profiler.record_function("portbench.traversal"):
                return orig(*args, **kwargs)
        return call

    def forward(orig):
        @functools.wraps(orig)
        def call(*args, **kwargs):
            out = orig(*args, **kwargs)
            ctx.sync()
            obs.values["forward_end"] = time.perf_counter()
            return out
        return call

    def dispatch(orig):
        @functools.wraps(orig)
        def call(self):
            rec = orig(self)
            obs.count("sent_lane_samples", rec[3].shape[0] * rec[2])
            return rec
        return call

    def pump(orig):
        @functools.wraps(orig)
        def call(self):
            pending = self._pending
            out = orig(self)
            if pending is not None and pending[0] != self.epoch:
                obs.count("stale_lane_samples", pending[3].shape[0] * pending[2])
            return out
        return call

    undo.append(_patch(integrator, "path_step", step))
    undo.append(_patch(render, "render_samples", wave))
    undo.append(_patch(grad, "render_with_params", forward))
    undo.append(_patch(ProgressiveRenderer, "_dispatch", dispatch))
    undo.append(_patch(ProgressiveRenderer, "pump", pump))
    for mod, name, per_lane in TRAVERSAL:
        undo.append(_patch(importlib.import_module(mod), name,
                           lambda orig, b=per_lane: traversal(orig, b)))
    return undo
