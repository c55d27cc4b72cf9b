"""Profiling and timing utilities (port of ``paths_tpu/profiling.py``).

  - ``trace(logdir)``: a ``torch.profiler`` trace of the host's operators
    and, on ``cuda``, the card's kernels and copies, written into `logdir`
    as a Chrome trace (chrome://tracing, Perfetto);
  - ``time_jitted``: the median wall-clock seconds of a call, with the
    card synchronized after the warm-up and after every call;
  - ``RayCounter``: rays/s accounting with the reference's counting unit
    (one ray == one pixel-sample delivered, renderer.rs:101);
  - ``labelled``: names each call of a function as a range in a trace
    (``render.render_samples`` and ``render_wave`` carry one).
"""

from __future__ import annotations

import contextlib
import functools
import os
import statistics
import time

import torch

from paths_tpu_torch import resolve_device


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the scope: the host's operators and, when `device` is
    ``cuda`` (the default unless ``cpu`` is asked for), the card's
    activity.  Yields the ``torch.profiler.profile`` (its
    ``key_averages()`` sum the scope by operator and kernel) and writes
    ``<logdir>/paths_tpu_torch_<pid>.pt.trace.json`` on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, acc_events=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"paths_tpu_torch_{os.getpid()}.pt.trace.json"))


def labelled(name: str):
    """Decorator: each call of the function is a range named `name` in a
    profiler trace (a few microseconds a call when no profiler runs)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_jitted(fn, *args, reps: int = 5, warmup: int = 1, **kwargs) -> float:
    """Median seconds per call of ``fn(*args, **kwargs)``.  The port has no
    jit: the name is the reference's.  PyTorch returns before the card is
    done, so the card (when CUDA is in use) is synchronized after the
    warm-up and after every timed call."""
    for _ in range(max(warmup, 1)):
        fn(*args, **kwargs)
    _sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


class RayCounter:
    """Rays/s over a sliding window, printed like main.rs:107-112."""

    def __init__(self):
        self.t0 = time.monotonic()
        self.total = 0
        self._last_print = self.t0
        self._last_total = 0

    def add(self, n: int):
        self.total += n

    def line(self, width: int, height: int) -> str:
        now = time.monotonic()
        dt = max(now - self._last_print, 1e-9)
        rate = (self.total - self._last_total) / dt
        self._last_print = now
        self._last_total = self.total
        elapsed = now - self.t0
        per_pixel = self.total / (width * height)
        return (
            f"[{elapsed:8.2f}] rays: {self.total} ({per_pixel:.1f}/px), "
            f"{rate:.3g} rays/s"
        )
