"""The traced run's profile: ``torch.profiler`` over a bounded first part of
the window, read from the profiler's raw events in memory.

No ``key_averages()`` (its event tree takes most of a minute on a few
seconds of this program) and no Chrome trace on disk.  From the raw events:

- the profiled span: the range ``portbench.profiled`` on the host;
- device events: kernels, copies and fills on the card, without the
  labelled ranges the profiler mirrors onto the device's timeline;
- busy seconds: the union of the device events' intervals in the span;
- the traversal kernels: those whose launch (a ``*LaunchKernel*`` runtime
  call, joined by correlation id) lies inside a ``portbench.traversal``
  range on the same host thread (``probes.py``);
- the breakdown: the device operations that took most time
  (``device_rows``), and the longest idle gaps of the card, summed by the
  innermost host range open at each gap's middle.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import NamedTuple

LABEL_PREFIXES = ("paths_tpu_torch.", "portbench.")
# Seconds of the window profiled: a few bounce iterations of every cell's
# work, read in seconds; the whole window's events would take minutes.
PROFILE_SECONDS = 3.0
TOP = 10
NAME = 160  # characters of a demangled kernel name kept in the breakdown


class DeviceRow(NamedTuple):
    """One name's device events in a profile, as a key_averages() row."""
    key: str
    count: int
    self_device_time_total: float  # microseconds


def is_label(key, user_annotation):
    """A labelled range (the program's profiling.labelled or the
    benchmark's), not an operator."""
    return user_annotation or key.startswith(LABEL_PREFIXES)


def device_rows(events) -> list:
    """The device-side rows of a profile (kernels, copies) with device time,
    one per name, without the labelled ranges on the device's timeline.
    Summed from raw events as key_averages() sums them (a copy of
    chip_smoke.py's, over this module's parsed events)."""
    rows = {}
    for e in events:
        n, us = rows.get(e.name, (0, 0.0))
        rows[e.name] = (n + 1, us + (e.end - e.start) / 1e3)
    return [DeviceRow(k, n, us) for k, (n, us) in rows.items() if us > 0]


class Ev(NamedTuple):
    name: str
    start: int  # ns
    end: int
    corr: int
    linked: int
    tid: int


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_ns(intervals, lo: int, hi: int) -> list:
    """(start, end) of the idle gaps between the intervals in [lo, hi)."""
    out, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(host: list, starts: list, t: int, reach: int = 256) -> str:
    """Name of the latest-starting host range open at t (host sorted by
    start, starts its start times)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if host[j].end >= t:
            return host[j].name
    return "host: no operator open"


@dataclass
class Parsed:
    window_s: float
    busy_s: float
    n_kernels: int
    traversal_device_s: float
    traversal_kernels: int
    breakdown: dict = field(default_factory=dict)


def parse(raw, is_cuda_event) -> Parsed | None:
    """Parses the raw events (``prof.profiler.kineto_results.events()``);
    None without a ``portbench.profiled`` range."""
    import torch

    dev, host, launches, trav = [], [], [], []
    span = None
    for e in raw:
        name = e.name()
        if is_cuda_event(e):
            if is_label(name, e.is_user_annotation()):
                continue
            s = e.start_ns()
            dev.append(Ev(torch._C._demangle(name), s, s + e.duration_ns(),
                          e.correlation_id(), e.linked_correlation_id(), 0))
            continue
        s = e.start_ns()
        ev = Ev(name, s, s + e.duration_ns(), e.correlation_id(),
                e.linked_correlation_id(), e.start_thread_id())
        if name == "portbench.profiled":
            span = ev
        elif name == "portbench.traversal":
            trav.append(ev)
        elif "LaunchKernel" in name or name.startswith("cuLaunch"):
            launches.append(ev)
        else:
            host.append(ev)
    if span is None:
        return None
    lo, hi = span.start, span.end
    dev = [e for e in dev if e.end > lo and e.start < hi]
    iv = [(e.start, e.end) for e in dev]
    busy = union_ns(iv, lo, hi)

    # Traversal kernels: launched inside a traversal range of the same thread.
    trav.sort(key=lambda e: e.start)
    t_starts = [e.start for e in trav]
    corr = set()
    for ln in launches:
        i = bisect.bisect_right(t_starts, ln.start) - 1
        if i >= 0 and trav[i].end >= ln.start and trav[i].tid == ln.tid:
            corr.add(ln.corr)
    tk = [e for e in dev if e.corr in corr or e.linked in corr]

    rows = sorted(device_rows(dev), key=lambda r: r.self_device_time_total, reverse=True)
    host.sort(key=lambda e: e.start)
    h_starts = [e.start for e in host]
    by_name = {}
    for s, e in gaps_ns(iv, lo, hi):
        key = innermost(host, h_starts, (s + e) // 2)
        by_name[key] = by_name.get(key, 0) + (e - s)
    gaps = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    return Parsed(
        window_s=(hi - lo) / 1e9, busy_s=busy / 1e9, n_kernels=len(kernels),
        traversal_device_s=sum(e.end - e.start for e in tk) / 1e9,
        traversal_kernels=len(tk),
        breakdown={
            "device_ops": [[r.key[:NAME], r.self_device_time_total / 1e6] for r in rows[:TOP]],
            "idle_gaps": [[k, v / 1e9] for k, v in gaps],
        })


class Window:
    """The profiler over the first `seconds` of a traced window: start()
    at the window's start; tick() after each unit of work ends the profiled
    part once it has run `seconds`; stop() at the window's end ends it if
    it is still on, then parses."""

    def __init__(self, seconds: float, device):
        self.seconds = seconds
        self.device = device
        self.active = False
        self.parsed = None
        self._raw = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._range = torch.profiler.record_function("portbench.profiled")
        self._range.__enter__()
        self._t = time.perf_counter()
        self.active = True

    def tick(self, ctx):
        if self.active and time.perf_counter() - self._t >= self.seconds:
            self._end(ctx)

    def _end(self, ctx):
        ctx.sync()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        self._raw = self._prof.profiler.kineto_results.events()

    def stop(self, ctx):
        import torch

        if self.active:
            self._end(ctx)
        if self._raw is not None:
            cuda = torch.autograd.DeviceType.CUDA
            self.parsed = parse(self._raw, lambda e: e.device_type() == cuda)
            self._raw = None
            self._prof = None


def idle_pct(parsed: Parsed | None):
    """The card's idle share of the profiled span in %, or None where no
    device event was read."""
    if parsed is None or parsed.busy_s <= 0 or parsed.window_s <= 0:
        return None
    return 100.0 * (1.0 - parsed.busy_s / parsed.window_s)
