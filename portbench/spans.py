"""The program's own spans and counters in a traced run
(``paths_tpu_torch.profiling``), for the per-layer metrics that read them.

``install(ctx)``, once a run whichever metric calls it first:

- starts the program's span recorder (``profiling.record()``) for the
  window; its spans are kept in ``obs.program.spans`` when it stops;
- wraps ``devtrace.parse`` through its module attribute: the wrapper
  returns parse's result unchanged and keeps, from the same raw events, the
  profiled span, the program's ranges (``paths_tpu_torch.*``, host side),
  the kernel launches and the device's events, in ``obs.program.trace``.

The program's spans are stamped on the profiler's clock, so a span after the
profiled part is one that starts after ``trace.hi``.  A program without the
recorder installs nothing, and every reader reads None.  Nothing is written
to disk.
"""

from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass, field

from portbench import devtrace

PREFIX = "paths_tpu_torch."


@dataclass
class Trace:
    """The raw events' parts the program's readers need (times in ns)."""
    lo: int  # the profiled span
    hi: int
    ranges: dict = field(default_factory=dict)  # name -> [Ev], host, by start
    launches: list = field(default_factory=list)  # kernel launches, by start
    device: list = field(default_factory=list)  # device events, no labels


@dataclass
class Program:
    spans: list = field(default_factory=list)
    trace: Trace | None = None


def keep(raw, is_cuda_event) -> Trace | None:
    """The Trace of the raw events; None without a ``portbench.profiled``
    range (as ``devtrace.parse``)."""
    t = Trace(0, 0)
    span = None
    for e in raw:
        name = e.name()
        if is_cuda_event(e):
            if not devtrace.is_label(name, e.is_user_annotation()):
                s = e.start_ns()
                t.device.append(devtrace.Ev(name, s, s + e.duration_ns(), e.correlation_id(),
                                            e.linked_correlation_id(), 0))
            continue
        if name.startswith(PREFIX) or name == "portbench.profiled" or "LaunchKernel" in name \
                or name.startswith("cuLaunch"):
            s = e.start_ns()
            ev = devtrace.Ev(name, s, s + e.duration_ns(), e.correlation_id(),
                             e.linked_correlation_id(), e.start_thread_id())
            if name == "portbench.profiled":
                span = ev
            elif name.startswith(PREFIX):
                t.ranges.setdefault(name, []).append(ev)
            else:
                t.launches.append(ev)
    if span is None:
        return None
    t.lo, t.hi = span.start, span.end
    for evs in t.ranges.values():
        evs.sort(key=lambda e: e.start)
    t.launches.sort(key=lambda e: e.start)
    return t


def install(ctx) -> list:
    """Starts the recorder and wraps devtrace.parse, once a run; returns
    the functions that stop and unwrap them."""
    obs = ctx.obs
    if hasattr(obs, "program"):
        return []
    try:
        from paths_tpu_torch import profiling
        recording = profiling.record()
    except (ImportError, AttributeError):
        return []  # a program without its spans
    prog = obs.program = Program()
    rec = recording.__enter__()
    parse = devtrace.parse

    def kept(raw, is_cuda_event):
        prog.trace = keep(raw, is_cuda_event)
        return parse(raw, is_cuda_event)

    devtrace.parse = kept

    def stop():
        recording.__exit__(None, None, None)
        prog.spans = list(rec.spans)

    def unwrap():
        devtrace.parse = parse

    return [stop, unwrap]


def program(obs) -> Program | None:
    return getattr(obs, "program", None)


def after_profile(obs, name: str) -> list | None:
    """The recorded spans named `name` that start after the profiled part,
    or None where there is no profile or the program recorded nothing."""
    prog = program(obs)
    if prog is None or prog.trace is None:
        return None
    return [s for s in prog.spans if s.name == name and s.start_ns >= prog.trace.hi]


def launched_in(trace: Trace, ranges: list, same_thread: bool) -> set:
    """Correlation ids of the launches that start inside one of `ranges`
    (sorted by start, none inside another on its thread): on the range's
    own thread, or on any thread."""
    by_tid = {}
    for r in ranges:
        by_tid.setdefault(r.tid if same_thread else 0, []).append(r)
    starts = {tid: [r.start for r in rs] for tid, rs in by_tid.items()}
    corr = set()
    for ln in trace.launches:
        tid = ln.tid if same_thread else 0
        rs = by_tid.get(tid)
        if rs is None:
            continue
        i = bisect.bisect_right(starts[tid], ln.start) - 1
        if i >= 0 and rs[i].end >= ln.start:
            corr.add(ln.corr)
    return corr


def of_launches(trace: Trace, corr: set) -> list:
    """The device events of the launches with correlation ids `corr`."""
    return [e for e in trace.device if e.corr in corr or e.linked in corr]


def is_kernel(e) -> bool:
    return not e.name.startswith(("Memcpy", "Memset"))


def overlap_ns(a: list, b: list) -> int:
    """Length of the intersection of two lists of disjoint, sorted
    (start, end) intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def native_totals():
    """(seconds, builds) of the program's library loads so far, summed over
    its libraries, or None from a program without the totals."""
    try:
        from paths_tpu_torch import profiling
        secs, builds = profiling.NATIVE_LOAD_S, profiling.NATIVE_BUILDS
    except (ImportError, AttributeError):
        return None
    print(f"[native] library loads: {sum(secs.values()):.4f} s, "
          f"{sum(builds.values())} builds; by library: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in sorted(secs.items())), file=sys.stderr)
    return float(sum(secs.values())), int(sum(builds.values()))
