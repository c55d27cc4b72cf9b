"""The port's tracing: spans, units of work, counters and the profiler's
trace (port of ``paths_tpu/profiling.py``).

  - ``span(name, **attrs)``: a named range of the host's time, as a context
    manager or a decorator.  While a ``torch.profiler`` runs it is a
    ``record_function`` range (in ``trace``'s Chrome trace and the
    profiler's raw events); while ``record()`` is on it is appended to the
    record.  With both off it costs a flag test.  Names start with
    ``paths_tpu_torch.``;
  - ``unit()``: a unit of work (a wave of ``render_samples``, a step of
    ``grad.loss_and_grad``, a dispatch of ``ProgressiveRenderer``); the
    spans inside carry its id.  A unit inside another belongs to the outer;
  - ``record()``: records the spans, and the counts ``count`` adds, of its
    scope, in memory;
  - ``LAUNCHES``: always-on counts of kernels run, by the keys
    ``native.LIBRARIES`` declares; ``native.launch`` adds each launch
    (``launched``), logged inside ``launch_log()`` so that a CUDA graph's
    replays count what its capture launched; ``reset_launches()``;
  - ``NATIVE_LOAD_S`` and ``NATIVE_BUILDS``: always-on totals, by library,
    of ``native.load_library``'s seconds and compiles;
  - ``trace(logdir)``: the CLI's ``--profile``, a Chrome trace on disk.

A span is stamped with ``time.time_ns()``, the Unix-epoch nanoseconds of the
profiler's own host events, so a span and the device's trace share a clock:
the range is entered before the start is stamped and left after the end is.
The recorder is the process's, and spans nest on the thread that renders.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from dataclasses import dataclass, field

import torch

from paths_tpu_torch import resolve_device

# Always-on totals by library (the source's file name): seconds in
# native.load_library (hashing the sources, a compile, dlopen) and compiles.
NATIVE_LOAD_S: dict = {}
NATIVE_BUILDS: dict = {}
# Always on: kernels run by launch key since the last reset_launches(); the
# keys are native.LIBRARIES', filled in when native is imported.
LAUNCHES: dict = {}

_profiler_enabled = torch._C._autograd._profiler_enabled
_record = None  # the Record being filled, or None
_launch_log = None  # the open launch_log()'s list, or None


@dataclass(slots=True)
class Span:
    """One recorded span: times in Unix-epoch ns (end 0 while open), the
    index of its parent in the record's spans, its unit of work's id."""
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    unit: int | None
    attrs: dict


@dataclass
class Record:
    """What ``record()`` collects: the spans in the order they opened, and
    the counts."""
    spans: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)
    open: list = field(default_factory=list)  # indices of the open spans
    unit: int | None = None  # the open unit of work's id
    units: int = 0


@contextlib.contextmanager
def record():
    """Records the spans and counts of the scope; yields the Record, whose
    lists fill as the scope runs."""
    global _record
    if _record is not None:
        raise RuntimeError("a record is already on")
    _record = rec = Record()
    try:
        yield rec
    finally:
        _record = None


def count(key: str, n: int = 1) -> None:
    """Adds n to the record's count `key`; nothing when no record is on."""
    if _record is not None:
        _record.counts[key] = _record.counts.get(key, 0) + n


def launched(key: str) -> None:
    """Counts one kernel launch in ``LAUNCHES[key]``.  Inside
    ``launch_log()`` the launch is also logged, so that whoever captured it
    into a CUDA graph counts it again at each replay (``step_graphs.py``):
    the counts stay kernels run."""
    LAUNCHES[key] += 1
    if _launch_log is not None:
        _launch_log.append(key)


def reset_launches() -> None:
    """Sets every count of ``LAUNCHES`` to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def launch_log():
    """Logs the keys of the launches that ``launched`` counts in the
    scope; yields the list."""
    global _launch_log
    outer, _launch_log = _launch_log, []
    try:
        yield _launch_log
    finally:
        _launch_log = outer


class span:
    """A named range of the host's time: ``with span(name, **attrs):`` or
    ``@span(name)``."""

    __slots__ = ("name", "attrs", "_rec", "_i", "_range")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._rec = self._range = None

    def __enter__(self):
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        rec = self._rec = _record
        if rec is not None:
            self._i = len(rec.spans)
            rec.spans.append(Span(self.name, time.time_ns(), 0,
                                  rec.open[-1] if rec.open else None, rec.unit, self.attrs))
            rec.open.append(self._i)
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is not None:
            rec.spans[self._i].end_ns = time.time_ns()
            rec.open.pop()
            self._rec = None
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _record is None and not _profiler_enabled():
                return fn(*args, **kwargs)
            with span(name, **attrs):
                return fn(*args, **kwargs)

        return call


class unit:
    """A unit of work for the spans inside: ``with unit():`` or
    ``@unit()``.  Opens a new id while recording, unless a unit is open."""

    __slots__ = ("_rec",)

    def __enter__(self):
        rec = self._rec = _record
        if rec is not None:
            if rec.unit is None:
                rec.unit, rec.units = rec.units, rec.units + 1
            else:
                self._rec = None  # the outer unit's
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec.unit = None
            self._rec = None
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _record is None:
                return fn(*args, **kwargs)
            with unit():
                return fn(*args, **kwargs)

        return call


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
