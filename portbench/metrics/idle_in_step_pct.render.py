"""idle_in_step_pct.render: the share in % of the card's idle time in the
profiled span during which the host was inside a
``paths_tpu_torch.path_step`` span (the program's range around each bounce
iteration's shading step): the idle gaps between the device's events,
intersected with those ranges, over all the gaps (``spans.py``)."""

from portbench import devtrace
from portbench import spans as S


def install(ctx):
    return S.install(ctx)


def read(obs):
    prog = S.program(obs)
    t = prog.trace if prog else None
    if t is None or not t.ranges.get("paths_tpu_torch.path_step") or not t.device:
        return None
    gaps = devtrace.gaps_ns([(e.start, e.end) for e in t.device], t.lo, t.hi)
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    steps = [(max(r.start, t.lo), min(r.end, t.hi)) for r in t.ranges["paths_tpu_torch.path_step"]]
    return 100.0 * S.overlap_ns(gaps, [(s, e) for s, e in steps if e > s]) / idle
