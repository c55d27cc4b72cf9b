"""ds_device_pct.render: the double-single sphere tests' share in % of the
card's profiled device time: the device time of ``csrc/sphere_ds.cu``'s
kernels (closest hit, any hit, one sphere a lane), whose names all begin
with ``sphere_ds_``, matched in the device rows (``devtrace.device_rows``),
over the summed time of every device event in the profiled span.  By name,
because they run inside the shading step's CUDA graph replays, whose
kernels no launch call joins to a span.  None without device events, or
where none of the kernels ran (stress-500's spheres take no double-single
test)."""

from __future__ import annotations

from portbench import devtrace
from portbench import spans as S

PREFIX = "sphere_ds_"  # every __global__ of sphere_ds.cu, and no other source's

install = S.install  # keeps the profile's device events (spans.py)


def read(obs):
    prog = S.program(obs)
    t = prog.trace if prog else None
    if t is None:
        return None
    events = [e for e in t.device if e.end > t.lo and e.start < t.hi]
    rows = devtrace.device_rows(events)
    total = sum(r.self_device_time_total for r in rows)
    ds = sum(r.self_device_time_total for r in rows if PREFIX in r.key)
    if total <= 0 or ds <= 0:
        return None
    return 100.0 * ds / total

