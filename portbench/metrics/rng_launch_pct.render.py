"""rng_launch_pct.render: the counter-based hash's share of the device's
kernels in %: kernels launched while a ``paths_tpu_torch.rng`` span (the
program's: each uniform draw of ``integrator.lane_uniforms``, the camera
regeneration's hash and CMJ) is open on the launching thread, over every
kernel of the profiled span (``spans.py``)."""

from portbench import spans as S


def install(ctx):
    return S.install(ctx)


def read(obs):
    prog = S.program(obs)
    t = prog.trace if prog else None
    if t is None or not t.ranges.get("paths_tpu_torch.rng"):
        return None
    kernels = [e for e in t.device if S.is_kernel(e) and e.end > t.lo and e.start < t.hi]
    if not kernels:
        return None
    corr = S.launched_in(t, t.ranges["paths_tpu_torch.rng"], same_thread=True)
    rng = [e for e in kernels if e.corr in corr or e.linked in corr]
    return 100.0 * len(rng) / len(kernels)
