"""What the environment light's metrics read of a traced run: the device
time of the kernels launched inside the program's
``paths_tpu_torch.env_nee`` spans (``integrator.path_step``'s environment
NEE: ``sky.sample_env``, the unbounded shadow query, the colour update),
and whether the run's scene let environment NEE run at all
(``spans.py``).  A program without the span reads None."""

from __future__ import annotations

from portbench import spans as S

ENV_NEE = "paths_tpu_torch.env_nee"
# obs.values key: the scene runs environment NEE (env_nee on an HDRI sky),
# set by the render_env kind's set-up.
ACTIVE = "env_nee_active"


def profiled_device(obs):
    """(ns of the kernels launched inside env_nee ranges, matched to their
    launch by correlation id alone, ns of every device event) in the
    profiled span; None without env_nee ranges or device events."""
    prog = S.program(obs)
    t = prog.trace if prog else None
    if t is None or not t.ranges.get(ENV_NEE):
        return None
    events = [e for e in t.device if e.end > t.lo and e.start < t.hi]
    if not events:
        return None
    corr = S.launched_in(t, t.ranges[ENV_NEE], same_thread=True)
    env = sum(e.end - e.start for e in events if e.corr in corr and S.is_kernel(e))
    return env, sum(e.end - e.start for e in events)
