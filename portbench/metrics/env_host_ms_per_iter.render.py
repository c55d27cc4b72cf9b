"""env_host_ms_per_iter.render: the host's milliseconds a bounce iteration
in the environment light: the program's ``paths_tpu_torch.env_nee`` spans
(``integrator.path_step``'s environment NEE, its shadow query's enqueue
included), summed over the window after the profiled part, over the
``paths_tpu_torch.path_step`` spans there (``spans.py``).  0 where the
scene runs no environment NEE (a sky that is no HDRI); None where the
program has no such span."""

from portbench import env_light as EL
from portbench import spans as S


def install(ctx):
    return S.install(ctx)


def read(obs):
    steps = S.after_profile(obs, "paths_tpu_torch.path_step")
    if not steps:
        return None
    envs = S.after_profile(obs, EL.ENV_NEE)
    if not envs:
        return 0.0 if obs.values.get(EL.ACTIVE) is False else None
    return sum(s.end_ns - s.start_ns for s in envs) / 1e6 / len(steps)
