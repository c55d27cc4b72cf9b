"""launches_per_iter.render: device kernels in the profiled span (raw
profiler events) per ``integrator.path_step`` call made in it."""


def read(obs):
    iters = obs.counts.get("path_step.profiled", 0)
    if obs.profile is None or not iters or not obs.profile.n_kernels:
        return None
    return obs.profile.n_kernels / iters
