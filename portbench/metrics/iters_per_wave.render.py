"""iters_per_wave.render: bounce iterations per ``render_samples`` call
over the traced window (calls of ``integrator.path_step`` over calls of
``render.render_samples``, counted by probes).  Each iteration is one host
synchronisation of the regenerating wavefront."""


def read(obs):
    waves = obs.counts.get("render_samples", 0)
    if not waves:
        return None
    return obs.counts.get("path_step", 0) / waves
