"""host_ms_per_iter.render: the host's milliseconds inside each
``integrator.path_step`` call, outside the profiled span: the enqueue of one
bounce iteration (nothing in it synchronises), averaged over the calls."""


def read(obs):
    spans = obs.spans.get("path_step")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
