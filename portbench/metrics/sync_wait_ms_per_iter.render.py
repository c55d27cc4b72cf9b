"""sync_wait_ms_per_iter.render: the host's milliseconds a bounce iteration
in ``render_samples``' test of whether every lane is done (the program's
``paths_tpu_torch.wavefront_sync`` spans: the reduction's launch and the
wait for the card), over the window after the profiled span: the spans'
total over the ``paths_tpu_torch.path_step`` spans there (``spans.py``)."""

from portbench import spans as S


def install(ctx):
    return S.install(ctx)


def read(obs):
    syncs = S.after_profile(obs, "paths_tpu_torch.wavefront_sync")
    steps = S.after_profile(obs, "paths_tpu_torch.path_step")
    if not syncs or not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in syncs) / 1e6 / len(steps)
