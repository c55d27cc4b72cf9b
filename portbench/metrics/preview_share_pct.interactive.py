"""preview_share_pct.interactive: the host's time in preview dispatches in %
of all its dispatch time (the program's ``paths_tpu_torch.dispatch`` spans
around ``ProgressiveRenderer._dispatch``'s wave, with their ``preview``
attribute), over the window after the profiled span (``spans.py``)."""

from portbench import spans as S


def install(ctx):
    return S.install(ctx)


def read(obs):
    spans = S.after_profile(obs, "paths_tpu_torch.dispatch")
    if not spans:
        return None
    total = sum(s.end_ns - s.start_ns for s in spans)
    preview = sum(s.end_ns - s.start_ns for s in spans if s.attrs.get("preview"))
    return 100.0 * preview / total if total > 0 else None
