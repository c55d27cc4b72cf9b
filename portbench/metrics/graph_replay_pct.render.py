"""graph_replay_pct.render: the share in % of the shading step's stretch
runs that a CUDA graph replay served over the traced window: the program's
counts ``step_graph_replays`` over ``step_graph_replays`` +
``step_graph_captures`` + ``step_graph_eager`` (``profiling.count``, kept
by the program's recorder, which ``spans.py`` starts).  A program without
the counts reads None."""

from portbench import spans as S

KEYS = ("step_graph_replays", "step_graph_captures", "step_graph_eager")


def install(ctx):
    undo = S.install(ctx)
    try:
        from paths_tpu_torch import profiling
    except ImportError:
        return undo
    rec = getattr(profiling, "_record", None)
    if rec is not None:
        ctx.obs.program_counts = rec.counts  # filled as the window runs
    return undo


def read(obs):
    counts = getattr(obs, "program_counts", None) or {}
    runs = [counts.get(k, 0) for k in KEYS]
    if not sum(runs):
        return None
    return 100.0 * runs[0] / sum(runs)
