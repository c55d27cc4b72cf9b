"""live_lane_pct.render: the share in % of the regenerating wavefront's
lane-iterations that still carried a path over the traced window: the
program's counts ``wave_live_lane_iters`` over ``wave_lane_iters``, which
``render._all_done`` adds at each iteration's sync from the carry's retired
flags (``profiling.count``, kept by the program's recorder, which
``spans.py`` starts).  Retired lanes still run every kernel of the
iteration, so this is the share of the wave's work a lane needed.  A
program without the counts reads None."""

from portbench import harness

# The program's recorder counts, kept as the window runs: the same install
# as graph_replay_pct.render's.
install = harness.load_metric("graph_replay_pct.render").install


def read(obs):
    counts = getattr(obs, "program_counts", None) or {}
    total = counts.get("wave_lane_iters", 0)
    if not total:
        return None
    return 100.0 * counts.get("wave_live_lane_iters", 0) / total
