"""stale_pct.interactive: lane-samples that ``ProgressiveRenderer._dispatch``
sent and that were dropped as stale when collected (the camera moved while
the wave was in flight), in % of all sent over the traced window."""


def read(obs):
    sent = obs.counts.get("sent_lane_samples", 0)
    if not sent:
        return None
    return 100.0 * obs.counts.get("stale_lane_samples", 0) / sent
