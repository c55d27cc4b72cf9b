"""traversal_roofline_pct.render: the traversal kernels' share of their
roofline in %: the least bytes their queries must move (``roofline.py``,
summed over the traversal calls in the profiled span) over the card's
bandwidth, against the device time of the kernels launched under those
calls."""

from portbench import roofline


def read(obs):
    p = obs.profile
    if p is None or not p.traversal_kernels:
        return None
    return roofline.share_pct(obs.counts.get("traversal_bytes.profiled", 0),
                              p.traversal_device_s)
