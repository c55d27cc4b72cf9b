"""The card's idle share of the profiled span in %: the span less the union
of the intervals of its device events (kernels, copies, fills), over the
span (``devtrace.py``)."""

from portbench import devtrace


def read(obs):
    return devtrace.idle_pct(obs.profile)
