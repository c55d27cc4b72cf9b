"""backward_ms.grad: milliseconds per gradient step from the end of the
forward (a probe on ``grad.render_with_params`` synchronises there, in the
traced run only) to the end of the step (the backward and the update),
averaged over the window's steps."""


def read(obs):
    spans = obs.spans.get("backward")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
