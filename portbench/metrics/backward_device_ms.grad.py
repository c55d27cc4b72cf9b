"""backward_device_ms.grad: the device's milliseconds a gradient step in the
backward's kernels: kernels launched from any thread (autograd launches from
its own) while a ``paths_tpu_torch.grad_backward`` span (the program's,
around ``torch.autograd.grad``) is open, over the spans in the profiled
span (``spans.py``)."""

from portbench import spans as S


def install(ctx):
    return S.install(ctx)


def read(obs):
    prog = S.program(obs)
    t = prog.trace if prog else None
    if t is None:
        return None
    steps = [r for r in t.ranges.get("paths_tpu_torch.grad_backward", [])
             if r.start >= t.lo and r.end <= t.hi]
    if not steps:
        return None
    kernels = [e for e in S.of_launches(t, S.launched_in(t, steps, same_thread=False))
               if S.is_kernel(e)]
    if not kernels:
        return None
    return sum(e.end - e.start for e in kernels) / 1e6 / len(steps)
