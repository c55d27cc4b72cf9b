"""The readers of the program's own spans (``spans.py`` and the metrics
that use it) on synthetic raw events, built as test_portbench_arith.py
builds them: the idle gaps put down to a range opened long before, launches
from autograd's thread inside the backward's span, the hash's launches by
thread, the spans after the profiled part, and devtrace.parse unchanged by
the wrapper."""

import types

import pytest

from portbench import devtrace, harness
from portbench import spans as S
from portbench.tests.test_portbench_arith import FakeEvent


def _ctx():
    return types.SimpleNamespace(obs=harness.Obs())


def _parsed(events, ctx):
    """devtrace.parse through the helper's wrapper, as Window.stop calls
    it; the helper installed and taken off again around it."""
    undo = S.install(ctx)
    try:
        return devtrace.parse(events, lambda e: e.cuda)
    finally:
        for u in reversed(undo):
            u()


def _read(metric, obs):
    return harness.load_metric(metric).read(obs)


def _events():
    """A profiled span of 0..100,000 ns: a path_step range opened at 100,
    then 10,000 host operators, two kernels with an idle gap of 20,000 ns
    inside the range and one outside it."""
    ev = [FakeEvent("portbench.profiled", 0, 100_000, ua=True),
          FakeEvent("paths_tpu_torch.path_step", 100, 59_900, ua=True)]
    ev += [FakeEvent("aten::add", 200 + 5 * i, 4) for i in range(10_000)]
    ev += [FakeEvent("cudaLaunchKernel", 150, 5, corr=1),
           FakeEvent("add_kernel", 0, 30_000, cuda=True, corr=1),
           FakeEvent("cudaLaunchKernel", 50_300, 5, corr=2),
           FakeEvent("mul_kernel", 50_000, 20_000, cuda=True, corr=2),
           FakeEvent("paths_tpu_torch.path_step", 1, 1, cuda=True, ua=True)]
    return ev


def test_gap_put_down_to_a_range_opened_long_before():
    ctx = _ctx()
    p = _parsed(_events(), ctx)
    # Idle: 30,000-50,000 inside the range, 70,000-100,000 after it.
    assert devtrace.idle_pct(p) == pytest.approx(50.0)
    assert _read("idle_in_step_pct.render", ctx.obs) == pytest.approx(40.0)
    # devtrace's own search reaches 256 events back and misses the range.
    assert "paths_tpu_torch.path_step" not in dict(p.breakdown["idle_gaps"])


def test_parse_unchanged_by_the_wrapper():
    plain = devtrace.parse(_events(), lambda e: e.cuda)
    ctx = _ctx()
    assert _parsed(_events(), ctx) == plain
    assert devtrace.parse is not None and ctx.obs.program.trace.hi == 100_000
    assert _parsed(_events()[1:], _ctx()) is None


def test_installs_once_and_comes_off():
    ctx = _ctx()
    parse = devtrace.parse
    undo = S.install(ctx)
    assert devtrace.parse is not parse and S.install(ctx) == [] and S.install(ctx) == []
    for u in reversed(undo):
        u()
    assert devtrace.parse is parse


def test_backward_counts_launches_of_any_thread():
    ev = [FakeEvent("portbench.profiled", 0, 10_000, ua=True),
          FakeEvent("paths_tpu_torch.grad_backward", 1_000, 3_000, ua=True, tid=1),
          FakeEvent("paths_tpu_torch.grad_backward", 6_000, 3_000, ua=True, tid=1),
          FakeEvent("cudaLaunchKernel", 1_500, 5, corr=1, tid=7),  # autograd's thread
          FakeEvent("index_backward", 2_000, 400, cuda=True, corr=1),
          FakeEvent("cudaLaunchKernel", 2_500, 5, corr=2, tid=1),
          FakeEvent("mul_kernel", 3_000, 200, cuda=True, corr=2),
          FakeEvent("cudaLaunchKernel", 5_000, 5, corr=3, tid=1),  # the forward
          FakeEvent("fwd_kernel", 5_000, 900, cuda=True, corr=3),
          FakeEvent("cudaLaunchKernel", 6_500, 5, corr=4, tid=7),
          FakeEvent("index_backward", 7_000, 600, cuda=True, corr=4)]
    ctx = _ctx()
    _parsed(ev, ctx)
    assert _read("backward_device_ms.grad", ctx.obs) == pytest.approx((400 + 200 + 600) / 2 / 1e6)


def test_rng_share_counts_the_launching_thread():
    ev = [FakeEvent("portbench.profiled", 0, 10_000, ua=True),
          FakeEvent("paths_tpu_torch.rng", 1_000, 1_000, ua=True, tid=1),
          FakeEvent("cudaLaunchKernel", 1_100, 5, corr=1, tid=1),
          FakeEvent("xor_kernel", 1_200, 10, cuda=True, corr=1),
          FakeEvent("cudaLaunchKernel", 1_200, 5, corr=2, tid=2),  # another thread
          FakeEvent("copy_kernel", 1_300, 10, cuda=True, corr=2),
          FakeEvent("cudaLaunchKernel", 3_000, 5, corr=3, tid=1),
          FakeEvent("where_kernel", 3_100, 10, cuda=True, corr=3),
          FakeEvent("cudaLaunchKernel", 1_900, 5, corr=4, tid=1),
          FakeEvent("Memset (Device)", 2_000, 10, cuda=True, corr=4)]
    ctx = _ctx()
    _parsed(ev, ctx)
    assert _read("rng_launch_pct.render", ctx.obs) == pytest.approx(100.0 / 3)


def test_spans_after_the_profiled_part():
    from paths_tpu_torch.profiling import Span

    ctx = _ctx()
    _parsed(_events(), ctx)
    sp = lambda name, s, e, **a: Span(name, s, e, None, None, a)
    ctx.obs.program.spans = [
        sp("paths_tpu_torch.wavefront_sync", 50_000, 90_000),  # in the profiled part
        sp("paths_tpu_torch.path_step", 100_000, 3_000_000),
        sp("paths_tpu_torch.wavefront_sync", 3_000_000, 3_500_000),
        sp("paths_tpu_torch.path_step", 3_500_000, 6_000_000),
        sp("paths_tpu_torch.wavefront_sync", 6_000_000, 7_500_000),
        sp("paths_tpu_torch.dispatch", 50_000, 80_000, preview=True),
        sp("paths_tpu_torch.dispatch", 200_000, 1_200_000, preview=True),
        sp("paths_tpu_torch.dispatch", 1_200_000, 4_200_000, preview=False)]
    assert _read("sync_wait_ms_per_iter.render", ctx.obs) == pytest.approx(1.0)
    assert _read("preview_share_pct.interactive", ctx.obs) == pytest.approx(25.0)


def test_overlap_of_interval_lists():
    assert S.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert S.overlap_ns([(0, 10)], [(10, 20)]) == 0
    assert S.overlap_ns([], [(0, 5)]) == 0


def test_native_load_read_at_install():
    from paths_tpu_torch import profiling

    ctx = _ctx()
    harness.load_metric("native_load_s").install(ctx)
    assert _read("native_load_s", ctx.obs) == pytest.approx(sum(profiling.NATIVE_LOAD_S.values()))
    assert ctx.obs.values["native_builds"] == sum(profiling.NATIVE_BUILDS.values())
