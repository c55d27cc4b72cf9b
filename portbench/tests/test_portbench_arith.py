"""The benchmark's arithmetic on synthetic inputs: the percentile, the
comparison numbers, the union of device intervals and the idle gaps, the
parsing of raw profiler events, and the lane-I/O byte count."""

import numpy as np
import pytest

from portbench import devtrace, harness, inputs, roofline


def test_p90_of_all_values():
    assert harness.p90(list(range(1, 11))) == pytest.approx(9.1)
    vals = [5.0] * 90 + [100.0] * 10
    assert harness.p90(vals) == pytest.approx(14.5)


def test_rel_mse_and_parted():
    b = np.ones((4, 5, 3))
    assert harness.rel_mse(b, b) == 0.0
    a = b.copy()
    a[0, 0] = 2.0
    assert harness.rel_mse(a, b) == pytest.approx(3.0 / 60.0)
    assert harness.parted_pct(a, b) == pytest.approx(5.0)
    a = b * (1 + 1e-6)
    assert harness.parted_pct(a, b) == 0.0


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (35, 36), (100, 120)]
    assert devtrace.union_ns(iv, 0, 110) == 20 + 10 + 10
    assert devtrace.gaps_ns(iv, 0, 110) == [(20, 30), (40, 100)]
    assert devtrace.union_ns([], 0, 10) == 0
    assert devtrace.gaps_ns([], 0, 10) == [(0, 10)]


class FakeEvent:
    def __init__(self, name, start, dur, cuda=False, corr=0, tid=1, ua=False):
        self._n, self._s, self._d, self.cuda = name, start, dur, cuda
        self._c, self._t, self._u = corr, tid, ua

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._u


def test_parse_raw_events():
    ev = [
        FakeEvent("portbench.profiled", 0, 1000, ua=True),
        FakeEvent("aten::mul", 0, 100),
        FakeEvent("cudaLaunchKernel", 10, 5, corr=1),
        FakeEvent("mul_kernel", 50, 100, cuda=True, corr=1),
        FakeEvent("portbench.traversal", 200, 100, ua=True),
        FakeEvent("cudaLaunchKernel", 210, 5, corr=2),
        FakeEvent("walk_kernel", 400, 200, cuda=True, corr=2),
        FakeEvent("paths_tpu_torch.render_samples", 0, 900, cuda=True, ua=True),
        FakeEvent("aten::where", 700, 250),
        FakeEvent("Memcpy DtoH", 900, 50, cuda=True, corr=3),
    ]
    p = devtrace.parse(ev, lambda e: e.cuda)
    assert p.window_s == pytest.approx(1e-6)
    assert p.busy_s == pytest.approx(350e-9)
    assert p.n_kernels == 2
    assert p.traversal_kernels == 1 and p.traversal_device_s == pytest.approx(200e-9)
    assert devtrace.idle_pct(p) == pytest.approx(65.0)
    ops = dict(p.breakdown["device_ops"])
    assert set(ops) == {"mul_kernel", "walk_kernel", "Memcpy DtoH"}
    gaps = dict(p.breakdown["idle_gaps"])
    assert gaps["aten::where"] == pytest.approx(300e-9)  # 600..900
    assert sum(gaps.values()) == pytest.approx(650e-9)
    assert devtrace.parse(ev[1:], lambda e: e.cuda) is None


def test_lane_io_bytes():
    assert roofline.CLOSEST_HIT_BYTES == 44 and roofline.ANY_HIT_BYTES == 37
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)
    assert roofline.share_pct(3.35e9, 2e-3) == pytest.approx(50.0)
    assert roofline.share_pct(1, 0.0) is None


def test_probe_lanes_from_shapes():
    import torch

    from portbench import probes

    o = torch.zeros(1234, 3)
    assert probes._lanes((None, 7, o, o, torch.zeros(1234))) == 1234


def test_inputs_are_seeded():
    assert inputs.stream_seed(2**40 + 3, 5) == inputs.stream_seed(2**40 + 3, 5)
    assert inputs.stream_seed(2**40 + 3, 5) != inputs.stream_seed(2**40 + 3, 6)
    t1 = inputs.grad_target(9, 12, 8, (3, 4), 0.5)
    assert t1.shape == (96, 3) and (t1 >= 0).all() and (t1 < 0.5).all()
    assert np.array_equal(t1, inputs.grad_target(9, 12, 8, (3, 4), 0.5))
    order = inputs.tiled_pixel_order(70, 40)
    assert sorted(order.tolist()) == list(range(2800))
    pid, sid = inputs.grad_batch(order, 2, 1000)
    assert pid.tolist() == order[np.arange(2000, 3000) % 2800].tolist()
    assert sid.tolist() == [0] * 800 + [1] * 200


def test_flycam_script_same_spells_every_seed():
    from portbench.reference import matrix as RM

    mix = harness.load_mix("interactive")
    eye = np.eye(3)
    loc = np.array([0.0, -5.0, -13.0])
    runs = [inputs.flycam_script(s, mix, eye, loc, RM.rotation, 400) for s in (1, 2**33 + 7)]
    moving = [sum(a is not None for a in r[:sum(mix["still_frames"]) + sum(mix["move_frames"])])
              for r in runs]
    assert moving[0] == moving[1] == sum(mix["move_frames"])
    assert runs[0] != runs[1]
    lo, hi = (np.array(b) for b in mix["bounds"])
    for script in runs:
        p, o = loc.copy(), eye.copy()
        for a in script:
            if a and a[0] == "move":
                p = p + o @ a[1]
            elif a:
                o = o @ RM.rotation(*a[1])
            assert (p >= lo).all() and (p <= hi).all()


def test_flycam_script_is_a_prefix_of_a_longer_one():
    from portbench.reference import matrix as RM

    mix = harness.load_mix("interactive")
    loc = np.array([0.0, -5.0, -13.0])
    short = inputs.flycam_script(2**40 + 3, mix, np.eye(3), loc, RM.rotation, 97)
    long = inputs.flycam_script(2**40 + 3, mix, np.eye(3), loc, RM.rotation, 500)
    assert len(short) == 97 and len(long) == 500
    assert [repr(a) for a in short] == [repr(a) for a in long[:97]]
