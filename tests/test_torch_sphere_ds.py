"""The double-single sphere test's wrappers (``ops/sphere_ds.py``) on the
CPU: on CPU tensors each returns exactly what the integrator's eager code
returned before it called them (``frozen_path_step.py``'s scan, its
per-sphere shadow loop and its light test), empty ranges included; their
kernel route, driven on CPU tensors with the launch stubbed, refuses a wrong
dtype, shape, device or range and passes the launch what the kernel takes;
under grad mode an input of the closest-hit query that requires grad has its
t recomputed by the plain test at the chosen sphere, counted as
``sphere_ds_eager``, with today's gradient, while the shadow test and the
light's bound launch regardless.
The kernel itself is held to the plain versions on the card
(``test_torch_cuda.py``).
"""

import re
import types
from pathlib import Path

import pytest
import torch

import frozen_path_step as FROZEN
from paths_tpu_torch import native
from paths_tpu_torch import profiling as P
from paths_tpu_torch.geom import sphere as GS
from paths_tpu_torch.math import ds
from paths_tpu_torch.ops import sphere_ds as SD
from sphere_ds_cases import make_case, same

torch.set_num_threads(2)


def _frozen_scan(c, lo, hi, excl_kind):
    static = types.SimpleNamespace(sph_lo=c.center_lo is not None)
    scene = types.SimpleNamespace(sph_center=c.center, sph_radius=c.radius,
                                  sph_center_lo=c.center_lo)
    return FROZEN._scan_spheres(static, scene, lo, hi, c.o, c.d, excl_kind, c.excl_idx,
                                c.t_best, c.i_best)


def _frozen_shadow_loop(c, n_scan, excl_s):
    """The per-sphere loop of the integrator's occluded_query before the
    wrapper (frozen_path_step.occluded_query)."""
    occ = c.occ
    for s in range(n_scan):
        t, hit = GS.intersect(c.o, c.d, c.center[s], c.radius[s],
                              c.center_lo[s] if c.center_lo is not None else None)
        occ = occ | (hit & (t < c.t_max) & ~(excl_s & (c.excl_idx == s))
                     & (c.ent[s] != c.excl_ent))
    return occ


def _excl_kind(c):
    """Lanes whose excluded primitive is a sphere (kind 1) where c.excl,
    else a triangle (2) or none (0)."""
    other = torch.where(torch.arange(c.o.shape[0]) % 2 == 0, 0, 2).to(torch.int32)
    return torch.where(c.excl, 1, other).to(torch.int32)


RANGES = list(dict.fromkeys((n, lo, hi) for n in (0, 1, 2, 7, 32, 70)
                            for lo, hi in ((0, n), (min(1, n), n), (n // 2, n // 2))))


@pytest.mark.parametrize("with_lo", [True, False])
@pytest.mark.parametrize("n,lo,hi", RANGES)
def test_closest_on_cpu_is_the_frozen_scan(n, lo, hi, with_lo):
    c = make_case(n, seed=n + lo, with_lo=with_lo)
    kind = _excl_kind(c)
    got = SD.closest(c.o, c.d, c.center, c.radius, c.center_lo, lo, hi, kind == 1,
                     c.excl_idx, c.t_best, c.i_best)
    want = _frozen_scan(c, lo, hi, kind)
    assert same(got[0], want[0]) and same(got[1], want[1])
    if hi > lo:
        assert int((got[1] != c.i_best).sum()) > 0


@pytest.mark.parametrize("with_lo", [True, False])
@pytest.mark.parametrize("n", [0, 1, 2, 7, 32])
def test_occludes_on_cpu_is_the_frozen_loop(n, with_lo):
    c = make_case(n, seed=10 + n, with_lo=with_lo)
    for n_scan in sorted({0, min(1, n), n}):
        got = SD.occludes(c.o, c.d, c.center, c.radius, c.center_lo, c.ent, n_scan,
                          c.excl, c.excl_idx, c.t_max, c.excl_ent, c.occ)
        assert same(got, _frozen_shadow_loop(c, n_scan, c.excl))
    if n:
        assert int((got & ~c.occ).sum()) > 0


def test_intersect_on_cpu_is_the_light_test():
    c = make_case(7, seed=3)
    got = SD.intersect(c.o, c.d, c.lane_center, c.lane_radius)
    want = GS.intersect(c.o, c.d, c.lane_center, c.lane_radius)
    assert same(got[0], want[0]) and same(got[1], want[1])
    assert 0 < int(got[1].sum()) < c.o.shape[0]


def test_the_ground_is_where_its_float64_centre_puts_it():
    """The low part moves the ground's hit: a ray straight down from y 1
    meets it at 3.8 with the low part, about a centimetre off without."""
    c = make_case(1, n_lanes=4)
    o = torch.tensor([[0.3, 1.0, -0.7]] * 4)
    d = torch.tensor([[0.0, -1.0, 0.0]] * 4)
    lanes = (torch.zeros(4, dtype=torch.bool), torch.zeros(4, dtype=torch.int32),
             torch.full((4,), SD.BIG), torch.zeros(4, dtype=torch.int32))
    t_lo = SD.closest(o, d, c.center, c.radius, c.center_lo, 0, 1, *lanes)[0]
    t_f32 = SD.closest(o, d, c.center, c.radius, None, 0, 1, *lanes)[0]
    assert abs(float(t_lo[0]) - 3.8) < 1e-5 < 1e-3 < abs(float(t_f32[0]) - 3.8)


def _emulate(entry, args):
    """Write what kernel `entry` writes into its outputs, from the plain
    versions (the card tests hold the kernel to them bit for bit)."""
    with torch.no_grad():
        if entry == "sphere_ds_closest":
            center, center_lo, radius, lo, hi, o, d, excl, excl_idx, t_in, i_in, _, t, i = args
            want = SD.closest_plain(o, d, center, radius, center_lo, lo, hi, excl, excl_idx,
                                    t_in, i_in)
            t.copy_(want[0])
            i.copy_(want[1])
        elif entry == "sphere_ds_any_hit":
            center, center_lo, radius, ent, n_spheres, o, d, excl, excl_idx, t_max, \
                excl_ent, occ, _, out = args
            out.copy_(SD.occludes_plain(o, d, center, radius, center_lo, ent, n_spheres,
                                        excl, excl_idx, t_max, excl_ent, occ))
        else:
            o, d, center, radius, _, t, hit = args
            want = SD.intersect_plain(o, d, center, radius)
            t.copy_(want[0])
            hit.copy_(want[1])


@pytest.fixture
def kernel_route(monkeypatch):
    """The kernel route on CPU tensors: every tensor counts as on the card
    and native.launch is a stub that records its calls and writes the
    kernel's outputs from the plain versions."""
    calls = []

    def launch(entry, key, device, *args):
        calls.append((entry, key, device, args))
        _emulate(entry, args)

    monkeypatch.setattr(SD, "_card", lambda x: True)
    monkeypatch.setattr(native, "launch", launch)
    return calls


def test_kernel_route_launches_what_the_kernels_take(kernel_route):
    c = make_case(7, n_lanes=64)
    n = c.o.shape[0]
    t, i = SD.closest(c.o, c.d, c.center, c.radius, c.center_lo, 1, 7, c.excl, c.excl_idx,
                      c.t_best, c.i_best)
    occ = SD.occludes(c.o, c.d, c.center, c.radius, None, c.ent, 7, c.excl, c.excl_idx,
                      c.t_max, c.excl_ent, c.occ)
    tl, hl = SD.intersect(c.o, c.d, c.lane_center, c.lane_radius)
    assert [(e, k) for e, k, _, _ in kernel_route] == [
        ("sphere_ds_closest", "sphere_ds_closest"), ("sphere_ds_any_hit", "sphere_ds_any_hit"),
        ("sphere_ds_intersect", "sphere_ds_intersect")]
    for (_, _, _, args), entry in zip(kernel_route, ("sphere_ds_closest", "sphere_ds_any_hit",
                                                     "sphere_ds_intersect")):
        assert len(args) == len(native.LIBRARIES["sphere_ds.cu"].entries[entry].argtypes) - 1
    a = kernel_route[0][3]
    assert a[0] is c.center and a[1] is c.center_lo and a[2] is c.radius and a[3:5] == (1, 7)
    assert a[5] is c.o and a[7] is c.excl and a[9] is c.t_best and a[11] == n
    assert a[12] is t and a[13] is i and t.dtype == torch.float32 and i.dtype == torch.int32
    a = kernel_route[1][3]
    assert a[1] is None and a[3] is c.ent and a[4] == 7 and a[11] is c.occ
    assert a[13] is occ and occ.dtype == torch.bool and occ.shape == (n,)
    a = kernel_route[2][3]
    assert a[2] is c.lane_center and a[4] == n and a[5] is tl and a[6] is hl
    assert hl.dtype == torch.bool


def test_kernel_route_launches_nothing_for_no_spheres(kernel_route):
    c = make_case(7, n_lanes=64)
    t, i = SD.closest(c.o, c.d, c.center, c.radius, c.center_lo, 3, 3, c.excl, c.excl_idx,
                      c.t_best, c.i_best)
    occ = SD.occludes(c.o, c.d, c.center, c.radius, c.center_lo, c.ent, 0, c.excl,
                      c.excl_idx, c.t_max, c.excl_ent, c.occ)
    assert kernel_route == [] and t is c.t_best and i is c.i_best and occ is c.occ


def _call(query, c, **changed):
    """The wrapper `query` on case c, with the arguments named in changed
    replaced by changed[name](c)."""
    args = {
        "closest": dict(o=c.o, d=c.d, center=c.center, radius=c.radius,
                        center_lo=c.center_lo, lo=0, hi=7, excl=c.excl, excl_idx=c.excl_idx,
                        t_best=c.t_best, i_best=c.i_best),
        "occludes": dict(o=c.o, d=c.d, center=c.center, radius=c.radius,
                         center_lo=c.center_lo, ent=c.ent, n_spheres=7, excl=c.excl,
                         excl_idx=c.excl_idx, t_max=c.t_max, excl_ent=c.excl_ent, occ=c.occ),
        "intersect": dict(o=c.o, d=c.d, center=c.lane_center, radius=c.lane_radius),
    }[query]
    args.update({k: f(c) for k, f in changed.items()})
    return getattr(SD, query)(**args)


def _meta(x):
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


REFUSALS = [
    ("closest", "excl_idx", lambda c: c.excl_idx.long(), TypeError),
    ("closest", "o", lambda c: c.o.double(), TypeError),
    ("closest", "excl", lambda c: c.excl.int(), TypeError),
    ("closest", "center_lo", lambda c: c.center_lo.double(), TypeError),
    ("closest", "t_best", lambda c: c.t_best[:-1], ValueError),
    ("closest", "d", lambda c: c.d[:, :2], ValueError),
    ("closest", "center", lambda c: _meta(c.center), ValueError),
    ("closest", "hi", lambda c: 8, ValueError),
    ("closest", "lo", lambda c: -1, ValueError),
    ("occludes", "excl_ent", lambda c: c.excl_ent.long(), TypeError),
    ("occludes", "ent", lambda c: c.ent.long(), TypeError),
    ("occludes", "occ", lambda c: c.occ.int(), TypeError),
    ("occludes", "radius", lambda c: c.radius[:-1], ValueError),
    ("occludes", "n_spheres", lambda c: 8, ValueError),
    ("intersect", "radius", lambda c: c.lane_radius.double(), TypeError),
    ("intersect", "center", lambda c: c.lane_center[:-1], ValueError),
    ("intersect", "center", lambda c: _meta(c.lane_center), ValueError),
]


@pytest.mark.parametrize("query,name,bad,exc", REFUSALS,
                         ids=[f"{q}-{n}-{i}" for i, (q, n, _, _) in enumerate(REFUSALS)])
def test_kernel_route_refuses_what_the_kernel_does_not_take(kernel_route, query, name, bad,
                                                            exc):
    c = make_case(7, n_lanes=64)
    _call(query, c)  # the same call with good arguments launches
    with pytest.raises(exc):
        _call(query, c, **{name: bad})
    assert len(kernel_route) == 1


@pytest.mark.parametrize("which", ["o", "d", "center", "t_best"])
def test_an_input_that_requires_grad_takes_the_plain_route(kernel_route, which):
    """Under grad mode an input that requires grad still launches the
    kernel for (t, index); t is then recomputed by the plain test at the
    chosen sphere, counted once: bit for bit the frozen scan's t, with its
    gradient.  Under no_grad the same call launches and is not counted."""
    c = make_case(7, n_lanes=256)
    kind = _excl_kind(c)
    leaf = getattr(c, which).clone().requires_grad_()
    c_g = c._replace(**{which: leaf})
    with P.record() as rec:
        t, i = SD.closest(c_g.o, c_g.d, c_g.center, c_g.radius, c_g.center_lo, 0, 7,
                          kind == 1, c.excl_idx, c_g.t_best, c.i_best)
    assert len(kernel_route) == 1 and rec.counts == {"sphere_ds_eager": 1}
    (g,) = torch.autograd.grad(torch.where(t < SD.BIG, t, 0.0).sum(), leaf)
    leaf_w = getattr(c, which).clone().requires_grad_()
    t_w, i_w = _frozen_scan(c._replace(**{which: leaf_w}), 0, 7, kind)
    (g_w,) = torch.autograd.grad(torch.where(t_w < SD.BIG, t_w, 0.0).sum(), leaf_w)
    assert same(t.detach(), t_w.detach()) and same(i, i_w)
    if which == "center":
        # A sphere's gradient sums its lanes' through a gather here and a
        # broadcast there: the same terms, added in another order.
        torch.testing.assert_close(g, g_w, rtol=1e-6, atol=1e-6 * float(g_w.abs().max()))
    else:
        assert same(g, g_w)
    if which != "t_best":
        assert float(g.abs().sum()) > 0
    with P.record() as rec, torch.no_grad():
        t_n, _ = SD.closest(c_g.o, c_g.d, c_g.center, c_g.radius, c_g.center_lo, 0, 7,
                            kind == 1, c.excl_idx, c_g.t_best, c.i_best)
    assert len(kernel_route) == 2 and rec.counts == {} and same(t_n, t_w.detach())


def test_shadow_and_light_calls_that_require_grad_take_the_plain_route(kernel_route):
    """The shadow test and the light's bound launch whatever requires grad,
    uncounted: their flags and bound carry no gradient on the card."""
    c = make_case(7, n_lanes=256)
    o = c.o.clone().requires_grad_()
    with P.record() as rec:
        occ = SD.occludes(o, c.d, c.center, c.radius, c.center_lo, c.ent, 7, c.excl,
                          c.excl_idx, c.t_max, c.excl_ent, c.occ)
        t, hit = SD.intersect(c.o, c.d, c.lane_center.clone().requires_grad_(),
                              c.lane_radius)
    assert [e for e, _, _, _ in kernel_route] == ["sphere_ds_any_hit", "sphere_ds_intersect"]
    assert rec.counts == {}
    assert same(occ, _frozen_shadow_loop(c, 7, c.excl))
    want = GS.intersect(c.o, c.d, c.lane_center, c.lane_radius)
    assert same(t, want[0]) and same(hit, want[1]) and not t.requires_grad


def test_cpu_calls_that_require_grad_are_plain_and_uncounted():
    """On the CPU every call is plain; the count is the card's."""
    c = make_case(2, n_lanes=64)
    with P.record() as rec:
        t, _ = SD.intersect(c.o.clone().requires_grad_(), c.d, c.lane_center, c.lane_radius)
    assert rec.counts == {} and t.requires_grad


def test_kernel_holds_the_plain_constants():
    """The splitter and BIG in csrc/sphere_ds.cu are math/ds.py's and
    geom/sphere.py's, so a drift on one side fails without a card."""
    src = (Path(SD.__file__).parents[1] / "csrc" / "sphere_ds.cu").read_text()
    big = re.search(r"kBig = ([0-9.e+]+)f;", src).group(1)
    split = re.search(r"kSplitter = ([0-9.]+)f;", src).group(1)
    f32 = lambda x: torch.tensor(float(x), dtype=torch.float32)
    assert same(f32(big), f32(GS.BIG)) and float(split) == ds._SPLITTER
