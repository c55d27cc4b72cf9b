"""The double-single ray/sphere test (``geom/sphere.intersect``) as one
launch a query: the closest hit over a range of the sphere table
(``closest``), the shadow test over its first spheres (``occludes``) and one
sphere per lane (``intersect``, the light's entry distance in NEE).

The integrator takes these for the big and far spheres of a scene, every
sphere of one with at most 32 small ones, and the sphere light's bound.
Each wrapper has a plain version in this module, the eager code of
``geom/sphere.py`` and ``math/ds.py``, unchanged, which runs on CPU tensors
(the tests' oracle, and the CPU's differentiable route).

On CUDA tensors every call launches ``csrc/sphere_ds.cu``, which does the
same float32 operations in the same order, so its t, hits, indices and
flags are the plain version's bit for bit: about 360 elementwise launches a
sphere become one launch a query.  It launches through ``native.launch``
(on the current stream, counted in ``profiling.LAUNCHES``; a launch
captured into a CUDA graph counts at its capture and at each replay),
checks only dtypes, shapes and devices, never reads a tensor on the host
and never falls back.  An empty range of spheres launches nothing.  Lane
keys (excl_idx, excl_ent) are int32, ``excl`` bool: whether the lane's
excluded primitive is a sphere.

There is no backward kernel, and only ``closest``'s t needs one: the
integrator places the hit at o + d t (``grad.py``: the double-single scans
stay differentiable).  Where grad mode is on and an input of ``closest``
requires grad, its t is recomputed at the chosen sphere by one plain test
on that sphere's row, gathered per lane: the same float32 operations, so
the forward stays bit for bit the kernel's and the gradient is the plain
scan's.  Such a call adds 1 to the count ``sphere_ds_eager``
(``profiling.count``, while a record is on).  ``occludes`` returns flags,
and ``intersect``'s t and hit only bound the shadow query that NEE makes,
so on the card their outputs carry no gradient.
"""

from __future__ import annotations

import torch

from paths_tpu_torch import native
from paths_tpu_torch import profiling as P
from paths_tpu_torch.geom import sphere as GS

BIG = GS.BIG

# Spheres per step of the plain closest-hit scan (bounds its (lanes,
# spheres) temporaries).
_SPH_STEP = 64


def closest_plain(o, d, center, radius, center_lo, lo: int, hi: int, excl, excl_idx,
                  t_best, i_best):
    """Closest hit among spheres [lo, hi) of the table (center (S, 3),
    radius (S,), center_lo (S, 3) or None) by the double-single test,
    merged into (t_best, i_best): a sphere wins where its t is strictly
    below the running best, the lowest index among equal t (the reference's
    unrolled per-sphere loop); a lane's sphere excl_idx is skipped where
    excl."""
    for a in range(lo, hi, _SPH_STEP):
        b = min(a + _SPH_STEP, hi)
        t, hit = GS.intersect(o[:, None, :], d[:, None, :],
                              center[None, a:b],
                              radius[None, a:b],
                              center_lo[None, a:b] if center_lo is not None else None)
        ids = torch.arange(a, b, dtype=torch.int32, device=o.device)
        ok = hit & ~(excl[:, None] & (excl_idx[:, None] == ids[None, :]))
        t = torch.where(ok, t, BIG)
        arg = torch.argmin(t, dim=1)
        tmin = torch.gather(t, 1, arg[:, None])[:, 0]
        better = tmin < t_best
        t_best = torch.where(better, tmin, t_best)
        i_best = torch.where(better, arg.to(torch.int32) + a, i_best)
    return t_best, i_best


def occludes_plain(o, d, center, radius, center_lo, ent, n_spheres: int, excl, excl_idx,
                   t_max, excl_ent, occ):
    """occ, or-ed per lane with whether one of spheres [0, n_spheres) of
    the table (entities ent (S,) int32) is hit at t < t_max, is not the
    lane's excluded sphere and its entity is not excl_ent."""
    for s in range(n_spheres):
        t, hit = GS.intersect(o, d, center[s], radius[s],
                              center_lo[s] if center_lo is not None else None)
        occ = occ | (hit & (t < t_max) & ~(excl & (excl_idx == s))
                     & (ent[s] != excl_ent))
    return occ


def intersect_plain(o, d, center, radius):
    """(t, hit) of each lane's ray against its own sphere (center (N, 3),
    radius (N,)); t = BIG on a miss."""
    return GS.intersect(o, d, center, radius)


def _card(x) -> bool:
    return x.device.type == "cuda"


def _needs_grad(*inputs) -> bool:
    """Whether grad mode is on and one of inputs requires grad."""
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                           for x in inputs)


def _differentiable_t(o, d, center, radius, center_lo, lo: int, t_best, t_out, i_out):
    """closest's t, recomputed where a sphere won (t_out < t_best: a
    sphere wins only strictly below the running best) by the plain test on
    that sphere's row, and t_best elsewhere."""
    won = t_out < t_best
    j = torch.where(won, i_out, lo).long()
    t, _ = GS.intersect(o, d, center[j], radius[j],
                        center_lo[j] if center_lo is not None else None)
    return torch.where(won, t, t_best)


def _lanes(o, d, lane_args):
    """The lanes (o, d made contiguous, each (name, x, dtype) of lane_args)
    checked on o's device; returns (o, d, the lane tensors, N)."""
    o, d = o.contiguous(), d.contiguous()
    xs = [x.contiguous() for _, x, _ in lane_args]
    dev, n = o.device, o.shape[0]
    native.check("o", o, torch.float32, (n, 3), dev)
    native.check("d", d, torch.float32, (n, 3), dev)
    for (name, _, dtype), x in zip(lane_args, xs):
        native.check(name, x, dtype, (n,), dev)
    if n >= 2 ** 31:
        raise ValueError("too many lanes for one launch")
    return o, d, xs, n


def _table(dev, center, radius, center_lo, ent=None) -> int:
    """The sphere table checked on the lanes' device; returns its rows."""
    s = center.shape[0]
    native.check("center", center, torch.float32, (s, 3), dev)
    native.check("radius", radius, torch.float32, (s,), dev)
    if center_lo is not None:
        native.check("center_lo", center_lo, torch.float32, (s, 3), dev)
    if ent is not None:
        native.check("ent", ent, torch.int32, (s,), dev)
    return s


def _range(lo: int, hi: int, rows: int) -> None:
    if not 0 <= lo <= hi <= rows:
        raise ValueError(f"spheres [{lo}, {hi}) outside a table of {rows}")


def closest(o, d, center, radius, center_lo, lo: int, hi: int, excl, excl_idx, t_best,
            i_best):
    """``closest_plain``'s (t_best, i_best): (N,) f32 and int32; o, d (N, 3)
    f32, excl (N,) bool, excl_idx (N,) int32.  t is differentiable where an
    input requires grad (``_differentiable_t``)."""
    if hi <= lo or not _card(o):
        return closest_plain(o, d, center, radius, center_lo, lo, hi, excl, excl_idx,
                             t_best, i_best)
    o, d, (excl, excl_idx, t_best, i_best), n = _lanes(o, d, (
        ("excl", excl, torch.bool), ("excl_idx", excl_idx, torch.int32),
        ("t_best", t_best, torch.float32), ("i_best", i_best, torch.int32)))
    _range(lo, hi, _table(o.device, center, radius, center_lo))
    t_out = torch.empty_like(t_best)
    i_out = torch.empty_like(i_best)
    if n:
        native.launch("sphere_ds_closest", "sphere_ds_closest", o.device, center,
                      center_lo, radius, lo, hi, o, d, excl, excl_idx, t_best, i_best, n,
                      t_out, i_out)
    if _needs_grad(o, d, center, radius, center_lo, t_best):
        P.count("sphere_ds_eager")
        t_out = _differentiable_t(o, d, center, radius, center_lo, lo, t_best, t_out, i_out)
    return t_out, i_out


def occludes(o, d, center, radius, center_lo, ent, n_spheres: int, excl, excl_idx, t_max,
             excl_ent, occ):
    """``occludes_plain``'s flags: (N,) bool; o, d (N, 3) f32, excl and occ
    (N,) bool, excl_idx and excl_ent (N,) int32, t_max (N,) f32."""
    if n_spheres <= 0 or not _card(o):
        return occludes_plain(o, d, center, radius, center_lo, ent, n_spheres, excl,
                              excl_idx, t_max, excl_ent, occ)
    o, d, (excl, excl_idx, t_max, excl_ent, occ), n = _lanes(o, d, (
        ("excl", excl, torch.bool), ("excl_idx", excl_idx, torch.int32),
        ("t_max", t_max, torch.float32), ("excl_ent", excl_ent, torch.int32),
        ("occ", occ, torch.bool)))
    _range(0, n_spheres, _table(o.device, center, radius, center_lo, ent))
    out = torch.empty_like(occ)
    if n:
        native.launch("sphere_ds_any_hit", "sphere_ds_any_hit", o.device, center,
                      center_lo, radius, ent, n_spheres, o, d, excl, excl_idx, t_max,
                      excl_ent, occ, n, out)
    return out


def intersect(o, d, center, radius):
    """``intersect_plain``'s (t, hit): (N,) f32 and bool; o, d and center
    (N, 3) f32, radius (N,) f32.  On the card they carry no gradient."""
    if not _card(o):
        return intersect_plain(o, d, center, radius)
    o, d, (radius,), n = _lanes(o, d, (("radius", radius, torch.float32),))
    center = center.contiguous()
    native.check("center", center, torch.float32, (n, 3), o.device)
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    hit = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        native.launch("sphere_ds_intersect", "sphere_ds_intersect", o.device, o, d, center,
                      radius, n, t, hit)
    return t, hit
