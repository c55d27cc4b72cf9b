"""Sphere tables and lanes for the double-single sphere test's wrappers
(``paths_tpu_torch/ops/sphere_ds.py``), shared by the CPU tests and the card
tests; imports no JAX.

A table of n spheres: a radius-1e6 ground whose float64 centre (y
-1000002.8) float32 does not hold (its low part in ``center_lo``), small
spheres, and sphere 2 an exact copy of sphere 1 (equal t: the lower index
wins).  Lanes: rays aimed at the spheres, random rays, rays from inside a
sphere, rays grazing a sphere (the discriminant within rounding of 0) and
dead lanes at the integrator's DEAD_ORIGIN (a NaN discriminant); random
exclusions, seeds, bounds and flags.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BIG = 3.4e38
DEAD_ORIGIN = 1e30
GROUND_Y = -1000002.8


class Case(NamedTuple):
    center: torch.Tensor  # (S, 3) f32
    radius: torch.Tensor  # (S,) f32
    center_lo: torch.Tensor | None  # (S, 3) f32 or None
    ent: torch.Tensor  # (S,) int32
    o: torch.Tensor  # (N, 3) f32
    d: torch.Tensor  # (N, 3) f32
    excl: torch.Tensor  # (N,) bool
    excl_idx: torch.Tensor  # (N,) int32
    t_best: torch.Tensor  # (N,) f32
    i_best: torch.Tensor  # (N,) int32
    t_max: torch.Tensor  # (N,) f32
    excl_ent: torch.Tensor  # (N,) int32
    occ: torch.Tensor  # (N,) bool
    lane_center: torch.Tensor  # (N, 3) f32: a sphere's centre for each lane
    lane_radius: torch.Tensor  # (N,) f32

    def to(self, device):
        return Case(*(None if x is None else x.to(device) for x in self))


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def make_case(n_spheres: int, n_lanes: int = 2048, seed: int = 0,
              with_lo: bool = True) -> Case:
    """A table of n_spheres and n_lanes lanes on the CPU."""
    g = np.random.default_rng(seed)
    c64 = np.concatenate([g.uniform(-6, 6, (n_spheres, 1)), g.uniform(0.3, 4, (n_spheres, 1)),
                          g.uniform(-6, 6, (n_spheres, 1))], axis=1)
    r64 = g.uniform(0.2, 1.8, n_spheres)
    if n_spheres:
        c64[0], r64[0] = (0.3, GROUND_Y, -0.7), 1e6
    if n_spheres >= 3:
        c64[2], r64[2] = c64[1], r64[1]
    c32 = c64.astype(np.float32)
    lo = np.where((r64 > 1e3)[:, None], c64 - c32, 0.0).astype(np.float32)
    ent = (np.arange(n_spheres) % 3).astype(np.int32)

    o = np.stack([g.uniform(-9, 9, n_lanes), g.uniform(0.1, 6, n_lanes),
                  g.uniform(-9, 9, n_lanes)], axis=1)
    d = _unit(g.normal(size=(n_lanes, 3)))
    if n_spheres:
        aim = g.integers(0, n_spheres, n_lanes)
        target = np.where((r64[aim] > 1e3)[:, None],
                          np.stack([o[:, 0], np.full(n_lanes, -3.0), o[:, 2]], 1),
                          c64[aim] + g.normal(scale=0.5, size=(n_lanes, 3)) * r64[aim, None])
        half = g.uniform(size=n_lanes) < 0.5
        d[half] = _unit(target - o)[half]
        small = np.nonzero(r64 < 1e3)[0]
        k = n_lanes // 8
        if len(small):
            # From inside a small sphere.
            s = g.choice(small, k)
            o[:k] = c64[s] + _unit(g.normal(size=(k, 3))) * r64[s, None] * 0.5
            # Grazing: the ray passes at the sphere's radius from its centre.
            s = g.choice(small, k)
            dd = _unit(g.normal(size=(k, 3)))
            p = _unit(np.cross(dd, g.normal(size=(k, 3))))
            o[k:2 * k] = c64[s] + p * r64[s, None] - dd * g.uniform(2, 20, (k, 1))
            d[k:2 * k] = dd
    o[2 * (n_lanes // 8)::13] = DEAD_ORIGIN
    rows = max(n_spheres, 1)
    excl = g.uniform(size=n_lanes) < 0.3
    excl_idx = g.integers(0, rows, n_lanes)
    t_best = np.where(g.uniform(size=n_lanes) < 0.7, BIG, g.uniform(0, 30, n_lanes))
    i_best = g.integers(0, 100, n_lanes)
    t_max = np.where(g.uniform(size=n_lanes) < 0.2, BIG, g.uniform(0, 40, n_lanes))
    excl_ent = g.integers(-1, 3, n_lanes)
    occ = g.uniform(size=n_lanes) < 0.1
    li = g.integers(0, rows, n_lanes)
    lane_c = c32[li] if n_spheres else np.zeros((n_lanes, 3), np.float32)
    lane_r = r64[li] if n_spheres else np.ones(n_lanes)

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    return Case(
        f32(c32).reshape(n_spheres, 3), f32(r64), f32(lo).reshape(n_spheres, 3) if with_lo
        else None, i32(ent), f32(o), f32(d), torch.as_tensor(excl), i32(excl_idx),
        f32(t_best), i32(i_best), f32(t_max), i32(excl_ent), torch.as_tensor(occ),
        f32(lane_c), f32(lane_r))


def same(a, b) -> bool:
    """Bit for bit, NaNs included."""
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)
