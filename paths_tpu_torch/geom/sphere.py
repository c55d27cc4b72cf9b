"""Ray/sphere intersection, vectorised and f32-stable (port of
``paths_tpu/geom/sphere.py``).

Reference: src/geom.rs:208-235 (f64 quadratic).  The discriminant and roots
are evaluated in double-single arithmetic (``math/ds.py``) so radius-1e6
ground spheres keep the scene's scale; a centre that float32 does not hold
(the ground at y -1000002.8) takes its low part too, so that the sphere
lies where the scene's float64 numbers put it.

Semantics matched to the reference:
  disc = (l.oc)^2 - oc.oc + r^2      (oc = o - c)
  miss if disc < 0
  d1 = -l.oc + sqrt(disc); d2 = -l.oc - sqrt(disc)
  miss if d1 < 0;  t = d2 if d2 > 0 else d1
  normal = normalize(location - c)   (no inside-flip)
"""

from __future__ import annotations

import torch

from paths_tpu_torch.math import ds
from paths_tpu_torch.math import vec

BIG = 3.4e38  # rounds to the f32 value 3.4e38 the reference uses


def intersect(o, d, center, radius, center_lo=None):
    """Batched ray/sphere test.  o, d: (..., 3); center (..., 3) and radius
    (...) broadcast against the rays; center_lo, shaped as center, is the
    centre's low part (the centre is center + center_lo), or None.  Returns
    (t, hit); t = BIG on a miss."""
    och, ocl = [], []
    for i in range(3):
        h, l = ds.two_sum(o[..., i], -center[..., i])
        if center_lo is not None:
            # A correction below ulp(h): left in the low word unnormalised,
            # as the products below take it to first order.
            l = l - center_lo[..., i]
        och.append(h)
        ocl.append(l)

    # b = d . oc in double-single.
    b = ds.ds(torch.zeros_like(och[0]))
    for i in range(3):
        p, e = ds.two_prod(d[..., i], och[i])
        b = ds.add(b, (p, e + d[..., i] * ocl[i]))

    # oc.oc in double-single (dropping the negligible lo*lo term).
    oc2 = ds.ds(torch.zeros_like(och[0]))
    for i in range(3):
        p, e = ds.two_prod(och[i], och[i])
        oc2 = ds.add(oc2, (p, e + 2.0 * och[i] * ocl[i]))

    r2 = ds.two_prod(radius, radius)

    disc = ds.add(ds.sub(ds.sqr(b), oc2), r2)
    disc_v = ds.to_f32(disc)

    # Lanes that miss take a zero discriminant, also where it is NaN (rays
    # from the integrator's DEAD_ORIGIN overflow b^2 and oc.oc): no NaN in
    # the forward that the backward would multiply by a zero gradient.
    valid = disc_v >= 0
    disc_safe = (torch.where(valid, torch.clamp_min(disc[0], 0.0), 0.0),
                 torch.where(valid, disc[1], 0.0))
    root = ds.sqrt(disc_safe)

    tmp = ds.neg(b)
    d1 = ds.to_f32(ds.add(tmp, root))
    d2 = ds.to_f32(ds.sub(tmp, root))

    hit = (disc_v >= 0.0) & (d1 >= 0.0)
    t = torch.where(d2 > 0.0, d2, d1)
    t = torch.where(hit, t, torch.full_like(t, BIG))
    return t, hit


def surface(o, d, t, center):
    """Hit location and outward normal (geom.rs:230-233)."""
    location = o + d * t[..., None]
    normal = vec.normalize_safe(location - center)
    return location, normal
