"""The yardstick of the traversal kernels' roofline share: the least bytes
any implementation of a ray query must move, over the card's published
memory bandwidth.

A query reads each lane's inputs once and writes its outputs once:

- closest hit: origin and direction (2 x 12 B), the excluded primitive
  (4 B) and t_init (4 B) in; t, primitive and entity (3 x 4 B) out;
- any hit: origin and direction (2 x 12 B), the excluded primitive and
  entity (2 x 4 B) and t_max (4 B) in; one byte occluded out.

The scene's tables are not counted: the part of them a query needs depends
on the data and on the hierarchy that walks them.  So the bound reads the
same work whatever implements the query, and cannot pass the time the card
took.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB: HBM3 at 3.35 TB/s (the data sheet's figure, at
# the card's full power limit of 700 W).
HBM_BYTES_PER_S = 3.35e12

CLOSEST_HIT_BYTES = 2 * 12 + 4 + 4 + 3 * 4
ANY_HIT_BYTES = 2 * 12 + 2 * 4 + 4 + 1


def bound_s(total_bytes: float) -> float:
    """The least seconds the card needs to move total_bytes."""
    return total_bytes / HBM_BYTES_PER_S


def share_pct(total_bytes: float, device_s: float):
    """The roofline share in %, or None where no device time was read."""
    if device_s <= 0:
        return None
    return 100.0 * bound_s(total_bytes) / device_s
