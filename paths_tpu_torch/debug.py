"""Numeric sanitizers (port of ``paths_tpu/debug.py``).

The reference's only sanitizers are runtime panics: Colour::check() on
negative energy (colour.rs:56-60, called from trace.rs:39,80,82), negative
pdf and invalid microfacet-sample panics (material.rs:456-496).  A wave of
lanes cannot panic per lane, so ``validate_radiance`` is the Colour::check()
analogue over a whole wave or image: it counts NaN, infinite and
negative-energy samples and raises in strict mode; the CLI exposes it as
``--check``.

The reference's ``debug_checks`` scope (JAX's NaN debugging and internal
checks) has no counterpart yet; its PyTorch form, anomaly detection with NaN
checks, comes with a port of ``profiling.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class RadianceReport:
    n: int
    n_nan: int
    n_inf: int
    n_negative: int

    @property
    def ok(self) -> bool:
        return self.n_nan == 0 and self.n_inf == 0 and self.n_negative == 0

    def __str__(self):
        return (
            f"samples={self.n} nan={self.n_nan} inf={self.n_inf} "
            f"negative={self.n_negative}"
        )


def validate_radiance(colours, strict: bool = False) -> RadianceReport:
    """Colour::check() (colour.rs:56-60) over (N, 3) radiance: a numpy array
    or a tensor on any device."""
    if isinstance(colours, torch.Tensor):
        colours = colours.detach().cpu().numpy()
    c = np.asarray(colours)
    nan = np.isnan(c).any(axis=-1)
    inf = np.isinf(c).any(axis=-1)
    neg = (c < 0.0).any(axis=-1) & ~nan
    rep = RadianceReport(
        n=len(c), n_nan=int(nan.sum()), n_inf=int(inf.sum()),
        n_negative=int(neg.sum()),
    )
    if strict and not rep.ok:
        raise FloatingPointError(f"invalid radiance: {rep}")
    return rep
