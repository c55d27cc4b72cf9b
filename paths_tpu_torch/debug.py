"""Numeric sanitizers (port of ``paths_tpu/debug.py``).

The reference's only sanitizers are runtime panics: Colour::check() on
negative energy (colour.rs:56-60, called from trace.rs:39,80,82), negative
pdf and invalid microfacet-sample panics (material.rs:456-496).  A wave of
lanes cannot panic per lane, so ``validate_radiance`` is the Colour::check()
analogue over a whole wave or image: it counts NaN, infinite and
negative-energy samples and raises in strict mode; the CLI exposes it as
``--check``.

``debug_checks()`` is the PyTorch form of the reference's scope of JAX's
NaN debugging and internal checks: autograd's anomaly detection with its
NaN check on every backward node, and a check of the outputs of
``render.render_samples``, ``render.render_wave`` and
``grad.loss_and_grad``, which raise ``FloatingPointError`` naming the
function on a NaN or an infinity.  Under jit, JAX's NaN checks look at the
outputs of the jitted call, not at the masked intermediates inside it; the
output checks look at the same thing.  Slow (every check reads the device):
use on small repros.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

# Set inside debug_checks(): check_outputs raises on NaN or infinity.
CHECK_OUTPUTS = False


@contextlib.contextmanager
def debug_checks():
    """Within the scope, autograd's anomaly detection with NaN checks is on
    and the renderer's entry points check their outputs (check_outputs).
    Both settings are restored on exit, also on an exception."""
    global CHECK_OUTPUTS
    anomaly, check_nan = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    checks = CHECK_OUTPUTS
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    CHECK_OUTPUTS = True
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(anomaly, check_nan=check_nan)
        CHECK_OUTPUTS = checks


def check_outputs(name: str, *tensors) -> None:
    """Inside debug_checks(), raise FloatingPointError naming `name` when
    any of `tensors` holds a NaN or an infinity; outside it, nothing."""
    if not CHECK_OUTPUTS:
        return
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"{name}: NaN or infinity in its output "
                                     f"(shape {tuple(t.shape)})")


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
