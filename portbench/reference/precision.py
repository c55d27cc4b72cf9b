"""The control's precision: every floating-point result of a torch call
rounded to bfloat16, the nearest precision below the float32 that the
configurations state.  Inside ``lower_precision()`` the reference computes
as a bfloat16 program would (each operation's output stored in bfloat16);
autograd's gradients pass through the same rounding."""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

_FLOATS = (torch.float32, torch.float64)


def _round(x):
    if isinstance(x, torch.Tensor) and x.dtype in _FLOATS:
        return x.to(torch.bfloat16).to(x.dtype)
    if isinstance(x, (tuple, list)):
        return type(x)(_round(v) for v in x)
    return x


class lower_precision(TorchFunctionMode):
    """Rounds the floating-point outputs of every torch call to bfloat16
    (in-place calls keep their outputs: their inputs are rounded already)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "").endswith("_"):
            return out
        return _round(out)
