"""paths-tpu-torch: the paths-tpu path tracer ported to PyTorch and CUDA.

A second package beside ``paths_tpu`` (the JAX reference it is held
against), with the same module layout: each module here names its JAX
counterpart.  Plain tensor code is PyTorch; the traversal kernels that the
JAX package wrote in Pallas for the TPU are hand-written CUDA for Hopper
(``csrc/``), each with a plain PyTorch version beside it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device they raise instead of falling back quietly.  On a CPU
tensor a kernel wrapper runs its plain version; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and no
    CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --cpu) to "
            "run on the CPU"
        )
    return dev
