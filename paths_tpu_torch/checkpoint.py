"""Checkpoint and resume for long renders (port of ``paths_tpu/checkpoint.py``).

The state of a render is the estimator's (sum, count) buffers, the next
sample index and the seed.  Every shading decision is a pure function of
(seed, pixel, sample), so a render resumed from a checkpoint is
bit-identical to an uninterrupted one (``render.render_image``).

Format: one ``.npz`` with the reference package's layout and magic, so a
file written by either package loads in the other.
"""

from __future__ import annotations

import os

import numpy as np

from paths_tpu_torch.render import Estimator

_MAGIC = "paths-tpu-ckpt-v1"


def save_checkpoint(path: str, est: Estimator, next_sample: int, seed: int):
    """Atomically write the render state: a temp file, then a rename."""
    tmp = f"{path}.tmp.npz"  # np.savez appends .npz to a name without it
    np.savez_compressed(
        tmp,
        magic=np.array(_MAGIC),
        width=np.int64(est.width),
        height=np.int64(est.height),
        sum=est.sum,
        count=est.count,
        next_sample=np.int64(next_sample),
        seed=np.int64(seed),
    )
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Returns (estimator, next_sample, seed).  Raises ValueError on a
    corrupt or foreign file."""
    with np.load(path, allow_pickle=False) as z:
        if "magic" not in z or str(z["magic"]) != _MAGIC:
            raise ValueError(f"{path}: not a paths-tpu checkpoint")
        est = Estimator(int(z["width"]), int(z["height"]))
        est.sum[:] = z["sum"]
        est.count[:] = z["count"]
        return est, int(z["next_sample"]), int(z["seed"])
