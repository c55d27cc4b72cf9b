"""The reference's account of the progressive window (renderer.rs,
controller.rs, worker.rs, pixels.rs as the program states them): which
sample waves each frame shown holds, and that frame's image.

Rules: a pose change on update starts a new epoch (seed + epoch *
0x9E3779B9 mod 2^32), empties the estimator and asks for a preview wave
(one sample on every 6th pixel in x and y); each update sends the next
wave (the preview if asked for, else a full wave at the epoch's next
sample) and collects the wave sent by the update before, unless the epoch
has changed since (stale: dropped).  A frame is the estimator's per-pixel
mean, where a pixel without samples takes the mean of its 6x6 grid
anchor.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import matrix as RM
from portbench.reference import trace as RT

GRID = 6
EPOCH_STEP = 0x9E3779B9
MASK32 = 0xFFFFFFFF


def replay(script, location, orientation, seed: int, samples_per_pump: int = 1) -> list:
    """Per frame, the waves its estimator holds: a list of dicts (preview,
    sample, n, seed, location, orientation)."""
    loc, ori = np.array(location, np.float64), np.array(orientation, np.float64)
    nxt_loc, nxt_ori = loc.copy(), ori.copy()
    epoch, cursor, preview, pending, held = 0, 0, True, None, []
    plan = []
    for action in script:
        if action is not None:
            kind, v = action
            if kind == "move":
                nxt_loc = nxt_loc + ori @ np.asarray(v, np.float64)
            else:
                nxt_ori = nxt_ori @ RM.rotation(*v)
        if not (np.array_equal(loc, nxt_loc) and np.array_equal(ori, nxt_ori)):
            epoch, cursor, preview, held = epoch + 1, 0, True, []
        loc, ori = nxt_loc.copy(), nxt_ori.copy()
        wave = dict(preview=preview, sample=cursor, n=1 if preview else samples_per_pump,
                    epoch=epoch,
                    seed=(seed + epoch * EPOCH_STEP) & MASK32, location=loc, orientation=ori)
        if not preview:
            cursor += samples_per_pump
        preview = False
        if pending is not None and pending["epoch"] == epoch:
            held = held + [pending]
        pending = wave
        plan.append(held)
    return plan


def choose(plan: list, rng) -> list:
    """The frames to hold: the one with the most full waves (the first
    such), and one drawn by rng among those that hold the preview alone."""
    full = [sum(not w["preview"] for w in held) for held in plan]
    out = {int(np.argmax(full))}
    only_preview = [k for k, held in enumerate(plan) if len(held) == 1 and held[0]["preview"]]
    if only_preview:
        out.add(int(only_preview[rng.integers(len(only_preview))]))
    return sorted(out)


def render_frame(S, width: int, height: int, held: list) -> np.ndarray:
    """(H, W, 3) f64: the frame of the waves `held`, preview-filled."""
    dev = S.sph_center.device
    pid = torch.arange(width * height, device=dev)
    px, py = pid % width, pid // width
    on_grid = ((px % GRID) == 0) & ((py % GRID) == 0)
    total = np.zeros((width * height, 3))
    count = np.zeros(width * height)
    for w in held:
        cam = S.camera._replace(
            location=torch.as_tensor(w["location"], dtype=torch.float32, device=dev),
            rot=torch.as_tensor(w["orientation"], dtype=torch.float32, device=dev))
        sel = torch.nonzero(on_grid, as_tuple=True)[0] if w["preview"] else pid
        col = RT.render_sum(S, cam, px[sel], py[sel], pid[sel], w["sample"], w["n"], w["seed"])
        idx = sel.cpu().numpy()
        total[idx] += col.cpu().numpy().astype(np.float64)
        count[idx] += w["n"]
    total = total.reshape(height, width, 3)
    count = count.reshape(height, width)
    mean = total / np.maximum(count, 1)[..., None]
    if (count == 0).any():
        gy = (np.arange(height) // GRID) * GRID
        gx = (np.arange(width) // GRID) * GRID
        mean = np.where((count == 0)[..., None], mean[gy][:, gx], mean)
    return mean
