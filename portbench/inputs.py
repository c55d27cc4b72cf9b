"""The benchmark's inputs, made from the run's seed and the mix's
parameters and handed alike to the program and to the reference: render
seeds, pixel orders, the gradient mix's target image and the fly-cam
script.
"""

from __future__ import annotations

import itertools

import numpy as np


def stream_seed(seed: int, k: int, stream: int = 0) -> int:
    """A u32 word for the k-th frame, step or epoch of a run (stream 1:
    the set-up's warm-up, which no measured frame shares)."""
    ss = np.random.SeedSequence([seed % (1 << 63), k, stream])
    return int(ss.generate_state(1)[0])


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), stream])


def tiled_pixel_order(width: int, height: int, tile: int = 32) -> np.ndarray:
    """Pixel ids (y*W+x) in tile-major order: consecutive ids are a
    compact square of the frame."""
    pix = np.arange(width * height, dtype=np.uint32)
    x = pix % width
    y = pix // width
    key = ((y // tile).astype(np.uint64) * ((width + tile - 1) // tile)
           + (x // tile)) * (tile * tile) + (y % tile) * tile + (x % tile)
    return pix[np.argsort(key, kind="stable")].astype(np.int64)


def grad_batch(order: np.ndarray, step: int, lanes: int):
    """(pixel ids, sample ids) of a gradient step: the step-th run of
    `lanes` positions through the frame's pixel order, wrapping, with the
    sample id the pass through the frame."""
    pos = np.arange(step * lanes, (step + 1) * lanes, dtype=np.int64)
    return order[pos % len(order)], pos // len(order)


def grad_target(seed: int, width: int, height: int, coarse: tuple, scale: float) -> np.ndarray:
    """(W*H, 3) f32 target radiance by pixel id: a coarse grid of uniform
    values in [0, scale) drawn from the seed, bilinearly upsampled: a smooth
    "photo" that no render of the scene matches."""
    gy, gx = coarse
    g = rng(seed, 11).random((gy, gx, 3)) * scale
    ys = np.linspace(0.0, gy - 1.0, height)
    xs = np.linspace(0.0, gx - 1.0, width)
    y0 = np.minimum(ys.astype(int), gy - 2)
    x0 = np.minimum(xs.astype(int), gx - 2)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    top = g[y0][:, x0] * (1 - fx) + g[y0][:, x0 + 1] * fx
    bot = g[y0 + 1][:, x0] * (1 - fx) + g[y0 + 1][:, x0 + 1] * fx
    return (top * (1 - fy) + bot * fy).reshape(-1, 3).astype(np.float32)


# A fly-cam action's direction: a move along one camera axis, or a turn
# about one (yaw, pitch, roll), one step of the viewer's speeds.
AXES = [np.array(v, np.float64) for v in
        ([1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1])]


def flycam_actions(seed: int, mix: dict, orientation: np.ndarray, location: np.ndarray,
                   rotation):
    """Per frame without end, None (still) or ("move", v) or ("turn",
    (yaw, pitch, roll)), scaled by the mix's speeds.  Still and moving
    spells alternate, still first; their lengths in frames are the mix's
    lists, in an order drawn from the seed (each seed the same lengths),
    and each moving frame makes one action drawn from the seed.  A move
    that would leave the mix's box is replaced by its opposite.
    rotation(yaw, pitch, roll) is the fly-cam's rotation matrix."""
    r = rng(seed, 13)
    still, moving = list(mix["still_frames"]), list(mix["move_frames"])
    lo, hi = (np.array(b, np.float64) for b in mix["bounds"])
    step, turn = float(mix["movement_speed"]), float(mix["rotation_speed"])
    loc, ori = location.astype(np.float64).copy(), orientation.astype(np.float64).copy()
    spell = 0
    while True:
        if spell % len(still) == 0:
            s_order, m_order = r.permutation(len(still)), r.permutation(len(moving))
        yield from [None] * still[s_order[spell % len(still)]]
        for _ in range(moving[m_order[spell % len(moving)]]):
            if r.random() < 0.5:
                v = AXES[r.integers(len(AXES))] * step
                if not ((loc + ori @ v >= lo).all() and (loc + ori @ v <= hi).all()):
                    v = -v
                loc = loc + ori @ v
                yield ("move", v)
            else:
                a = AXES[r.integers(len(AXES))] * turn
                ori = ori @ rotation(*a)
                yield ("turn", tuple(a))
        spell += 1


def flycam_script(seed: int, mix: dict, orientation: np.ndarray, location: np.ndarray,
                  rotation, n_frames: int) -> list:
    """The first n_frames actions of ``flycam_actions``."""
    return list(itertools.islice(flycam_actions(seed, mix, orientation, location, rotation),
                                 n_frames))
