"""Progressive rendering runtime: epochs, preview pass, fly-cam, frame-rate
governor (port of ``paths_tpu/progressive.py``).

Reference: src/renderer.rs, src/controller.rs, src/timing.rs, src/pixels.rs.

  reference                         | here
  ----------------------------------|-----------------------------------
  4 worker threads pulling column   | one render_samples wave over every
  requests off a bounded channel    | pixel per pump()
  epoch stamps dropping stale       | one wave in flight; a camera change
  results (worker.rs:58-66)         | bumps the epoch, and the stale wave
                                    | is dropped when it is collected
  sparse 6x6 preview pass           | same: a 1/36-lane preview wave after
  (renderer.rs:152-164)             | each reset, filled in on display
  Estimator sum/count + grid fill   | same (pixels.rs:6-31, 53-79)
  Governer 60Hz limiter             | same (timing.rs:5-57)
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from paths_tpu_torch import camera as C
from paths_tpu_torch.math import matrix as mat
from paths_tpu_torch.render import Estimator, render_samples, tiled_pixel_order
from paths_tpu_torch.sampling import hashing as H

PREVIEW_GRID_SIZE = 6  # renderer.rs:13
EPOCH_SEED_STEP = 0x9E3779B9


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of an epoch's sample sequence: seed + epoch * 0x9E3779B9
    mod 2^32, a fresh sequence per camera pose."""
    return (seed + epoch * EPOCH_SEED_STEP) & H.MASK32


class ProgressiveRenderer:
    """Accumulates sample waves; camera changes start a new epoch.  Runs on
    the camera's device."""

    def __init__(self, static, scene, cam: C.Camera, width: int, height: int,
                 seed: int = 0, samples_per_pump: int = 1):
        self.static = static
        self.scene = scene
        self.cam = cam
        self.width = width
        self.height = height
        self.seed = seed
        self.samples_per_pump = samples_per_pump
        self.epoch = 0
        self.sample_cursor = 0
        self.num_rays_cast = 0
        self.estimator = Estimator(width, height)
        self._preview_pending = True
        self._pending = None  # the one wave in flight (see pump)

        pix = tiled_pixel_order(width, height)
        self._px = (pix % width).astype(np.int32)
        self._py = (pix // width).astype(np.int32)
        self._pid = pix.astype(np.int64)
        # Preview lanes: every PREVIEW_GRID_SIZE-th pixel in x and y
        # (renderer.rs:152-164).
        mask = (self._px % PREVIEW_GRID_SIZE == 0) & (self._py % PREVIEW_GRID_SIZE == 0)
        self._prev_idx = np.nonzero(mask)[0]
        dev = cam.location.device
        lanes = lambda idx: tuple(torch.as_tensor(a[idx], device=dev)
                                  for a in (self._px, self._py, self._pid))
        self._lanes = {"preview": lanes(self._prev_idx), "full": lanes(slice(None))}

    # -- camera control (renderer.rs:112-128) --
    def set_camera(self, location, rot3x3):
        dev = self.cam.location.device
        self.cam = self.cam._replace(
            location=torch.as_tensor(np.asarray(location), dtype=torch.float32, device=dev),
            rot=torch.as_tensor(np.asarray(rot3x3), dtype=torch.float32, device=dev),
        )
        self.reset()

    def reset(self):
        """New epoch: wipe accumulation (renderer.rs:143-150)."""
        self.epoch += 1
        self.sample_cursor = 0
        self.num_rays_cast = 0
        self.estimator.reset()
        self._preview_pending = True

    # -- progressive work (the fill/drain pump) --
    def _dispatch(self):
        """Render the next wave; returns the in-flight record (epoch, lane
        index, n_samples, device tensor)."""
        if self._preview_pending:
            idx, lanes, n_samples = self._prev_idx, self._lanes["preview"], 1
            self._preview_pending = False
        else:
            idx, lanes = slice(None), self._lanes["full"]
            n_samples = self.samples_per_pump
        col = render_samples(self.static, self.scene, self.cam, *lanes,
                             self.sample_cursor, n_samples,
                             epoch_seed(self.seed, self.epoch))
        if isinstance(idx, slice):
            self.sample_cursor += n_samples
        return (self.epoch, idx, n_samples, col)

    def pump(self):
        """Progress the render by one frame's worth of work.

        Pipelined as the reference's: the next wave is dispatched before
        the previous wave's result is collected, and a camera change while
        a wave is in flight bumps the epoch, so that wave is dropped when it
        is collected (the workers' staleness rule, worker.rs:58-66, narrowed
        to the one wave in flight).  The structure is kept although the
        overlap is not there yet: render_samples waits on the card once per
        bounce iteration (its loop tests whether every lane is done), so
        the wave is finished when _dispatch returns.
        """
        pending = self._pending
        self._pending = self._dispatch()
        if pending is None:
            return
        epoch, idx, n_samples, col = pending
        if epoch != self.epoch:
            return  # stale epoch: the camera moved while in flight
        col = col.cpu().numpy().astype(np.float64)
        ys = self._py[idx]
        xs = self._px[idx]
        self.estimator.sum[ys, xs] += col
        self.estimator.count[ys, xs] += n_samples
        self.num_rays_cast += len(col) * n_samples

    def frame(self) -> np.ndarray:
        """Current image with preview-grid fill (pixels.rs:53-79)."""
        counts = self.estimator.count
        mean = self.estimator.sum / np.maximum(counts, 1)[..., None]
        if (counts == 0).any():
            gy = (np.arange(self.height) // PREVIEW_GRID_SIZE) * PREVIEW_GRID_SIZE
            gx = (np.arange(self.width) // PREVIEW_GRID_SIZE) * PREVIEW_GRID_SIZE
            anchor = mean[gy][:, gx]
            mean = np.where((counts == 0)[..., None], anchor, mean)
        return mean


class Controller:
    """Fly-cam: accumulate the next pose, apply on change
    (controller.rs:15-71)."""

    def __init__(self, renderer: ProgressiveRenderer, location, orientation3x3):
        self.renderer = renderer
        self.location = np.asarray(location, np.float64)
        self.orientation = np.asarray(orientation3x3, np.float64)
        self.next_location = self.location.copy()
        self.next_orientation = self.orientation.copy()

    def update(self):
        if not (
            np.array_equal(self.location, self.next_location)
            and np.array_equal(self.orientation, self.next_orientation)
        ):
            self.renderer.set_camera(self.next_location, self.next_orientation)
        self.location = self.next_location.copy()
        self.orientation = self.next_orientation.copy()
        self.renderer.pump()

    def move_camera(self, v):
        """Movement in the camera frame (controller.rs:42-49)."""
        v = np.asarray(v, np.float64)
        if not v.any():
            return
        self.next_location = self.next_location + self.orientation @ v

    def rotate(self, yaw, pitch, roll):
        """controller.rs:51-54: post-multiply."""
        self.next_orientation = self.next_orientation @ mat.rotation(yaw, pitch, roll)

    def frame(self):
        return self.renderer.frame()


class Governer:
    """Sliding-window FPS measurement + sleep-to-target (timing.rs:5-57)."""

    def __init__(self, frames_per_second: int):
        self.frames_per_second = frames_per_second
        self.frame_duration = 1.0 / frames_per_second
        self.frame_times = deque([time.monotonic()])
        self.current_fps = 0.0

    def end_frame(self):
        n = len(self.frame_times)
        expected = self.frame_duration * n
        now = time.monotonic()
        actual = now - self.frame_times[-1]
        if actual > 0:
            self.current_fps = n / actual
        self.frame_times.appendleft(now)
        if expected > actual:
            time.sleep(expected - actual)
        while len(self.frame_times) > self.frames_per_second:
            self.frame_times.pop()
