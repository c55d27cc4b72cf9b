"""Frame rendering: camera sample waves, the regenerating wavefront, the
estimator and PNG output (port of ``paths_tpu/render.py``).

A *sample wave* is one CMJ sample for every pixel of a tile.  Each (pixel,
sample) draws its sensor jitter from a CMJ square pattern and its lens point
from a CMJ disk pattern seeded per pixel (worker.rs:68-86).  Lane order does
not change any lane's result, so the reference's TPU lane scheduling (wave
sort, lane permutation, block culls) has no counterpart here.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from paths_tpu_torch import camera as C
from paths_tpu_torch import integrator as I
from paths_tpu_torch.math.colour import to_bytes_np
from paths_tpu_torch.sampling import cmj
from paths_tpu_torch.sampling import hashing as H

# Per-pixel CMJ pattern dims (re-seeded per batch of PAT_M*PAT_N samples).
PAT_M = 4
PAT_N = 4

_SQUARE_TAG = 0x5153
_DISK_TAG = 0xD15C


def gen_camera_rays(cam: C.Camera, px, py, pixel_id, sample_id, seed):
    """Primary rays for (pixel, sample) lanes: CMJ sensor jitter + CMJ lens
    point -> thin-lens ray (worker.rs:68-77).  pixel_id and sample_id are
    u32 words (int64 tensors).  Returns (o, d, weight)."""
    pixel_id = H.as_u32(pixel_id)
    sample_id = H.as_u32(sample_id)
    s = sample_id % (PAT_M * PAT_N)
    batch = sample_id // (PAT_M * PAT_N)
    p_sq = H.hash_u32(seed, pixel_id, batch, _SQUARE_TAG)
    p_dk = H.hash_u32(seed, pixel_id, batch, _DISK_TAG)
    sq = cmj.cmj_square(s, PAT_M, PAT_N, p_sq)
    dk = cmj.cmj_disk(s, PAT_M, PAT_N, p_dk)
    return C.get_rays(cam, px, py, sq, dk)


def render_wave(static, scene, cam: C.Camera, px, py, pixel_id, sample_id,
                seed) -> torch.Tensor:
    """Radiance estimates for one sample of N pixels: (N, 3)."""
    o, d, w = gen_camera_rays(cam, px, py, pixel_id, sample_id, seed)
    col = I.trace_rays(static, scene, o, d, H.as_u32(pixel_id),
                       H.as_u32(sample_id), seed)
    return col * w[..., None]  # worker.rs:77: sample = trace * weight


def render_samples(static, scene, cam, px, py, pixel_id, sample_start,
                   n_samples: int, seed) -> torch.Tensor:
    """Sum of `n_samples` consecutive radiance samples per pixel lane, as a
    *regenerating wavefront*: each lane carries its own (sample slot,
    bounce), and the moment its path ends it banks the sample and starts the
    next sample's camera ray, so every iteration does useful work on nearly
    every lane.  RNG identity is (pixel_id, sample_id, bounce, dim) as in
    render_wave, so the result equals the sum of the n_samples waves up to
    float addition order.  Returns (N, 3)."""
    dev = px.device
    n = px.shape[0]
    max_b = static.max_bounces + 1  # trace.rs:14: 11 segment iterations
    pixel_id = H.as_u32(pixel_id)
    s_start = int(sample_start)

    def regen(slot):
        sid = (slot + s_start) & H.MASK32
        o, d, w = gen_camera_rays(cam, px, py, pixel_id, sid, seed)
        return I.fresh_path_state(o, d), w

    slot = torch.zeros(n, dtype=torch.int64, device=dev)
    bounce = torch.zeros(n, dtype=torch.int64, device=dev)
    acc = torch.zeros((n, 3), device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    state, w = regen(slot)

    while not bool(done.all()):
        u = I.lane_uniforms(seed, pixel_id, (slot + s_start) & H.MASK32)
        state = I.path_step(static, scene, bounce, state, u)
        bounce = bounce + 1
        finished = ~done & (~state[4] | (bounce >= max_b))

        # Bank the finished sample (worker.rs:77: sample = trace * weight).
        acc = acc + torch.where(finished[..., None], state[3] * w[..., None], 0.0)

        # Advance to the next sample slot; regenerate or retire the lane.
        slot = torch.where(finished, slot + 1, slot)
        done = done | (finished & (slot >= n_samples))
        start_new = finished & ~done
        fresh, w_new = regen(slot)
        bounce = torch.where(start_new, 0, bounce)
        w = torch.where(start_new, w_new, w)
        state = tuple(
            torch.where(start_new[..., None] if new.dim() == 2 else start_new,
                        new, old)
            for new, old in zip(fresh, state)
        )
        # Retired lanes must not keep tracing.
        state = state[:4] + (state[4] & ~done,) + state[5:]
    return acc


def tiled_pixel_order(width: int, height: int, tile: int = 32) -> np.ndarray:
    """Pixel ids (y*W+x) in tile-major order, so consecutive lanes are a
    compact square tile (coherent rays)."""
    pix = np.arange(width * height, dtype=np.uint32)
    x = pix % width
    y = pix // width
    key = (
        (y // tile).astype(np.uint64) * ((width + tile - 1) // tile)
        + (x // tile)
    ) * (tile * tile) + (y % tile) * tile + (x % tile)
    return pix[np.argsort(key, kind="stable")]


class Estimator:
    """Per-pixel running mean via sum + count (pixels.rs:6-31)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.sum = np.zeros((height, width, 3), np.float64)
        self.count = np.zeros((height, width), np.int64)

    def update(self, py, px, colours):
        np.add.at(self.sum, (py, px), np.asarray(colours, np.float64))
        np.add.at(self.count, (py, px), 1)

    def mean(self) -> np.ndarray:
        c = np.maximum(self.count, 1)[..., None]
        return self.sum / c

    def reset(self):
        self.sum[:] = 0
        self.count[:] = 0

    def to_bytes(self) -> np.ndarray:
        return to_bytes_np(self.mean())


# Samples per pixel that one render_samples call adds to each tile.
SAMPLE_BATCH = 8


def render_image(static, scene, cam: C.Camera, width: int, height: int,
                 spp: int = 16, seed: int = 0, tile_pixels: int = 65536,
                 progress: bool = False, est: Estimator | None = None,
                 start_sample: int = 0, on_batch=None,
                 sample_batch: int = SAMPLE_BATCH) -> np.ndarray:
    """Render a full frame at `spp` samples per pixel on the scene's device.
    Returns (H, W, 3) linear-RGB float64 means.

    Sample-major: each pass adds a batch of `sample_batch` samples to every
    pixel tile, so the accumulated state is checkpointable between batches
    (``checkpoint.py``).  Resume by passing the loaded `est` and
    `start_sample`: the RNG streams are a function of (seed, pixel, sample)
    and the host fold is one f64 += per batch in batch order, so a resumed
    render is bit-identical to an uninterrupted one with the same batch
    boundaries.  `on_batch(est, next_sample)` fires after each full-frame
    batch.  The reference's `mesh` (lanes sharded over devices) waits for a
    port of its ``dist.py``."""
    dev = cam.location.device
    if est is None:
        est = Estimator(width, height)
    n_pix = width * height
    pix = tiled_pixel_order(width, height)
    px_all = (pix % width).astype(np.int32)
    py_all = (pix // width).astype(np.int32)

    tile = min(tile_pixels, n_pix)
    tiles = []
    for start in range(0, n_pix, tile):
        end = min(start + tile, n_pix)
        pad = tile - (end - start)
        sl = slice(start, end)
        tiles.append((
            sl, end - start,
            torch.as_tensor(np.pad(px_all[sl], (0, pad)), device=dev),
            torch.as_tensor(np.pad(py_all[sl], (0, pad)), device=dev),
            torch.as_tensor(np.pad(pix[sl], (0, pad)).astype(np.int64), device=dev),
        ))

    s = start_sample
    while s < spp:
        k = min(sample_batch, spp - s)
        for sl, n, px_t, py_t, pid_t in tiles:
            col = render_samples(static, scene, cam, px_t, py_t, pid_t, s, k, seed)
            est.sum[py_all[sl], px_all[sl]] += col.cpu().numpy().astype(np.float64)[:n]
            est.count[py_all[sl], px_all[sl]] += k
        s += k
        if progress:
            print(f"[render] samples {s}/{spp}")
        if on_batch is not None:
            on_batch(est, s)
    return est.mean()


def encode_png(rgb8: np.ndarray) -> bytes:
    """PNG bytes for an (H, W, 3) uint8 image (8-bit RGB, no filtering),
    encoded with the standard library alone."""
    h, w, _ = rgb8.shape
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, linear_rgb: np.ndarray):
    """Gamma-encode (colour.rs:30-36) and write a PNG."""
    rgb8 = np.ascontiguousarray(to_bytes_np(linear_rgb))
    with open(path, "wb") as f:
        f.write(encode_png(rgb8))
