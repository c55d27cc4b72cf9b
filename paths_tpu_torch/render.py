"""Frame rendering: camera sample waves, the regenerating wavefront, the
estimator and PNG output (port of ``paths_tpu/render.py``).

A *sample wave* is one CMJ sample for every pixel of a tile.  Each (pixel,
sample) draws its sensor jitter from a CMJ square pattern and its lens point
from a CMJ disk pattern seeded per pixel (worker.rs:68-86).  Lane order does
not change any lane's result, so the reference's TPU lane scheduling (wave
sort, lane permutation, block culls) has no counterpart here.
"""

from __future__ import annotations

import operator
import struct
import zlib

import numpy as np
import torch

from paths_tpu_torch import camera as C
from paths_tpu_torch import debug
from paths_tpu_torch import integrator as I
from paths_tpu_torch import profiling as P
from paths_tpu_torch import step_graphs as SG
from paths_tpu_torch.math.colour import to_bytes_np
from paths_tpu_torch.ops import lane_rng as RNG
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
    u32 words (int64 tensors); both patterns' points are one launch of
    ``ops/lane_rng.py``'s kernel on the card.  Returns (o, d, weight)."""
    with P.span("paths_tpu_torch.rng"):
        sq, dk = RNG.camera_cmj(seed, pixel_id, sample_id, PAT_M, PAT_N,
                                _SQUARE_TAG, _DISK_TAG)
        dk = cmj.to_disk(*dk)
    return C.get_rays(cam, px, py, sq, dk)


@P.unit()
@P.span("paths_tpu_torch.render_wave")
def render_wave(static, scene, cam: C.Camera, px, py, pixel_id, sample_id,
                seed) -> torch.Tensor:
    """Radiance estimates for one sample of N pixels: (N, 3)."""
    o, d, w = gen_camera_rays(cam, px, py, pixel_id, sample_id, seed)
    col = I.trace_rays(static, scene, o, d, H.as_u32(pixel_id),
                       H.as_u32(sample_id), seed)
    col = col * w[..., None]  # worker.rs:77: sample = trace * weight
    debug.check_outputs("render_wave", col)
    return col


@P.unit()
@P.span("paths_tpu_torch.render_samples")
def render_samples(static, scene, cam, px, py, pixel_id, sample_start,
                   n_samples: int, seed) -> torch.Tensor:
    """Sum of `n_samples` consecutive radiance samples per pixel lane, as a
    *regenerating wavefront*: each lane carries its own (sample slot,
    bounce), and the moment its path ends it banks the sample and starts the
    next sample's camera ray, so every iteration does useful work on nearly
    every lane.  RNG identity is (pixel_id, sample_id, bounce, dim) as in
    render_wave, so the result equals the sum of the n_samples waves up to
    float addition order.  Returns (N, 3).

    The wave's start and each iteration's bank and regeneration are
    stretches of ``step_graphs.py``, as ``integrator.path_step``'s are: on
    the card they replay as CUDA graphs, which take the seed, the sample
    start and count, the lanes and the camera as device tensors each call
    and keep the wavefront's carry in place between iterations."""
    dev = px.device

    def word(v):
        return torch.full((), operator.index(v) & H.MASK32, dtype=torch.int64,
                          device=dev)

    wave = SG.run(_wave_start, (static,),
                  (word(seed), word(sample_start), word(n_samples), px, py, pixel_id,
                   *cam))
    lanes, carry = wave[:_LANES], wave[_LANES:]
    while not _all_done(carry[_DONE]):
        state = I.path_step(static, scene, carry[_BOUNCE], carry[:8],
                            I.lane_uniforms(lanes[0], lanes[5], carry[_SID]))
        carry = SG.run(_wave_bank, (static,), (*lanes, *state, *carry[8:]), into=carry)
    acc = carry[_ACC].clone()
    debug.check_outputs("render_samples", acc)
    return acc


# A wave's lanes: seed, sample start, sample count, px, py, pixel id and the
# camera's nine fields; its carry: the path state's eight tensors, then the
# lane's sample slot, sample id, bounce, accumulated radiance, whether it
# retired, and its camera weight.
_LANES = 6 + len(C.Camera._fields)
_SID, _BOUNCE, _ACC, _DONE = 9, 10, 11, 12


def _regen(lanes, slot):
    """Fresh camera rays for the lanes' sample slots: (path state, weight,
    sample id)."""
    seed, s_start, _, px, py, pixel_id, *cam = lanes
    sid = (slot + s_start) & H.MASK32
    o, d, w = gen_camera_rays(C.Camera(*cam), px, py, pixel_id, sid, seed)
    return I.fresh_path_state(o, d), w, sid


@SG.single
def _wave_start(static, seed, s_start, n_samples, px, py, pixel_id, *cam):
    """The wave's lanes and first carry: every lane at slot 0, bounce 0."""
    lanes = (seed, s_start, n_samples, px, py, H.as_u32(pixel_id), *cam)
    n = px.shape[0]
    slot = torch.zeros(n, dtype=torch.int64, device=px.device)
    bounce = torch.zeros(n, dtype=torch.int64, device=px.device)
    acc = torch.zeros((n, 3), device=px.device)
    done = torch.zeros(n, dtype=torch.bool, device=px.device)
    state, w, sid = _regen(lanes, slot)
    return (*lanes, *state, slot, sid, bounce, acc, done, w)


@SG.single
def _wave_bank(static, *args):
    """One iteration's end: bank each finished sample (worker.rs:77: sample
    = trace * weight), advance its lane to the next sample slot, and
    regenerate or retire the lane.  Takes the lanes, the new path state and
    the carry after the state; returns the next carry."""
    lanes, state, (slot, _, bounce, acc, done, w) = (
        args[:_LANES], args[_LANES:_LANES + 8], args[_LANES + 8:])
    max_b = static.max_bounces + 1  # trace.rs:14: 11 segment iterations
    bounce = bounce + 1
    finished = ~done & (~state[4] | (bounce >= max_b))
    acc = acc + torch.where(finished[..., None], state[3] * w[..., None], 0.0)
    slot = torch.where(finished, slot + 1, slot)
    done = done | (finished & (slot >= lanes[2]))
    start_new = finished & ~done
    fresh, w_new, sid = _regen(lanes, slot)
    bounce = torch.where(start_new, 0, bounce)
    w = torch.where(start_new, w_new, w)
    state = tuple(
        torch.where(start_new[..., None] if new.dim() == 2 else start_new, new, old)
        for new, old in zip(fresh, state)
    )
    # Retired lanes must not keep tracing.
    state = state[:4] + (state[4] & ~done,) + state[5:]
    return (*state, slot, sid, bounce, acc, done, w)


def _all_done(done) -> bool:
    """Whether every lane has retired: the host waits on the card here,
    before each iteration of render_samples and once after the last.
    While recording, each call that goes on to iterate counts the wave's
    lanes ("wave_lane_iters") and those not yet retired
    ("wave_live_lane_iters"), from the same one reduction."""
    with P.span("paths_tpu_torch.wavefront_sync"):
        n_done = int(done.sum())
    n = done.numel()
    if n_done < n:
        P.count("wave_lane_iters", n)
        P.count("wave_live_lane_iters", n - n_done)
    return n_done == n


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
                 sample_batch: int = SAMPLE_BATCH, mesh=None) -> np.ndarray:
    """Render a full frame at `spp` samples per pixel on the scene's device.
    Returns (H, W, 3) linear-RGB float64 means.

    Sample-major: each pass adds a batch of `sample_batch` samples to every
    pixel tile, so the accumulated state is checkpointable between batches
    (``checkpoint.py``).  Resume by passing the loaded `est` and
    `start_sample`: the RNG streams are a function of (seed, pixel, sample)
    and the host fold is one f64 += per batch in batch order, so a resumed
    render is bit-identical to an uninterrupted one with the same batch
    boundaries.  `on_batch(est, next_sample)` fires after each full-frame
    batch.

    mesh (``dist.make_mesh``): the ranks of its process group each render
    their contiguous shard of every tile's lanes (the tile rounded up to a
    multiple of the world size) and fold it into their own share of the
    estimator; before each on_batch and before returning, the shares are
    all-reduced into `est` on every rank.  The ranks' pixels are disjoint,
    so the sum is exact and the image equals the single-process one bit for
    bit; a loaded `est` is counted once (each rank keeps only its own
    pixels of it).  Every rank passes the same arguments; rank 0 alone
    prints progress and calls on_batch."""
    dev = cam.location.device
    if est is None:
        est = Estimator(width, height)
    n_pix = width * height
    pix = tiled_pixel_order(width, height)
    px_all = (pix % width).astype(np.int32)
    py_all = (pix // width).astype(np.int32)

    n_ranks, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    tile = -(-min(tile_pixels, n_pix) // n_ranks) * n_ranks
    k_rank = tile // n_ranks
    tiles = []
    for start in range(0, n_pix, tile):
        # This rank's lanes of the tile; past the frame's end, pixel 0 pads.
        sl = slice(min(start + rank * k_rank, n_pix),
                   min(start + (rank + 1) * k_rank, n_pix))
        pad = k_rank - (sl.stop - sl.start)
        tiles.append((
            sl, sl.stop - sl.start,
            torch.as_tensor(np.pad(px_all[sl], (0, pad)), device=dev),
            torch.as_tensor(np.pad(py_all[sl], (0, pad)), device=dev),
            torch.as_tensor(np.pad(pix[sl], (0, pad)).astype(np.int64), device=dev),
        ))

    share, sync = est, lambda: None
    if mesh is not None:
        from paths_tpu_torch import dist

        mine = np.zeros((height, width), bool)
        for sl, *_ in tiles:
            mine[py_all[sl], px_all[sl]] = True
        share = Estimator(width, height)
        share.sum[mine] = est.sum[mine]
        share.count[mine] = est.count[mine]

        def sync():
            est.sum[:] = dist.all_reduce_sum(share.sum, mesh)
            est.count[:] = dist.all_reduce_sum(share.count, mesh)

    s = start_sample
    while s < spp:
        k = min(sample_batch, spp - s)
        for sl, n, px_t, py_t, pid_t in tiles:
            col = render_samples(static, scene, cam, px_t, py_t, pid_t, s, k, seed)
            share.sum[py_all[sl], px_all[sl]] += col.cpu().numpy().astype(np.float64)[:n]
            share.count[py_all[sl], px_all[sl]] += k
        s += k
        if progress and rank == 0:
            print(f"[render] samples {s}/{spp}")
        if on_batch is not None:
            sync()
            if rank == 0:
                on_batch(est, s)
    sync()
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
