"""The counter-based lane RNG as one launch a draw: the shading uniform
``u(bounce, dim)`` and a lane's two camera CMJ points.

On CPU tensors each wrapper runs the plain functions of
``sampling/hashing.py`` and ``sampling/cmj.py``, unchanged (the tests'
oracle, held against the reference there).  On CUDA tensors it launches
``csrc/lane_rng.cu``, which computes the same words in native uint32 in one
kernel: about 125 eager launches a draw and 350 a camera sample become one.
It launches through ``native.launch`` (on the current stream, counted in
``profiling.LAUNCHES``: a launch captured into a CUDA graph counts at its
capture and again at each replay of the graph), checks only dtypes, shapes
and devices, and never reads a tensor on the host; it never falls back.
Lane keys are int64 tensors, as every caller's; the low 32 bits are the
word, as in ``hashing.as_u32``.  The seed is a host integer or a
one-element int64 tensor on the lanes' device, which the kernel reads there
(``step_graphs.py`` replays a launch with each call's seed that way).  The
outputs carry no gradient, as the plain versions' do not.
"""

from __future__ import annotations

import operator

import torch

from paths_tpu_torch import native
from paths_tpu_torch.sampling import cmj
from paths_tpu_torch.sampling import hashing as H


def shading_uniform_plain(seed, pixel_id, sample_id, bounce, dim):
    """U[0,1) of (seed, pixel_id, sample_id, bounce * DIMS_PER_BOUNCE + dim)
    by the eager hash."""
    ctr = (H.mul32(H.as_u32(bounce, pixel_id.device), H.DIMS_PER_BOUNCE) + dim) & H.MASK32
    return H.uniform(seed, pixel_id, sample_id, ctr)


def camera_cmj_plain(seed, pixel_id, sample_id, m: int, n: int, square_tag: int,
                     disk_tag: int):
    """The sensor jitter and the disk pattern's square point of each lane,
    by the eager hash and CMJ: ((x, y), (x, y)) in [0,1)^2."""
    pixel_id = H.as_u32(pixel_id)
    sample_id = H.as_u32(sample_id)
    s = sample_id % (m * n)
    batch = sample_id // (m * n)
    p_sq = H.hash_u32(seed, pixel_id, batch, square_tag)
    p_dk = H.hash_u32(seed, pixel_id, batch, disk_tag)
    return cmj.cmj(s, m, n, p_sq), cmj.cmj(s, m, n, p_dk)


def _word(x, name: str) -> int:
    """A host integer key as its u32 word."""
    if isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a host integer on the card path, "
                        "not a tensor (reading it would wait on the card)")
    return operator.index(x) & H.MASK32


def _seed(seed, device):
    """(the seed's word, the device word or None): a host integer goes by
    value, a one-element int64 tensor on `device` by its pointer."""
    if not isinstance(seed, torch.Tensor):
        return _word(seed, "seed"), None
    if seed.device != device:
        raise ValueError(f"seed is on {seed.device}, expected {device}")
    if seed.dtype != torch.int64:
        raise TypeError(f"seed has dtype {seed.dtype}, expected int64")
    if seed.numel() != 1:
        raise ValueError(f"seed has shape {tuple(seed.shape)}, expected one word")
    return 0, seed


def _lanes(x, name: str, n: int, device) -> torch.Tensor:
    """A lane key tensor: int64, shape (n,), on `device`, made contiguous."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor of lane keys")
    x = x.contiguous()
    native.check(name, x, torch.int64, (n,), device)
    return x


def _launch_checks(pixel_id):
    if pixel_id.device.type != "cuda":
        raise ValueError(f"unsupported device {pixel_id.device}")
    if pixel_id.dim() != 1:
        raise ValueError(f"pixel_id has shape {tuple(pixel_id.shape)}, expected (N,)")
    if pixel_id.shape[0] >= 2 ** 31:
        raise ValueError("too many lanes for one launch")
    return pixel_id.shape[0], pixel_id.device


def shading_uniform(seed, pixel_id, sample_id, bounce, dim):
    """u(bounce, dim) for lanes (pixel_id, sample_id): (N,) f32, the words
    of ``hashing.uniform(seed, pixel_id, sample_id, ctr)`` with ctr =
    bounce * DIMS_PER_BOUNCE + dim.  bounce: an integer for every lane or
    a lane tensor; dim an integer; seed an integer or a device word."""
    if pixel_id.device.type == "cpu":
        return shading_uniform_plain(seed, pixel_id, sample_id, bounce, dim)
    n, dev = _launch_checks(pixel_id)
    (seed_w, seed_t), dim_w = _seed(seed, dev), _word(dim, "dim")
    pixel_id = _lanes(pixel_id, "pixel_id", n, dev)
    sample_id = _lanes(sample_id, "sample_id", n, dev)
    if isinstance(bounce, torch.Tensor):
        bounce, b_all = _lanes(bounce, "bounce", n, dev), 0
    else:
        bounce, b_all = None, _word(bounce, "bounce")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        native.launch("lane_shading_uniform", "rng_uniform", dev, seed_w, seed_t, pixel_id,
                      sample_id, bounce, b_all, dim_w, n, out)
    return out


def camera_cmj(seed, pixel_id, sample_id, m: int, n: int, square_tag: int,
               disk_tag: int):
    """A lane's sensor jitter and its lens pattern's square point, ((x, y),
    (x, y)) f32 (N,) each: ``cmj.cmj`` of sample_id % (m n) under the seeds
    ``hash_u32(seed, pixel_id, sample_id // (m n), tag)`` of the two tags.
    m and n are powers of two (the kernel's divisions by them are then
    exact, as every device's eager ones); seed an integer or a device
    word."""
    if pixel_id.device.type == "cpu":
        return camera_cmj_plain(seed, pixel_id, sample_id, m, n, square_tag, disk_tag)
    lanes, dev = _launch_checks(pixel_id)
    for name, v in (("m", m), ("n", n)):
        if v <= 0 or v & (v - 1):
            raise ValueError(f"the pattern's {name} must be a power of two, not {v}")
    seed_w, seed_t = _seed(seed, dev)
    tags = [_word(x, name) for x, name in ((square_tag, "square_tag"),
                                           (disk_tag, "disk_tag"))]
    pixel_id = _lanes(pixel_id, "pixel_id", lanes, dev)
    sample_id = _lanes(sample_id, "sample_id", lanes, dev)
    out = torch.empty((4, lanes), dtype=torch.float32, device=dev)
    if lanes:
        native.launch("lane_camera_cmj", "rng_camera", dev, seed_w, seed_t, pixel_id,
                      sample_id, m, n, tags[0], tags[1], lanes, out)
    return (out[0], out[1]), (out[2], out[3])
