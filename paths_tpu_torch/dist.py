"""Data-parallel rendering and training over ``torch.distributed`` (port of
``paths_tpu/dist.py``).

The reference's design, kept: one mesh axis ``dp`` over the devices; pixel
lanes are sharded along it and the scene and camera are replicated, so the
forward has no cross-device traffic; the inverse-rendering step all-reduces
the loss and the gradients to a mean and updates the parameters on every
device alike.  Here the mesh is a process group: each rank is one process
on one device and runs the port's single-device code on its contiguous lane
shard.

Backend.  The port's collectives are ``all_reduce`` and ``broadcast`` only,
which gloo carries on CPU and CUDA tensors alike.  NCCL refuses two ranks on
one card, so ``choose_backend`` takes NCCL (for CUDA tensors; gloo still
carries the CPU ones) only when every rank of a host has a card of its own,
and gloo otherwise; ``init_multihost`` prints its choice and each rank's
device.

Multi-process: ``init_multihost()`` joins the group from ``torchrun``'s
environment (or explicit arguments); ``spawn`` starts N local ranks on a
file store, as the CLI's ``--dp N`` does.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as tdist

from paths_tpu_torch import grad as G
from paths_tpu_torch import render as R
from paths_tpu_torch import resolve_device

# Seconds a rendezvous or a collective waits for the other ranks before it
# fails (gloo's own default is 30 minutes).
TIMEOUT_S = 120.0


@dataclass(frozen=True)
class Mesh:
    """The port's one-axis device mesh: this rank's view of it."""

    group: object  # the torch.distributed process group
    rank: int
    size: int
    device: torch.device
    axis: str = "dp"


def choose_backend(device_type: str, local_ranks: int) -> str:
    """NCCL for CUDA tensors (gloo for CPU ones) when each of the host's
    `local_ranks` ranks has a card of its own; gloo otherwise."""
    if device_type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def init_multihost(init_method=None, world_size=None, rank=None, local_rank=None,
                   local_world_size=None, device=None, timeout_s=TIMEOUT_S):
    """Join a ``torch.distributed`` process group (the counterpart of
    ``jax.distributed.initialize``).  Arguments left None are read from the
    environment ``torchrun`` sets: MASTER_ADDR and MASTER_PORT (the
    ``env://`` rendezvous), WORLD_SIZE, RANK, LOCAL_RANK and
    LOCAL_WORLD_SIZE.  On ``cuda`` (the default) rank r runs on
    ``cuda:(local_rank % device_count)``, made the current device.  A rank
    that does not join or answer within `timeout_s` makes the others
    fail."""
    env = os.environ
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env["RANK"]) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    if local_world_size is None:
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = choose_backend(dev.type, local_world_size)
    tdist.init_process_group(backend, init_method=init_method or "env://",
                             world_size=world_size, rank=rank,
                             timeout=datetime.timedelta(seconds=timeout_s))
    print(f"[dist] rank {rank} of {world_size}: backend {backend}, device {dev}",
          flush=True)


def make_mesh(devices=None, axis: str = "dp") -> Mesh:
    """This rank's mesh over the default process group (init_multihost
    first).  `devices`: the ranks' device type, ``cuda`` (the current
    device, set by init_multihost) unless ``cpu`` is asked for."""
    dev = resolve_device(devices)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(tdist.group.WORLD, tdist.get_rank(), tdist.get_world_size(), dev, axis)


def _run_rank(rank, world_size, init_method, device, fn, args):
    init_multihost(init_method, world_size, rank, local_rank=rank,
                   local_world_size=world_size, device=device)
    try:
        fn(make_mesh(device), *args)
    finally:
        tdist.destroy_process_group()


def spawn(fn, n: int, *args, device=None):
    """Run ``fn(mesh, *args)`` on `n` local ranks: processes started with the
    ``spawn`` method, joined over a file store in a temporary directory (no
    port to race for).  `fn` must be importable (a module-level function).
    Raises if a rank fails."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        mp.spawn(_run_rank, args=(n, init, device, fn, args), nprocs=n, join=True)


def all_reduce_sum(a: np.ndarray, mesh: Mesh) -> np.ndarray:
    """The sum over the mesh's ranks of a host array, as a new array."""
    t = torch.from_numpy(np.array(a))
    tdist.all_reduce(t, group=mesh.group)
    return t.numpy()


def _shard(mesh: Mesh, n: int) -> slice:
    if n % mesh.size:
        raise ValueError(f"{n} lanes do not divide over {mesh.size} ranks")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def sharded_render_wave(static, mesh: Mesh):
    """render_wave with the pixel lanes sharded over the mesh and the scene
    replicated: fn(scene, cam, px, py, pixel_id, sample_id, seed) over the
    whole lane arrays returns this rank's shard of the (N, 3) radiance (no
    gather).  The lane count must divide by the mesh size."""

    def fwd(scene, cam, px, py, pixel_id, sample_id, seed):
        sl = _shard(mesh, px.shape[0])
        return R.render_wave(static, scene, cam, px[sl], py[sl], pixel_id[sl],
                             sample_id[sl], seed)

    return fwd


def sharded_render_samples(static, mesh: Mesh, n_samples: int):
    """render_samples (the regenerating wavefront) on each rank's lane shard:
    fn(scene, cam, px, py, pixel_id, sample_start, seed) over the whole lane
    arrays returns this rank's shard of the (N, 3) radiance sums, with no
    cross-rank traffic.  The lane count must divide by the mesh size."""

    def fwd(scene, cam, px, py, pixel_id, sample_start, seed):
        sl = _shard(mesh, px.shape[0])
        return R.render_samples(static, scene, cam, px[sl], py[sl], pixel_id[sl],
                                sample_start, n_samples, seed)

    return fwd


def sharded_train_step(static, mesh: Mesh, lr: float = 0.05):
    """One inverse-rendering SGD step: each rank's loss_and_grad on its lane
    shard, the loss and every gradient all-reduced to their mean over the
    ranks (equal shards make the mean of shard means the global mean), and
    the update replicated.  Returns fn(params, scene, cam, px, py,
    pixel_id, sample_id, seed, target) -> (loss, new params), the lane
    arrays whole."""

    def step(params, scene, cam, px, py, pixel_id, sample_id, seed, target):
        sl = _shard(mesh, px.shape[0])
        loss, grads = G.loss_and_grad(static, G.with_params(scene, params), cam,
                                      px[sl], py[sl], pixel_id[sl], sample_id[sl],
                                      seed, target[sl])
        leaves = G.flatten_params(grads)
        # One all-reduce of the loss and the gradients, flattened together.
        flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in leaves])
        tdist.all_reduce(flat, group=mesh.group)
        flat = flat / mesh.size
        sizes = [1] + [g.numel() for g in leaves]
        mean = [x.reshape(g.shape) for x, g in zip(flat.split(sizes)[1:], leaves)]
        new = [p - lr * g for p, g in zip(G.flatten_params(params), mean)]
        return flat[0], G.unflatten_params(new)

    return step
