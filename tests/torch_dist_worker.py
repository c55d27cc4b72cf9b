"""One rank of the port's data-parallel checks on the CPU
(tests/test_torch_dist.py starts two):

    python tests/torch_dist_worker.py RANK WORLD_SIZE STORE_FILE OUT_DIR

Joins a gloo group on a file store, runs every sharded function of
``paths_tpu_torch.dist`` and ``render_image(mesh=...)`` (whole, with tiles
that do not divide the frame, resumed from a checkpoint) on the 8-sphere
stress scene, the sharded forward on the mixed scene and at full depth, and
writes this rank's results to OUT_DIR/rank<RANK>.pt.  Also the tests'
launcher of ranks, ``start_ranks``.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

import torch

from paths_tpu_torch import camera as C
from paths_tpu_torch import dist
from paths_tpu_torch import grad as G
from paths_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from paths_tpu_torch.render import Estimator, render_image
from paths_tpu_torch.scene.build import build_scene
from paths_tpu_torch.scene.stress import generate_mixed_scene, generate_stress_scene

torch.set_num_threads(2)

W, H = 32, 8  # tests/test_dist.py's tiny frame
TILES = (65536, 101)  # one tile; tiles of 101 pixels, rounded up per rank
MIXED_W, MIXED_H = 16, 8
TIMEOUT_S = 60.0
# Seconds a test's ranks may take together.
RUN_TIMEOUT_S = 240
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_ranks(script_args, n, env=None):
    """Start n processes, rank r running ``python *script_args(r)`` (from
    the repository's root) with the environment env(r), and wait for them
    all; fails the test on a non-zero exit or a hang.  Returns each rank's
    output."""
    procs = [subprocess.Popen([sys.executable, *script_args(r)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env(r) if env else None)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RUN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return outs


def lanes(width, height):
    """(px, py, pixel_id, sample_id) of every pixel in row order, sample 0."""
    pix = torch.arange(width * height, dtype=torch.int64)
    return ((pix % width).to(torch.int32), (pix // width).to(torch.int32), pix,
            torch.zeros_like(pix))


def tiny(max_bounces=2):
    """The 8-sphere stress scene (seed 0) at 32x8: (static, scene, cam)."""
    static, scene, cam = build_scene(generate_stress_scene(8, seed=0), device="cpu")
    return dataclasses.replace(static, max_bounces=max_bounces), scene, C.resize(cam, W, H)


def mixed(asset_dir):
    """The mixed scene with 40 spheres (the walk route: K1-K4's plain
    versions), 2 bounces, at 16x8."""
    static, scene, cam = build_scene(generate_mixed_scene(asset_dir, n_spheres=40),
                                     device="cpu")
    assert static.sph_chunks > 0 and static.tri_chunks > 0 and not static.sph_flat
    return dataclasses.replace(static, max_bounces=2), scene, C.resize(cam, MIXED_W, MIXED_H)


def resumed_part(static, scene, cam, ckpt, mesh=None, on_batch=None):
    """1 sample, checkpointed to `ckpt` and loaded, then resumed to 2 (one
    sample a batch)."""
    est = Estimator(W, H)
    render_image(static, scene, cam, W, H, spp=1, seed=3, est=est, sample_batch=1)
    save_checkpoint(ckpt, est, 1, 3)
    est, start, seed = load_checkpoint(ckpt)
    return render_image(static, scene, cam, W, H, spp=2, seed=seed, est=est,
                        start_sample=start, sample_batch=1, mesh=mesh, on_batch=on_batch)


def run(mesh, out_dir):
    static, scene, cam = tiny()
    px, py, pid, sid = lanes(W, H)
    res = {
        "wave": dist.sharded_render_wave(static, mesh)(scene, cam, px, py, pid, sid, 0),
        "samples": dist.sharded_render_samples(static, mesh, 2)(scene, cam, px, py, pid, 0, 0),
    }
    for tile in TILES:
        res[f"image_tile{tile}"] = render_image(static, scene, cam, W, H, spp=2, seed=3,
                                                tile_pixels=tile, mesh=mesh)
    calls = []
    with tempfile.TemporaryDirectory() as tmp:
        res["resumed"] = resumed_part(static, scene, cam, os.path.join(tmp, "ck.npz"),
                                      mesh, on_batch=lambda e, s: calls.append(s))
    res["on_batch_calls"] = calls
    step = dist.sharded_train_step(static, mesh, lr=0.05)
    res["train_loss"], res["train_params"] = step(
        G.get_params(scene), scene, cam, px, py, pid, sid, 0, torch.zeros((W * H, 3)))
    with tempfile.TemporaryDirectory() as tmp:
        m_static, m_scene, m_cam = mixed(tmp)
    mpx, mpy, mpid, _ = lanes(MIXED_W, MIXED_H)
    res["mixed_samples"] = dist.sharded_render_samples(m_static, mesh, 2)(
        m_scene, m_cam, mpx, mpy, mpid, 0, 0)
    d_static, d_scene, d_cam = tiny(max_bounces=10)
    res["deep_samples"] = dist.sharded_render_samples(d_static, mesh, 1)(
        d_scene, d_cam, px, py, pid, 0, 0)
    res["mesh"] = (mesh.rank, mesh.size, str(mesh.device), mesh.axis)
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def main():
    rank, world, store, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_multihost(f"file://{store}", world, rank, device="cpu", timeout_s=TIMEOUT_S)
    try:
        run(dist.make_mesh("cpu"), out_dir)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
