"""Command-line renderer (port of ``paths_tpu/cli.py``).

Renders a YAML scene, or the built-in stress scene when none is given
(main.rs:43-50), and writes a PNG.  Runs on the CUDA device unless --cpu is
given.

With --checkpoint the render state is saved every --checkpoint-every
samples and at the end, and a render started with an existing checkpoint
file resumes from it (a checkpoint taken at another seed or size is
refused).  --check validates the image's radiance (NaN, inf, negative
energy) and exits 1 on a violation.  --profile writes a torch.profiler
trace of the render into a directory.

--dp N renders data-parallel on N local ranks (processes started with the
spawn method; `all` means every visible card, and N may exceed the card
count, the ranks then sharing a card); --multihost joins the process group
from torchrun's environment instead, one rank per process.  Every rank
builds the scene; rank 0 prints, writes the PNG and the checkpoint.

--native-cpu renders with the C++ CPU tracer (csrc/cpu_tracer.cc) on
--threads threads instead: the host anchor and the oracle.

Usage:
  python -m paths_tpu_torch.cli [scene.yml] [-o out.png] [--spp N]
      [--size WxH] [--seed N] [--tile N] [--stress N] [--max-bounces N]
      [--env-nee] [--checkpoint FILE] [--checkpoint-every N] [--check]
      [--profile LOGDIR] [--dp N|all | --multihost] [--native-cpu
      [--threads N]] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="paths-tpu-torch renderer")
    ap.add_argument("scene", nargs="?", default=None, help="YAML scene file")
    ap.add_argument("-o", "--output", default="out.png")
    ap.add_argument("--spp", type=int, default=16, help="samples per pixel")
    ap.add_argument("--size", default=None, help="override WxH (e.g. 360x240)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tile", type=int, default=65536, help="pixels per wave")
    ap.add_argument("--stress", type=int, default=500,
                    help="stress-scene sphere count when no scene given")
    ap.add_argument("--max-bounces", type=int, default=10)
    ap.add_argument("--env-nee", action="store_true",
                    help="importance-sample the HDRI sky for direct light")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file; resumed from if it exists, "
                         "written every --checkpoint-every samples")
    ap.add_argument("--checkpoint-every", type=int, default=32,
                    help="samples between checkpoint writes")
    ap.add_argument("--check", action="store_true",
                    help="validate the rendered radiance (NaN/inf/negative "
                         "energy, the Colour::check() analogue) and fail on "
                         "violations")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace of the render to LOGDIR")
    ap.add_argument("--dp", default=None, metavar="N|all",
                    help="shard pixel lanes over N local ranks (every visible "
                         "card with 'all'); the scene is replicated")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group from torchrun's environment "
                         "(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, "
                         "LOCAL_RANK); dp is the world size")
    ap.add_argument("--native-cpu", action="store_true",
                    help="render with the C++ CPU tracer (multithreaded, an "
                         "independent implementation; no card)")
    ap.add_argument("--threads", type=int, default=4,
                    help="worker threads for --native-cpu")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch versions of the kernels)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.native_cpu:
        if args.env_nee:
            raise SystemExit("--env-nee is not in --native-cpu (the card's "
                             "renderer only)")
        # The tracer renders from scratch in one shot: refuse the flags
        # that configure the wavefront renderer rather than ignore them.
        for flag, name in ((args.checkpoint, "--checkpoint"),
                           (args.profile, "--profile"), (args.dp, "--dp"),
                           (args.multihost, "--multihost"), (args.check, "--check")):
            if flag:
                raise SystemExit(f"{name} is not supported with --native-cpu")
        return _render(None, args)
    if args.multihost:
        if args.dp:
            raise SystemExit("--dp is not supported with --multihost (dp is the "
                             "world size)")
        import torch.distributed

        from paths_tpu_torch import dist

        device = "cpu" if args.cpu else None
        dist.init_multihost(device=device)
        try:
            return _render(dist.make_mesh(device), args)
        finally:
            torch.distributed.destroy_process_group()
    if args.dp:
        import torch

        from paths_tpu_torch import dist, native, resolve_device

        cuda = resolve_device("cpu" if args.cpu else None).type == "cuda"
        n = (torch.cuda.device_count() if cuda else 1) if args.dp == "all" else int(args.dp)
        if n < 1:
            raise SystemExit(f"--dp {args.dp}: at least one rank")
        if cuda:  # build before the ranks start, so that none waits on a build
            native.build_all()
        dist.spawn(_render, n, args, device="cpu" if args.cpu else None)
        return None
    return _render(None, args)


def _render(mesh, args):
    """Build the scene and render it (on this rank's share with a mesh);
    rank 0 prints, writes the PNG and the checkpoint.  Returns the image."""
    from paths_tpu_torch import camera as C
    from paths_tpu_torch import resolve_device
    from paths_tpu_torch.render import render_image, write_png
    from paths_tpu_torch.scene.build import build_scene

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    if mesh is not None:
        device = mesh.device
    else:
        device = resolve_device("cpu" if args.cpu or args.native_cpu else None)
    t0 = time.time()
    if args.scene:
        from paths_tpu_torch.scene.yaml_loader import load_scene_description

        sd = load_scene_description(args.scene)
    else:
        from paths_tpu_torch.scene.stress import generate_stress_scene

        say(f"No scene given; using {args.stress}-sphere stress scene")
        sd = generate_stress_scene(args.stress)

    static, scene, cam = build_scene(sd, device=device)
    static = dataclasses.replace(static, env_nee=args.env_nee,
                                 max_bounces=args.max_bounces)
    width, height = sd.camera.image_width, sd.camera.image_height
    if args.size:
        width, height = (int(v) for v in args.size.lower().split("x"))
        cam = C.resize(cam, width, height)
    route = ("flat" if static.sph_flat else "walk") if static.sph_chunks else "scan"
    tris = f"{static.n_tris} triangles"
    if static.tri_chunks:
        tris += f" (kernel route, {static.tri_chunks} chunks of {static.tri_rows} rows)"
    elif static.n_tris:
        tris += " (BVH route)" if static.use_bvh else " (scan route)"
    say(f"[{time.time()-t0:6.2f}s] scene built on {device}: "
        f"{static.n_spheres} spheres ({static.sph_chunks} kernel chunks, "
        f"{route} route), {tris}, {static.n_lights} lights")

    if args.native_cpu:
        from paths_tpu_torch import native

        t1 = time.time()
        img = native.cpu_render(static, scene, cam, width, height, args.spp,
                                seed=args.seed, n_threads=args.threads,
                                max_bounces=args.max_bounces)
        if img is None:
            raise SystemExit("--native-cpu: the scene uses materials the "
                             "reference cannot BSDF-sample (Cook-Torrance, Fresnel)")
        elapsed = time.time() - t1
        samples = width * height * args.spp
        print(f"[{time.time()-t0:6.2f}s] native-cpu rendered {width}x{height} @ "
              f"{args.spp}spp on {args.threads} threads in {elapsed:.2f}s "
              f"({samples/elapsed/1e6:.3f} M pixel-samples/s)")
        write_png(args.output, img)
        print(f"wrote {args.output}")
        return img

    est, start_sample, on_batch = None, 0, None
    if args.checkpoint:
        import os

        from paths_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

        if os.path.exists(args.checkpoint):
            est, start_sample, ck_seed = load_checkpoint(args.checkpoint)
            if ck_seed != args.seed or est.width != width or est.height != height:
                raise SystemExit(
                    f"checkpoint {args.checkpoint} was taken with different "
                    f"render settings (seed {ck_seed}, {est.width}x{est.height})"
                )
            say(f"resumed {args.checkpoint} at sample {start_sample}")

        last_saved = [start_sample]

        def on_batch(e, next_sample):
            if (next_sample - last_saved[0] >= args.checkpoint_every
                    or next_sample >= args.spp):
                save_checkpoint(args.checkpoint, e, next_sample, args.seed)
                last_saved[0] = next_sample
                print(f"[ckpt] saved at sample {next_sample}")

    import contextlib

    prof = contextlib.nullcontext()
    if args.profile:
        from paths_tpu_torch.profiling import trace

        prof = trace(args.profile, device=device)
    t1 = time.time()
    with prof:
        img = render_image(static, scene, cam, width, height, spp=args.spp,
                           seed=args.seed, tile_pixels=args.tile, progress=True,
                           est=est, start_sample=start_sample, on_batch=on_batch,
                           mesh=mesh)
    elapsed = time.time() - t1
    samples = width * height * (args.spp - min(start_sample, args.spp))
    on = "" if mesh is None else f" on {mesh.size} ranks"
    say(f"[{time.time()-t0:6.2f}s] rendered {width}x{height} @ {args.spp}spp{on} "
        f"in {elapsed:.2f}s ({samples/elapsed/1e6:.3f} M pixel-samples/s)")
    if not lead:
        return img
    write_png(args.output, img)
    print(f"wrote {args.output}")
    if args.check:
        from paths_tpu_torch.debug import validate_radiance

        rep = validate_radiance(img.reshape(-1, 3))
        print(f"[check] {rep}")
        if not rep.ok:
            raise SystemExit(1)
    return img


if __name__ == "__main__":
    main()
