"""Command-line renderer (port of ``paths_tpu/cli.py``).

Renders a YAML scene, or the built-in stress scene when none is given
(main.rs:43-50), and writes a PNG.  Runs on the CUDA device unless --cpu is
given.

Usage:
  python -m paths_tpu_torch.cli [scene.yml] [-o out.png] [--spp N]
      [--size WxH] [--seed N] [--tile N] [--stress N] [--max-bounces N]
      [--env-nee] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

# Options of the reference CLI that this port does not have yet.
_NOT_PORTED = ("--dp", "--multihost", "--checkpoint", "--profile",
               "--native-cpu", "--check")


def main(argv=None):
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
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch versions of the kernels)")
    for flag in _NOT_PORTED:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help="not yet ported")
    args = ap.parse_args(argv)
    for flag in _NOT_PORTED:
        if getattr(args, flag.lstrip("-").replace("-", "_")) is not None:
            raise SystemExit(f"{flag} is not yet ported to paths_tpu_torch "
                             "(see ROADMAP.md)")

    from paths_tpu_torch import camera as C
    from paths_tpu_torch import resolve_device
    from paths_tpu_torch.render import render_image, write_png
    from paths_tpu_torch.scene.build import build_scene

    device = resolve_device("cpu" if args.cpu else None)
    t0 = time.time()
    if args.scene:
        from paths_tpu_torch.scene.yaml_loader import load_scene_description

        sd = load_scene_description(args.scene)
    else:
        from paths_tpu_torch.scene.stress import generate_stress_scene

        print(f"No scene given; using {args.stress}-sphere stress scene")
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
    print(f"[{time.time()-t0:6.2f}s] scene built on {device}: "
          f"{static.n_spheres} spheres ({static.sph_chunks} kernel chunks, "
          f"{route} route), {tris}, {static.n_lights} lights")

    t1 = time.time()
    img = render_image(static, scene, cam, width, height, spp=args.spp,
                       seed=args.seed, tile_pixels=args.tile, progress=True)
    elapsed = time.time() - t1
    samples = width * height * args.spp
    print(f"[{time.time()-t0:6.2f}s] rendered {width}x{height} @ {args.spp}spp "
          f"in {elapsed:.2f}s ({samples/elapsed/1e6:.3f} M pixel-samples/s)")
    write_png(args.output, img)
    print(f"wrote {args.output}")
    return img


if __name__ == "__main__":
    main()
