#!/usr/bin/env python3
"""Time the walk kernels of one checkout of the port on fixed inputs, to
compare two checkouts on one card.

    python scripts/time_walks.py [--repo DIR] [--label NAME] [--size 720x480]

Imports paths_tpu_torch from DIR (default: this checkout), builds
stress-500 and, on the kernel route and on the BVH route, doom_standin and
dragon_standin, and times each walk kernel and the flat sphere kernel on
the rays of chip_smoke.py (its primary_rays and incoherent_rays, same
seeds), in two ways: the median of 25 calls, each from an idle card, the
host's part of the call included (chip_smoke.time_ms), and the device time
of 25 calls queued behind a spin kernel (chip_smoke.time_device_ms).  The
cells: K1 and K5's closest-hit form on stress-500's primary and incoherent
720x480 frames, K2 and K5's any-hit form on the incoherent frame, and all
four on the frame's first 65,536 incoherent lanes (a main-path tile's
size); K8 and K9's sphere form on the incoherent frame over the same
spheres packed at 16 rows a chunk; K3 and K4 on each mesh's incoherent
frame and on its 65,536-lane subset (every tenth-or-so primary ray and the
first 32,768 incoherent rays); K7 and K9's triangle form on doom's table
repacked at 32 rows a chunk (chip_smoke.repack_tris), on the same subset,
the incoherent frame and (K7) the primary frame; K6 on each mesh's primary
and incoherent frames.  Prints one JSON
line: the card's name and power limit, the label, each cell's two times,
and a digest of each kernel's outputs (equal digests: the same function).
Run it for each checkout in turns on one card (parent, change, change,
parent) to compare two versions.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE, help="checkout whose paths_tpu_torch is timed")
    ap.add_argument("--label", default="", help="name printed with the results")
    ap.add_argument("--size", default="720x480", help="frame of lanes, WxH")
    args = ap.parse_args()
    w, h = (int(x) for x in args.size.split("x"))
    sys.path.insert(0, os.path.abspath(args.repo))
    import paths_tpu_torch  # noqa: F401  (from --repo, before chip_smoke's path)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(1, HERE)
    import chip_smoke as CSM
    from paths_tpu_torch.ops import chunk_scan as CS
    from paths_tpu_torch.ops import packet_traverse as PK
    from paths_tpu_torch.ops import sphere_traverse as ST
    from paths_tpu_torch.ops import tri_traverse as TT
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_stress_scene
    from paths_tpu_torch.scene.yaml_loader import load_scene_description

    dev = torch.device("cuda")
    times, device_ms, digests = {}, {}, {}

    def cell(name, fn):
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        h = hashlib.sha256()
        for x in out:
            h.update(x.cpu().numpy().tobytes())
        digests[name] = h.hexdigest()[:16]
        times[name] = CSM.time_ms(fn)
        device_ms[name] = CSM.time_device_ms(fn)

    n = w * h
    static, scene, cam = build_scene(generate_stress_scene(500), device=dev)
    ps, nc = scene.psph, static.sph_chunks
    po, pd = CSM.primary_rays(cam, w, h, dev)
    o, d, excl, t_init, excl_ent, t_max = CSM.incoherent_rays(
        n, (-50.0, -50.0, 0.0), (50.0, 50.0, 100.0), static.n_spheres,
        static.n_entities, dev, t_span=150.0)
    p_excl = torch.full((n,), -1, dtype=torch.int32, device=dev)
    p_t = torch.full((n,), CSM.BIG, device=dev)
    cell("K1 primary frame", lambda: ST.closest_hit_spheres(ps, nc, po, pd, p_excl, p_t))
    cell("K1 incoherent frame", lambda: ST.closest_hit_spheres(ps, nc, o, d, excl, t_init))
    cell("K2 incoherent frame",
         lambda: ST.occludes_spheres(ps, nc, o, d, excl, excl_ent, t_max))
    cell("K5 primary frame", lambda: CS.flat_closest_hit(ps.tris, po, pd, p_excl, p_t))
    cell("K5 incoherent frame", lambda: CS.flat_closest_hit(ps.tris, o, d, excl, t_init))
    cell("K5 any incoherent frame",
         lambda: CS.flat_occludes(ps.tris, o, d, excl, excl_ent, t_max))
    m = min(CSM.SUBSET, n)
    tile = [x[:m].contiguous() for x in (o, d, excl, t_init, excl_ent, t_max)]
    ch, ah = tile[:4], tile[:3] + tile[4:]
    cell("K1 tile-size subset", lambda: ST.closest_hit_spheres(ps, nc, *ch))
    cell("K2 tile-size subset", lambda: ST.occludes_spheres(ps, nc, *ah))
    cell("K5 tile-size subset", lambda: CS.flat_closest_hit(ps.tris, *ch))
    cell("K5 any tile-size subset", lambda: CS.flat_occludes(ps.tris, *ah))
    cpu = lambda x: x.cpu().double().numpy()
    ps16, nc16, _ = ST.pack_spheres_chunked(
        cpu(scene.sph_center), cpu(scene.sph_radius), ent=scene.sph_ent.cpu().numpy(),
        rows_per_chunk=CS.SPH_ROWS_PER_CHUNK, device=dev)
    cell("K8 incoherent frame", lambda: CS.closest_hit_spheres(ps16, nc16, o, d, excl, t_init))
    cell("K9 sph incoherent frame",
         lambda: CS.occludes_spheres(ps16, nc16, o, d, excl, excl_ent, t_max))

    for label, path in (("doom", CSM.DOOM), ("dragon", CSM.DRAGON)):
        sd = load_scene_description(path)
        static, scene, cam = build_scene(sd, device=dev)
        pt, nc = scene.ptris, static.tri_chunks
        bscene = build_scene(sd, device=dev, bvh_threshold=CSM.BVH_THRESHOLD)[1]
        meta = pt.chunk_meta[:nc]
        po, pd = CSM.primary_rays(cam, w, h, dev)
        o, d, excl, t_init, excl_ent, t_max = CSM.incoherent_rays(
            n, meta[:, 0:3].amin(0), meta[:, 3:6].amax(0), static.n_tris,
            static.n_entities, dev)
        half = min(CSM.SUBSET, n) // 2
        sel = torch.arange(half, device=dev) * (n // half)
        cat = lambda a, b: torch.cat([a[sel], b[:half]]).contiguous()
        so, sd_, sx = cat(po, o), cat(pd, d), cat(p_excl, excl)
        st = cat(p_t, t_init)
        se = torch.cat([excl_ent[half:2 * half], excl_ent[:half]])
        sm = torch.cat([t_max[half:2 * half], t_max[:half]])
        cell(f"K3 {label} frame", lambda: TT.closest_hit_tris(pt, nc, o, d, excl, t_init))
        cell(f"K3 {label} subset", lambda: TT.closest_hit_tris(pt, nc, so, sd_, sx, st))
        cell(f"K4 {label} frame",
             lambda: TT.occludes_tris(pt, nc, o, d, excl, excl_ent, t_max))
        cell(f"K4 {label} subset", lambda: TT.occludes_tris(pt, nc, so, sd_, sx, se, sm))
        if label == "doom":
            pt32, nc32 = CSM.repack_tris(scene, bscene.pbvh, CS.TRI_ROWS_PER_CHUNK, dev)
            cell("K7 doom primary frame",
                 lambda: CS.closest_hit_chunked(pt32, nc32, po, pd, p_excl, p_t))
            cell("K7 doom frame",
                 lambda: CS.closest_hit_chunked(pt32, nc32, o, d, excl, t_init))
            cell("K7 doom subset", lambda: CS.closest_hit_chunked(pt32, nc32, so, sd_, sx, st))
            cell("K9 tri doom frame",
                 lambda: CS.occludes_chunked(pt32, nc32, o, d, excl, excl_ent, t_max))
            cell("K9 tri doom subset",
                 lambda: CS.occludes_chunked(pt32, nc32, so, sd_, sx, se, sm))
        t0 = torch.where(t_max == 0, 0.0, t_init).contiguous()
        cell(f"K6 {label} primary frame",
             lambda: PK.closest_hit_packet(bscene.pbvh, po, pd, p_excl, p_t))
        cell(f"K6 {label} frame", lambda: PK.closest_hit_packet(bscene.pbvh, o, d, excl, t0))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "ms": times, "device_ms": device_ms,
                      "digest": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
