"""The ``environment`` configuration's map, ``configs/environment/
sunrise_4k.hdr``: the procedural sunrise of ``scenes/make_assets.py``
(``make_sunrise``) at any size, with the sun's disc and halo radii grown
with the width so that they cover the same solid angle at every size (4
and 8 texels at 256x128, where the image equals ``make_sunrise``'s),
written with RLE scanlines by the port's ``hdr_loader.write_hdr_rle``.

    python3 portbench/env_map.py OUT.hdr [--width 4096]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def sunrise(h: int = 2048, w: int = 4096) -> np.ndarray:
    """(h, w, 3) float32 linear RGB: a sky gradient over a dark ground,
    flipped as the renderer looks the sky up at the negated direction, and a
    sun slightly right of a +z camera's centre."""
    lat = np.pi * (1.0 - (np.arange(h)[:, None] + 0.5) / h)
    cos_up = np.cos(lat)
    sky_t = np.clip((cos_up + 1) / 2, 0, 1)
    horizon = np.array([1.0, 0.45, 0.2])
    zenith = np.array([0.15, 0.35, 0.8])
    ground = np.array([0.08, 0.07, 0.06])
    img = np.where(
        cos_up[..., None] > 0,
        horizon * (1 - sky_t[..., None]) * 2 + zenith * sky_t[..., None],
        ground * (0.3 + 0.7 * (1 + cos_up[..., None])),
    )
    img = np.broadcast_to(img, (h, w, 3))[::-1].copy()
    sun_y, sun_x = int(h * 0.42), int(w * 0.30)
    r = 2.0 * (w / 256)
    yy, xx = np.mgrid[0:h, 0:w]
    d2 = ((yy - sun_y) / r) ** 2 + ((xx - sun_x) / r) ** 2
    img[d2 < 4] = [800.0, 700.0, 500.0]
    img[(d2 >= 4) & (d2 < 16)] += np.array([20.0, 12.0, 5.0])
    return img.astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the environment configuration's map.")
    ap.add_argument("out")
    ap.add_argument("--width", type=int, default=4096, help="the map's width; height = width / 2")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from paths_tpu_torch.scene.hdr_loader import write_hdr_rle

    write_hdr_rle(args.out, sunrise(args.width // 2, args.width))
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
