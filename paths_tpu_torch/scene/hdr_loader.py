"""Radiance .hdr (RGBE) loader, pure numpy (the port's own copy of
``paths_tpu/scene/hdr_loader.py``: the port imports nothing of the JAX
package, not even its numpy-only modules).

Replaces the reference's ``image::hdr`` decode (serde.rs:359-385).  Supports
the common `-Y h +X w` raster with new-style RLE scanlines and flat data.
"""

from __future__ import annotations

import numpy as np


def load_hdr(path: str) -> np.ndarray:
    """Returns (H, W, 3) float32 linear RGB."""
    with open(path, "rb") as f:
        data = f.read()

    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")

    # Header ends at a blank line; next line is the resolution spec.
    pos = 0
    fmt_ok = False
    while True:
        nl = data.find(b"\n", pos)
        line = data[pos:nl].strip()
        pos = nl + 1
        if line.startswith(b"FORMAT="):
            fmt_ok = b"32-bit_rle_rgbe" in line
        if line == b"":
            break
    nl = data.find(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution spec {res}")
    if not fmt_ok:
        raise ValueError(f"{path}: unsupported FORMAT")
    height, width = int(res[1]), int(res[3])

    raw = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.zeros((height, width, 4), np.uint8)
    off = 0
    for y in range(height):
        if (
            off + 4 <= len(raw)
            and raw[off] == 2
            and raw[off + 1] == 2
            and ((int(raw[off + 2]) << 8) | int(raw[off + 3])) == width
        ):
            # New-style RLE: 4 components run-length encoded per scanline.
            off += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(raw[off]); off += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = raw[off]
                        off += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = raw[off : off + count]
                        off += count
                        x += count
        else:
            # Flat scanline.
            row = raw[off : off + width * 4].reshape(width, 4)
            rgbe[y] = row
            off += width * 4

    mantissa = rgbe[..., :3].astype(np.float32)
    exponent = rgbe[..., 3].astype(np.int32)
    scale = np.where(
        exponent == 0, 0.0, np.ldexp(1.0, exponent - 136)
    ).astype(np.float32)
    return mantissa * scale[..., None]


def to_rgbe(image: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 RGBE of (H, W, 3) linear RGB: the inverse of
    load_hdr's decode, the largest channel's exponent shared."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[0], img.shape[1]
    maxc = img.max(axis=-1)
    exp = np.zeros((h, w), np.int32)
    nz = maxc > 1e-32
    # frexp: maxc = m * 2^e with m in [0.5, 1).
    m, e = np.frexp(np.where(nz, maxc, 1.0))
    scale = np.where(nz, m * 256.0 / maxc, 0.0)
    exp = np.where(nz, e + 128, 0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(np.rint(img * scale[..., None]), 0, 255).astype(np.uint8)
    rgbe[..., 3] = exp.astype(np.uint8)
    return rgbe


def write_hdr(path: str, image: np.ndarray):
    """Write (H, W, 3) linear RGB to a flat (non-RLE) Radiance HDR file.

    Inverse of load_hdr's RGBE decode; used by tests and asset generators
    (the reference ships .hdr skyboxes it does not bundle,
    scenes/environment.yml:13-14)."""
    rgbe = to_rgbe(image)
    h, w = rgbe.shape[0], rgbe.shape[1]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def _rle_channel(row: bytes) -> bytes:
    """New-style RLE bytes of one component of a scanline: runs of 4 to 127
    equal bytes as (128 + n, byte), everything else as literals of at most
    128 bytes (count, bytes)."""
    out = bytearray()
    n, x, lit = len(row), 0, 0  # lit: start of the pending literal
    while x < n:
        run = 1
        while x + run < n and run < 127 and row[x + run] == row[x]:
            run += 1
        if run < 4:
            x += run
            continue
        while lit < x:
            k = min(128, x - lit)
            out += bytes([k]) + row[lit:lit + k]
            lit += k
        out += bytes([128 + run, row[x]])
        x += run
        lit = x
    while lit < n:
        k = min(128, n - lit)
        out += bytes([k]) + row[lit:lit + k]
        lit += k
    return bytes(out)


def write_hdr_rle(path: str, image: np.ndarray):
    """Write (H, W, 3) linear RGB as a Radiance HDR file with new-style RLE
    scanlines (each a 2, 2, width marker, then its four components
    run-length encoded in turn), which load_hdr reads.  The width must lie
    in [8, 32767]."""
    rgbe = to_rgbe(image)
    h, w = rgbe.shape[0], rgbe.shape[1]
    if not 8 <= w <= 32767:
        raise ValueError(f"RLE scanlines need a width in [8, 32767], not {w}")
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        for y in range(h):
            f.write(bytes([2, 2, w >> 8, w & 255]))
            for c in range(4):
                f.write(_rle_channel(rgbe[y, :, c].tobytes()))
