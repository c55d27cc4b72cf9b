"""Interactive terminal viewer -- the app shell (port of
``paths_tpu/viewer.py``).

The reference opens an SDL2 window with a 60Hz fly-cam loop
(src/main.rs:39-186).  Headless GPU hosts have no SDL; the equivalent here
renders the progressive estimate to the terminal with 24-bit ANSI half-block
cells and reads WASD keys raw from stdin.  Runs on the CUDA device unless
--cpu is given:

  w/a/s/d  move        (main.rs keybindings)
  space/c  up/down     (space/LShift in the reference)
  q/e      roll
  arrows   look (yaw/pitch; Enter-toggled mouse-look in the reference)
  r        reset accumulation
  p        save frame to PNG
  Esc      quit

Usage: python -m paths_tpu_torch.viewer [scene.yml] [--size 160x100]
           [--stress N] [--seconds S] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import select
import sys
import time

import numpy as np

from paths_tpu_torch.math.colour import to_bytes_np

MOVEMENT_SPEED = 0.4
ROTATION_SPEED = 0.05


# Per-cell escape fragments, precomputed once and joined per frame, in
# place of one f-string per cell (the reference's encoder, byte for byte).
_FG = [f"\x1b[38;2;{v};".encode() for v in range(256)]
_BG = [f"m\x1b[48;2;{v};".encode() for v in range(256)]
_NUM = [f"{v};".encode() for v in range(256)]
_NUM_HB = [f"{v}m▀".encode() for v in range(256)]  # last comp + halfblock


def _frame_to_ansi(rgb_bytes: np.ndarray) -> str:
    """Render (H, W, 3) u8 to half-block ANSI (2 rows per text line)."""
    h, w, _ = rgb_bytes.shape
    if h % 2:
        rgb_bytes = rgb_bytes[:-1]
        h -= 1
    top = rgb_bytes[0::2]
    bot = rgb_bytes[1::2]
    lines = []
    for y in range(h // 2):
        line = b"".join(
            b"".join((_FG[tr], _NUM[tg], _NUM[tb][:-1],
                      _BG[br], _NUM[bg], _NUM_HB[bb]))
            for (tr, tg, tb), (br, bg, bb) in zip(
                top[y].tolist(), bot[y].tolist())
        )
        lines.append(line.decode() + "\x1b[0m")
    return "\n".join(lines)


def run_viewer(scene_path: str | None, width: int, height: int, stress: int = 100,
               max_seconds: float | None = None, interactive: bool = True,
               device=None):
    """The viewer loop on `device` (default cuda); with max_seconds it
    returns after that long.  Returns the renderer."""
    from paths_tpu_torch import camera as C
    from paths_tpu_torch import resolve_device
    from paths_tpu_torch.progressive import Controller, Governer, ProgressiveRenderer
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_stress_scene
    from paths_tpu_torch.scene.yaml_loader import load_scene_description

    if scene_path:
        sd = load_scene_description(scene_path)
    else:
        sd = generate_stress_scene(stress)
    static, scene, cam = build_scene(sd, device=resolve_device(device))
    cam = C.resize(cam, width, height)

    renderer = ProgressiveRenderer(static, scene, cam, width, height)
    controller = Controller(renderer, cam.location.cpu().numpy(), cam.rot.cpu().numpy())
    governer = Governer(30)

    # Raw terminal input.
    old_attrs = None
    if interactive and sys.stdin.isatty():
        import termios
        import tty

        old_attrs = termios.tcgetattr(sys.stdin)
        tty.setcbreak(sys.stdin.fileno())

    start = time.time()
    frame_n = 0
    try:
        sys.stdout.write("\x1b[2J")  # clear
        while True:
            # -- input --
            if old_attrs is not None:
                while select.select([sys.stdin], [], [], 0)[0]:
                    ch = sys.stdin.read(1)
                    if ch == "\x1b":
                        # Escape or arrow sequence.
                        if select.select([sys.stdin], [], [], 0.01)[0]:
                            seq = sys.stdin.read(2)
                            if seq == "[A":
                                controller.rotate(0, -ROTATION_SPEED, 0)
                            elif seq == "[B":
                                controller.rotate(0, ROTATION_SPEED, 0)
                            elif seq == "[C":
                                controller.rotate(ROTATION_SPEED, 0, 0)
                            elif seq == "[D":
                                controller.rotate(-ROTATION_SPEED, 0, 0)
                        else:
                            return renderer
                    elif ch == "w":
                        controller.move_camera([0, 0, MOVEMENT_SPEED])
                    elif ch == "s":
                        controller.move_camera([0, 0, -MOVEMENT_SPEED])
                    elif ch == "a":
                        controller.move_camera([-MOVEMENT_SPEED, 0, 0])
                    elif ch == "d":
                        controller.move_camera([MOVEMENT_SPEED, 0, 0])
                    elif ch == " ":
                        controller.move_camera([0, MOVEMENT_SPEED, 0])
                    elif ch == "c":
                        controller.move_camera([0, -MOVEMENT_SPEED, 0])
                    elif ch == "q":
                        controller.rotate(0, 0, ROTATION_SPEED)
                    elif ch == "e":
                        controller.rotate(0, 0, -ROTATION_SPEED)
                    elif ch == "r":
                        renderer.reset()
                    elif ch == "p":
                        from paths_tpu_torch.render import write_png

                        write_png(f"viewer_frame_{frame_n}.png", renderer.frame())

            # -- render pump + display --
            controller.update()
            img = to_bytes_np(renderer.frame())
            sys.stdout.write("\x1b[H" + _frame_to_ansi(img))
            elapsed = time.time() - start
            sys.stdout.write(
                f"\x1b[0m\nfps {governer.current_fps:5.1f} | rays {renderer.num_rays_cast} "
                f"| rays/px {renderer.num_rays_cast / (width*height):6.1f} "
                f"| epoch {renderer.epoch} | {elapsed:6.1f}s  "
            )
            sys.stdout.flush()
            governer.end_frame()
            frame_n += 1
            if max_seconds is not None and elapsed > max_seconds:
                return renderer
    finally:
        if old_attrs is not None:
            import termios

            termios.tcsetattr(sys.stdin, termios.TCSADRAIN, old_attrs)
        sys.stdout.write("\x1b[0m\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description="paths-tpu-torch interactive viewer")
    ap.add_argument("scene", nargs="?", default=None)
    ap.add_argument("--size", default="160x100")
    ap.add_argument("--stress", type=int, default=100)
    ap.add_argument("--seconds", type=float, default=None,
                    help="exit after N seconds (for headless smoke tests)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.lower().split("x"))
    return run_viewer(args.scene, w, h, stress=args.stress, max_seconds=args.seconds,
                      device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
