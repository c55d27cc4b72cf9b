"""The interactive mix: the upstream's fly-cam window (main.rs:103-182).
Each frame applies the script's action for it (``inputs.flycam_actions``:
still spells and moving spells, one move or turn a moving frame), then
``Controller.update()`` (a camera change starts a new epoch: the wave in
flight is dropped as stale and a 1/36-lane preview wave is sent) and
``frame()`` (the image the window would show, preview-filled).  One
sample a pixel a pump; no governor sleeps: frames run back to back.

End to end: ``frame_ms_p90``, the 90th percentile over all frames of the
window of one update() plus frame().

Check: the program's progressive rules are replayed on the host from the
script (``reference/progressive.py``), and two of the frames shown are
rendered by the reference: the one with the most waves collected, and one
drawn from the seed among those that show the preview alone, filled in.
``rel_mse`` and ``parted_pct`` (as the render mix's) of the worse frame.
"""

from __future__ import annotations

import itertools
import time

import numpy as np

from portbench import harness, inputs
from portbench.reference import matrix as RM
from portbench.reference import progressive as RP

# Frames of script made ready in set-up; a window that shows more draws
# the rest as it goes.
SCRIPT_FRAMES = 60 * 60


def _controller(ctx, state, seed):
    from paths_tpu_torch.progressive import Controller, ProgressiveRenderer

    w, h = ctx.size
    cam = state["cam"]
    r = ProgressiveRenderer(state["static"], state["scene"], cam, w, h, seed=seed,
                            samples_per_pump=ctx.mix["samples_per_pump"])
    return Controller(r, cam.location.cpu().numpy(), cam.rot.cpu().numpy())


def _apply(ctrl, action):
    if action is None:
        return
    kind, v = action
    if kind == "move":
        ctrl.move_camera(v)
    else:
        ctrl.rotate(*v)


def setup(ctx):
    static, scene, cam = ctx.port_scene()
    state = dict(static=static, scene=scene, cam=cam)
    # Warm-up: a preview wave, a full wave, a move (stale drop and preview).
    ctrl = _controller(ctx, state, inputs.stream_seed(ctx.seed, 0, stream=1))
    for action in (None, None, ("move", np.array([0.0, 0.0, 0.4])), None):
        _apply(ctrl, action)
        ctrl.update()
        ctrl.frame()
    state["start"] = (cam.location.cpu().numpy().astype(np.float64),
                      cam.rot.cpu().numpy().astype(np.float64))
    state["actions"] = inputs.flycam_actions(ctx.seed, ctx.mix, state["start"][1],
                                             state["start"][0], RM.rotation)
    state["script"] = list(itertools.islice(state["actions"], SCRIPT_FRAMES))
    return state


def window(state, ctx, seconds):
    ctrl = _controller(ctx, state, inputs.stream_seed(ctx.seed, 0))
    frames, times = [], []
    end = time.perf_counter() + seconds
    script = state["script"]
    while time.perf_counter() < end:
        if len(frames) == len(script):
            script += itertools.islice(state["actions"], SCRIPT_FRAMES)
        _apply(ctrl, script[len(frames)])
        t = time.perf_counter()
        ctrl.update()
        img = ctrl.frame()
        times.append(time.perf_counter() - t)
        frames.append(img)
        ctx.tick()
    return dict(metrics={"frame_ms_p90": 1e3 * harness.p90(times)}, attempted=len(frames),
                unit_s=times, records=dict(frames=frames, start=state["start"],
                             script=script[:len(frames)]))


def check(records, ctx):
    frames = records["frames"]
    plan = RP.replay(records["script"], *records["start"], inputs.stream_seed(ctx.seed, 0),
                     ctx.mix["samples_per_pump"])
    chosen = RP.choose(plan, inputs.rng(ctx.seed, 9))
    S = ctx.ref_scene()
    w, h = ctx.size
    worst = {"rel_mse": 0.0, "parted_pct": 0.0}
    for k in chosen:
        ref = RP.render_frame(S, w, h, plan[k])
        worst = _worse(worst, frames[k], ref)
    return worst


def _worse(worst: dict, img, ref) -> dict:
    return {"rel_mse": max(worst["rel_mse"], harness.rel_mse(img, ref)),
            "parted_pct": max(worst["parted_pct"], harness.parted_pct(img, ref))}


def control(ctx, fault: str, n_frames: int = 120):
    """The check's numbers with the reference computed in bfloat16 in the
    program's place (fault "bf16"), over the frames of n_frames of the
    script that the check would hold."""
    from portbench.reference.precision import lower_precision

    if fault != "bf16":
        raise ValueError(f"interactive mix: no control {fault!r}")
    S = ctx.ref_scene()
    loc = S.camera.location.cpu().numpy().astype(np.float64)
    ori = S.camera.rot.cpu().numpy().astype(np.float64)
    script = inputs.flycam_script(ctx.seed, ctx.mix, ori, loc, RM.rotation, n_frames)
    plan = RP.replay(script, loc, ori, inputs.stream_seed(ctx.seed, 0), ctx.mix["samples_per_pump"])
    w, h = ctx.size
    worst = {"rel_mse": 0.0, "parted_pct": 0.0}
    for k in RP.choose(plan, inputs.rng(ctx.seed, 9)):
        ref = RP.render_frame(S, w, h, plan[k])
        with lower_precision():
            low = RP.render_frame(S, w, h, plan[k])
        worst = _worse(worst, low, ref)
    return worst
