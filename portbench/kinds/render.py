"""The render mix: batch rendering, each frame a whole image at the mix's
samples per pixel through ``render.render_image``, a fresh render seed a
frame (the next frame a user renders), frames back to back.

Mix parameters: ``spp``, ``tile_pixels`` (the lanes of one
``render_samples`` call), ``warmup_spp`` (the set-up's one frame).

End to end: ``pixel_samples_per_s``, the pixel-samples of every frame
finished in the window over the wall time of those frames (each frame ends
on the host copy of its last tile, which synchronises; the last frame
started inside the window is finished and counted).

Check: one frame drawn from the seed, every pixel, against the reference's
mean of the same samples: ``rel_mse``, the sum of squared differences over
the reference's sum of squares, and ``parted_pct``, the share of pixels
that part from the reference's (``harness.parted_pct``).
"""

from __future__ import annotations

import time

from portbench import harness, inputs


def setup(ctx):
    from paths_tpu_torch.render import render_image

    static, scene, cam = ctx.port_scene()
    w, h = ctx.size
    render_image(static, scene, cam, w, h, spp=ctx.mix["warmup_spp"],
                 seed=inputs.stream_seed(ctx.seed, 0, stream=1),
                 tile_pixels=ctx.mix["tile_pixels"])
    return dict(static=static, scene=scene, cam=cam)


def window(state, ctx, seconds):
    from paths_tpu_torch.render import render_image

    w, h = ctx.size
    spp = ctx.mix["spp"]
    frames, walls = [], []
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        t = time.perf_counter()
        frames.append(render_image(state["static"], state["scene"], state["cam"], w, h,
                                   spp=spp, seed=inputs.stream_seed(ctx.seed, len(frames)),
                                   tile_pixels=ctx.mix["tile_pixels"]))
        walls.append(time.perf_counter() - t)
    rate = len(frames) * w * h * spp / sum(walls)
    return dict(metrics={"pixel_samples_per_s": rate}, attempted=len(frames),
                unit_s=walls, records=dict(frames=frames))


def check(records, ctx):
    from portbench.reference import trace as RT

    frames = records["frames"]
    j = int(inputs.rng(ctx.seed, 7).integers(len(frames)))
    S = ctx.ref_scene()
    w, h = ctx.size
    ref = RT.frame_mean(S, w, h, ctx.mix["spp"], inputs.stream_seed(ctx.seed, j))
    return {"rel_mse": harness.rel_mse(frames[j], ref),
            "parted_pct": harness.parted_pct(frames[j], ref)}


def control(ctx, fault: str):
    """The check's numbers with the reference computed in bfloat16 in the
    program's place (fault "bf16"), on the frame of seed index 0."""
    from portbench.reference import trace as RT
    from portbench.reference.precision import lower_precision

    if fault != "bf16":
        raise ValueError(f"render mix: no control {fault!r}")
    S = ctx.ref_scene()
    w, h = ctx.size
    seed = inputs.stream_seed(ctx.seed, 0)
    ref = RT.frame_mean(S, w, h, ctx.mix["spp"], seed)
    with lower_precision():
        low = RT.frame_mean(S, w, h, ctx.mix["spp"], seed)
    return {"rel_mse": harness.rel_mse(low, ref), "parted_pct": harness.parted_pct(low, ref)}
