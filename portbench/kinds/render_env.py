"""The render mix under an HDRI sky with environment NEE: ``render``'s
frames and window (loaded by name), with the program's
``SceneStatic.env_nee`` set as the CLI's ``--env-nee`` sets it, and the
check against ``reference/environment.py``.

Mix parameters: ``render``'s, and ``env_nee``, which must be true (the
reference models environment NEE only).

The set-up refuses a program that holds sphere centres in float32 alone
(no ``SceneArrays.sph_center_lo``): it would put the ``environment``
configuration's ground, at y -1000002.8, 1.25 cm low, and render another
scene than the reference's.

End to end: ``pixel_samples_per_s``, as ``render``.

Check: as ``render``'s, one frame drawn from the seed, every pixel,
``rel_mse`` and ``parted_pct``, against the environment reference.  On a
sky that is no HDRI environment NEE does nothing, and the frame is
``render``'s, checked as ``render`` checks it.
"""

from __future__ import annotations

import dataclasses

from portbench import env_light, harness, inputs

RENDER = harness.load_kind("render")
window = RENDER.window


def setup(ctx):
    from paths_tpu_torch.render import render_image

    if ctx.mix.get("env_nee") is not True:
        raise ValueError("the render_env mix needs env_nee true")
    static, scene, cam = ctx.port_scene()
    if not hasattr(scene, "sph_center_lo"):
        raise RuntimeError("the program holds sphere centres in float32 only (no "
                           "SceneArrays.sph_center_lo): it cannot place this scene's spheres")
    static = dataclasses.replace(static, env_nee=True)
    ctx.obs.values[env_light.ACTIVE] = _hdri(ctx)
    w, h = ctx.size
    render_image(static, scene, cam, w, h, spp=ctx.mix["warmup_spp"],
                 seed=inputs.stream_seed(ctx.seed, 0, stream=1),
                 tile_pixels=ctx.mix["tile_pixels"])
    return dict(static=static, scene=scene, cam=cam)


def _hdri(ctx) -> bool:
    sky = ctx.config["scene"].get("skybox") or {}
    return str(sky.get("type", "")).lower() == "hdri"


def _env_scene(ctx):
    from portbench.reference import environment as RE

    return RE.build(ctx.config["scene"], ctx.base_dir, ctx.device)


def _frame_mean(ctx, E, seed: int):
    from portbench.reference import environment as RE

    w, h = ctx.size
    return RE.frame_mean(E, w, h, ctx.mix["spp"], seed)


def check(records, ctx):
    if not _hdri(ctx):
        return RENDER.check(records, ctx)
    frames = records["frames"]
    j = int(inputs.rng(ctx.seed, 7).integers(len(frames)))
    ref = _frame_mean(ctx, _env_scene(ctx), inputs.stream_seed(ctx.seed, j))
    return {"rel_mse": harness.rel_mse(frames[j], ref),
            "parted_pct": harness.parted_pct(frames[j], ref)}


def control(ctx, fault: str):
    """The check's numbers with the reference computed in bfloat16 in the
    program's place (fault "bf16"), on the frame of seed index 0."""
    from portbench.reference.precision import lower_precision

    if fault != "bf16":
        raise ValueError(f"render_env mix: no control {fault!r}")
    if not _hdri(ctx):
        return RENDER.control(ctx, fault)
    E = _env_scene(ctx)
    seed = inputs.stream_seed(ctx.seed, 0)
    ref = _frame_mean(ctx, E, seed)
    with lower_precision():
        low = _frame_mean(ctx, E, seed)
    return {"rel_mse": harness.rel_mse(low, ref), "parted_pct": harness.parted_pct(low, ref)}
