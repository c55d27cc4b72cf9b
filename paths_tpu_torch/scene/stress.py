"""Procedural stress scene: N random spheres (a copy of the sphere generator
in ``paths_tpu/scene/stress.py``; reference: src/stress.rs).

Seeded, unlike the reference's thread_rng, so renders are reproducible.
``generate_lit_stress_scene`` adds one sphere light, so the shadow-ray
(any-hit) traversal runs too.
"""

from __future__ import annotations

import numpy as np

from paths_tpu_torch.scene import desc as D


def generate_stress_scene(num_spheres: int = 500, seed: int = 0) -> D.SceneDescription:
    rng = np.random.default_rng(seed)
    sd = D.SceneDescription()
    sd.camera = D.CameraD(
        image_width=720, image_height=480,
        location=D.Vec3D(0.0, -5.0, -13.0),
        orientation=D.RotationD(pitch=0.0, yaw=0.0, roll=-0.3),
        sensor_width=0.036, sensor_height=0.024,
        focal_length=0.05, focus_distance=10.0, aperture=8.0,
    )
    sd.skybox = D.SkyboxD(kind="flat", colour=D.ColourD(0.8, 0.8, 0.8))
    for _ in range(num_spheres):
        center = D.Vec3D(
            rng.uniform() * 100.0 - 50.0,
            rng.uniform() * 100.0 - 50.0,
            rng.uniform() * 100.0,
        )
        radius = rng.uniform() * 5.0
        choice = rng.integers(0, 3)
        colour = D.ColourD(rng.uniform(), rng.uniform(), rng.uniform())
        if choice == 0:
            m = D.MaterialD(kind="gloss", albedo=D.MaterialColourD(colour=colour),
                            reflectance=1.0 + rng.uniform() * 2.0, metalness=0.0)
        elif choice == 1:
            m = D.MaterialD(kind="lambertian", albedo=D.MaterialColourD(colour=colour))
        else:
            m = D.MaterialD(kind="mirror")
        sd.objects.append(
            D.ObjectD(shape_kind="sphere", sphere=D.SphereD(center, radius), material=m)
        )
    return sd


# The stress scene's sphere light: in front of the field, below the camera's
# line of sight.
STRESS_LIGHT = dict(position=(0.0, -5.0, -30.0), radius=4.0, intensity=100.0)


def generate_lit_stress_scene(num_spheres: int = 500, seed: int = 0) -> D.SceneDescription:
    """The stress scene plus one sphere light (STRESS_LIGHT)."""
    sd = generate_stress_scene(num_spheres, seed)
    sd.lights.append(D.LightD(
        kind="sphere", position=D.Vec3D(*STRESS_LIGHT["position"]),
        radius=STRESS_LIGHT["radius"], intensity=STRESS_LIGHT["intensity"],
    ))
    return sd
