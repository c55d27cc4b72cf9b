"""Procedural scenes (a copy of ``paths_tpu/scene/stress.py``): the stress
scene of N random spheres (reference: src/stress.rs) and the mixed
sphere + mesh + area-light scene.

Seeded, unlike the reference's thread_rng, so renders are reproducible.
``generate_lit_stress_scene`` adds one sphere light, so the shadow-ray
(any-hit) traversal runs too.
"""

from __future__ import annotations

import os

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


def generate_mixed_scene(asset_dir: str, n_spheres: int = 3, grid_n: int = 9,
                         seed: int = 7) -> D.SceneDescription:
    """Small but kernel-complete scene: a bumpy grid mesh (128 triangles, so
    the triangle kernels engage), spheres over every material class, and a
    sphere area light.  ``n_spheres > 32`` engages the sphere kernels too.
    Writes ``grid.obj`` into asset_dir."""
    n = grid_n
    xs = np.linspace(-2, 2, n)
    zs = np.linspace(-2, 2, n)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = 0.3 * np.sin(2 * X) * np.cos(2 * Z)
    lines = []
    for i in range(n):
        for j in range(n):
            lines.append(f"v {X[i, j]} {Y[i, j]} {Z[i, j]}")
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j + 1
            b = (i + 1) * n + j + 1
            c = i * n + j + 2
            d = (i + 1) * n + j + 2
            lines.append(f"f {a} {b} {c}")
            lines.append(f"f {c} {b} {d}")
    obj_path = os.path.join(asset_dir, "grid.obj")
    with open(obj_path, "w") as f:
        f.write("\n".join(lines) + "\n")

    sd = D.SceneDescription()
    sd.camera = D.CameraD(
        image_width=16, image_height=16,
        location=D.Vec3D(0.0, 2.0, -6.0),
        orientation=D.RotationD(pitch=0.3, yaw=0.0, roll=0.0),
        sensor_width=0.036, sensor_height=0.024,
        focal_length=0.05, focus_distance=6.0, aperture=8.0,
    )
    sd.skybox = D.SkyboxD(
        kind="gradient",
        overhead_colour=D.ColourD(0.2, 0.3, 0.7),
        horizon_colour=D.ColourD(0.7, 0.7, 0.8),
    )
    sd.models = {"grid": obj_path}
    sd.objects = [
        D.ObjectD(
            shape_kind="mesh",
            mesh=D.MeshD(model="grid", smooth_normals=True, scale=1.0),
            material=D.MaterialD(
                kind="gloss",
                albedo=D.MaterialColourD(colour=D.ColourD(0.7, 0.4, 0.3)),
                reflectance=0.1, metalness=0.0,
            ),
        ),
        D.ObjectD(
            shape_kind="sphere",
            sphere=D.SphereD(center=D.Vec3D(1.0, 1.0, 0.0), radius=0.7),
            material=D.MaterialD(kind="mirror"),
        ),
        D.ObjectD(
            shape_kind="sphere",
            sphere=D.SphereD(center=D.Vec3D(-1.2, 0.8, 0.5), radius=0.5),
            material=D.MaterialD(
                kind="lambertian",
                albedo=D.MaterialColourD(colour=D.ColourD(0.3, 0.6, 0.3)),
            ),
        ),
    ]
    rng = np.random.default_rng(seed)
    for _ in range(max(0, n_spheres - 2)):
        sd.objects.append(D.ObjectD(
            shape_kind="sphere",
            sphere=D.SphereD(
                center=D.Vec3D(rng.uniform(-4, 4), rng.uniform(0.2, 3.0),
                               rng.uniform(-3, 4)),
                radius=rng.uniform(0.1, 0.4),
            ),
            material=D.MaterialD(
                kind="lambertian",
                albedo=D.MaterialColourD(colour=D.ColourD(
                    rng.uniform(), rng.uniform(), rng.uniform())),
            ),
        ))
    sd.lights = [
        D.LightD(kind="sphere", position=D.Vec3D(0.0, 6.0, -1.0),
                 radius=0.8, colour=D.ColourD(1, 1, 1), intensity=40.0),
    ]
    sd.base_dir = asset_dir
    return sd
