"""YAML scene loader (port of ``paths_tpu/scene/yaml_loader.py``).

Parses the reference's scene schema (src/serde.rs) into SceneDescription,
leniently where upstream's serde is strict: ``albedo: {r,g,b}`` without a
``type: Rgb`` tag is Rgb, and missing ``lights:`` / ``models:`` / gloss
``metalness`` default to [] / {} / 0.0.

``yaml`` is imported only when a YAML file is loaded, so the stress-scene
path needs no YAML package.
"""

from __future__ import annotations

import os

from paths_tpu_torch.scene import desc as D


def _vec(d, default=(0.0, 0.0, 0.0)) -> D.Vec3D:
    if d is None:
        return D.Vec3D(*default)
    return D.Vec3D(float(d.get("x", 0.0)), float(d.get("y", 0.0)), float(d.get("z", 0.0)))


def _rot(d) -> D.RotationD:
    if d is None:
        return D.RotationD()
    return D.RotationD(
        float(d.get("pitch", 0.0)), float(d.get("yaw", 0.0)), float(d.get("roll", 0.0))
    )


def _colour(d, default=(0.0, 0.0, 0.0)) -> D.ColourD:
    if d is None:
        return D.ColourD(*default)
    return D.ColourD(float(d.get("r", 0.0)), float(d.get("g", 0.0)), float(d.get("b", 0.0)))


def _material_colour(d) -> D.MaterialColourD:
    if d is None:
        return D.MaterialColourD(colour=D.ColourD(1.0, 1.0, 1.0))
    tag = str(d.get("type", "Rgb")).lower()
    if tag == "vertex":
        return D.MaterialColourD(is_vertex=True)
    return D.MaterialColourD(colour=_colour(d))


def _material(d) -> D.MaterialD:
    if d is None:
        return D.MaterialD(kind="auto")
    kind = str(d.get("type", "Lambertian")).lower()
    if kind in ("cooktorrance", "cook_torrance"):
        kind = "cook_torrance"
    m = D.MaterialD(kind=kind)
    if kind == "lambertian":
        m.albedo = _material_colour(d.get("albedo"))
    elif kind == "gloss":
        m.albedo = _material_colour(d.get("albedo"))
        m.reflectance = float(d.get("reflectance", 0.0))
        m.metalness = float(d.get("metalness", 0.0))
    elif kind == "mirror":
        pass
    elif kind == "cook_torrance":
        m.albedo = _material_colour(d.get("albedo"))
        m.roughness = float(d.get("roughness", 0.5))
    elif kind == "fresnel":
        m.refractive_index = float(d.get("refractive_index", 1.5))
        m.diffuse = _material(d.get("diffuse"))
        m.specular = _material(d.get("specular"))
    elif kind == "auto":
        pass
    else:
        raise ValueError(f"Unknown material type: {d.get('type')}")
    return m


def _object(d) -> D.ObjectD:
    shape = d.get("shape", {})
    kind = str(shape.get("type", "Sphere")).lower()
    obj = D.ObjectD(material=_material(d.get("material")))
    if kind == "sphere":
        obj.shape_kind = "sphere"
        obj.sphere = D.SphereD(_vec(shape.get("center")), float(shape.get("radius", 1.0)))
    elif kind == "mesh":
        obj.shape_kind = "mesh"
        obj.mesh = D.MeshD(
            model=str(shape.get("model", "")),
            smooth_normals=bool(shape.get("smooth_normals", True)),
            translation=_vec(shape.get("translation")),
            rotation=_rot(shape.get("rotation")),
            scale=float(shape.get("scale", 1.0)),
        )
    else:
        raise ValueError(f"Unknown shape type: {shape.get('type')}")
    return obj


def _light(d) -> D.LightD:
    geom = d.get("geometry")
    if geom is None:
        raise ValueError(
            "light is missing its 'geometry:' block (expected e.g. "
            "geometry: {type: Sphere, center: {...}, radius: r})"
        )
    kind = str(geom.get("type", "Point")).lower()
    light = D.LightD(
        kind=kind,
        colour=_colour(d.get("colour"), (1.0, 1.0, 1.0)),
        intensity=float(d.get("intensity", 1.0)),
    )
    if kind == "point":
        # serde.rs:211: Point(VectorDescription) -- position inline.
        light.position = _vec(geom if "x" in geom else geom.get("position"))
    elif kind == "sphere":
        light.position = _vec(geom.get("center"))
        light.radius = float(geom.get("radius", 1.0))
    else:
        raise ValueError(f"Unknown light geometry: {geom.get('type')}")
    return light


def _skybox(d) -> D.SkyboxD:
    if d is None:
        return D.SkyboxD(kind="flat")
    kind = str(d.get("type", "Flat")).lower()
    sky = D.SkyboxD(kind=kind)
    if kind == "flat":
        sky.colour = _colour(d.get("colour"))
    elif kind == "gradient":
        sky.overhead_colour = _colour(d.get("overhead_colour"))
        sky.horizon_colour = _colour(d.get("horizon_colour"))
    elif kind == "hdri":
        sky.filename = str(d.get("filename", ""))
    else:
        raise ValueError(f"Unknown skybox type: {d.get('type')}")
    return sky


def _camera(d) -> D.CameraD:
    return D.CameraD(
        image_width=int(d.get("image_width", 720)),
        image_height=int(d.get("image_height", 480)),
        location=_vec(d.get("location")),
        orientation=_rot(d.get("orientation")),
        sensor_width=float(d.get("sensor_width", 0.036)),
        sensor_height=float(d.get("sensor_height", 0.024)),
        focal_length=float(d.get("focal_length", 0.05)),
        focus_distance=float(d.get("focus_distance", 10.0)),
        aperture=float(d.get("aperture", 8.0)),
    )


def parse_scene_dict(data: dict, base_dir: str = ".") -> D.SceneDescription:
    models = {
        str(name): str(m.get("file", "")) for name, m in (data.get("models") or {}).items()
    }
    return D.SceneDescription(
        camera=_camera(data.get("camera", {})),
        objects=[_object(o) for o in (data.get("objects") or [])],
        lights=[_light(l) for l in (data.get("lights") or [])],
        skybox=_skybox(data.get("skybox")),
        models=models,
        base_dir=base_dir,
    )


def load_scene_description(path: str) -> D.SceneDescription:
    """Load a scene YAML file; asset paths resolve relative to the scene
    file's directory."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return parse_scene_dict(data, base_dir=os.path.dirname(os.path.abspath(path)))
