"""Scene description dataclasses -- the YAML schema (a copy of
``paths_tpu/scene/desc.py``).

Mirrors the reference's serde layer (src/serde.rs:16-357): camera in physical
units, objects (Sphere|Mesh), materials (Auto|Lambertian|Gloss|Mirror|
CookTorrance|Fresnel), lights (Point|Sphere), skybox (Flat|Gradient|Hdri),
named models.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Vec3D:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0

    def tolist(self):
        return [self.x, self.y, self.z]


@dataclass
class RotationD:
    pitch: float = 0.0
    yaw: float = 0.0
    roll: float = 0.0


@dataclass
class ColourD:
    r: float = 0.0
    g: float = 0.0
    b: float = 0.0

    def tolist(self):
        return [self.r, self.g, self.b]


@dataclass
class MaterialColourD:
    """serde.rs:42-56: Rgb {r,g,b} or Vertex."""

    is_vertex: bool = False
    colour: ColourD = field(default_factory=ColourD)


@dataclass
class CameraD:
    """serde.rs:157-170."""

    image_width: int = 720
    image_height: int = 480
    location: Vec3D = field(default_factory=Vec3D)
    orientation: RotationD = field(default_factory=RotationD)
    sensor_width: float = 0.036
    sensor_height: float = 0.024
    focal_length: float = 0.05
    focus_distance: float = 10.0
    aperture: float = 8.0


@dataclass
class MaterialD:
    """Tagged union over serde.rs:254-333.  kind in
    {auto, lambertian, gloss, mirror, cook_torrance, fresnel}."""

    kind: str = "lambertian"
    albedo: MaterialColourD = field(default_factory=MaterialColourD)
    reflectance: float = 0.0  # gloss fresnel_r0
    metalness: float = 0.0
    roughness: float = 0.0  # cook-torrance
    refractive_index: float = 1.5  # fresnel
    diffuse: Optional["MaterialD"] = None  # fresnel sub-materials
    specular: Optional["MaterialD"] = None


@dataclass
class SphereD:
    center: Vec3D = field(default_factory=Vec3D)
    radius: float = 1.0


@dataclass
class MeshD:
    """serde.rs:239-252."""

    model: str = ""
    smooth_normals: bool = True  # serde.rs:250-252 default
    translation: Vec3D = field(default_factory=Vec3D)
    rotation: RotationD = field(default_factory=RotationD)
    scale: float = 1.0


@dataclass
class ObjectD:
    shape_kind: str = "sphere"  # sphere | mesh
    sphere: Optional[SphereD] = None
    mesh: Optional[MeshD] = None
    material: MaterialD = field(default_factory=MaterialD)


@dataclass
class LightD:
    """serde.rs:202-224: Point or Sphere geometry."""

    kind: str = "point"  # point | sphere
    position: Vec3D = field(default_factory=Vec3D)
    radius: float = 0.0
    colour: ColourD = field(default_factory=lambda: ColourD(1, 1, 1))
    intensity: float = 1.0


@dataclass
class SkyboxD:
    kind: str = "flat"  # flat | gradient | hdri
    colour: ColourD = field(default_factory=ColourD)
    overhead_colour: ColourD = field(default_factory=ColourD)
    horizon_colour: ColourD = field(default_factory=ColourD)
    filename: str = ""


@dataclass
class SceneDescription:
    """serde.rs:65-74."""

    camera: CameraD = field(default_factory=CameraD)
    objects: list[ObjectD] = field(default_factory=list)
    lights: list[LightD] = field(default_factory=list)
    skybox: SkyboxD = field(default_factory=SkyboxD)
    models: dict[str, str] = field(default_factory=dict)  # name -> filepath
    base_dir: str = "."  # directory for resolving relative asset paths
