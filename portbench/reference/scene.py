"""The reference's own scene build: from a configuration's scene (the
upstream YAML schema, held as JSON) to flat tensors, with nothing taken from
the program under test.

It reads the same scene dictionary and the same PLY file the program is
given and works out again what the program's set-up derives: world-space
triangles (rotation @ v * scale + translation, geom.rs:251-261), face
normals (model.rs:226-249), the entity table of materials and lights
(serde.rs:81-155), and the camera.  Only what the benchmark's scenes use is
supported (spheres, PLY meshes, sphere lights, Lambertian, Gloss and Mirror
materials, flat and gradient skies); anything else raises.

Spheres are tested by brute force: the big or far ones (``BIG_SPHERE``)
in f64, the others in f32 with the fused multiply-adds the program's sphere
kernels are stated to issue.  Its triangle acceleration structure is its
own (``clusters``): triangles sorted by
the Morton code of their centroids and cut into clusters of
``CLUSTER`` triangles, each with its box.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import camera as C
from portbench.reference import materials as M
from portbench.reference import matrix as mat

CLUSTER = 32
# A sphere with a radius or a centre coordinate past this is tested in f64
# (the f32 test loses a radius-1e6 ground plane's scale).
BIG_SPHERE = 1e3
FLAT, GRADIENT = 0, 1


@dataclass
class RefScene:
    # spheres, the big ones first (n_big): centres and radii in f64 for
    # their f64 test; f32 centres and squared radii for the others'.
    sph_c64: torch.Tensor
    sph_r64: torch.Tensor
    sph_center: torch.Tensor
    sph_r2: torch.Tensor
    sph_ent: torch.Tensor
    n_big: int
    # triangles (f32), in cluster order.
    tri_v0: torch.Tensor
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_n: torch.Tensor
    tri_vc0: torch.Tensor
    tri_vc1: torch.Tensor
    tri_vc2: torch.Tensor
    tri_ent: torch.Tensor
    box_lo: torch.Tensor  # (clusters, 3)
    box_hi: torch.Tensor
    # entities (materials; lights appended after objects)
    mat_mtype: torch.Tensor
    mat_albedo: torch.Tensor
    mat_vertex: torch.Tensor
    mat_r0: torch.Tensor
    mat_metalness: torch.Tensor
    ent_is_light: torch.Tensor
    ent_emission: torch.Tensor
    # lights
    light_pos: torch.Tensor
    light_radius: torch.Tensor
    light_colour: torch.Tensor
    light_intensity: torch.Tensor
    light_ent: torch.Tensor
    n_lights: int
    n_spheres: int
    n_tris: int
    sky_type: int
    sky_a: torch.Tensor
    sky_b: torch.Tensor
    camera: C.Camera
    max_bounces: int = 10


def read_ply(path: str):
    """(vertices f64 (V, 3), faces int64 (F, 3), colours f64 (V, 3) or
    None) of a binary little-endian PLY with float x, y, z, optional uchar
    red, green, blue, and a face list of uchar count and int indices, all
    triangles."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header")
    body = data[data.index(b"\n", end) + 1:]
    header = data[:end].decode("ascii").splitlines()
    if "format binary_little_endian 1.0" not in header:
        raise ValueError(f"{path}: only binary little-endian PLY is supported")
    n_v = n_f = 0
    props = []
    elem = None
    for line in header:
        p = line.split()
        if p[:1] == ["element"]:
            elem = p[1]
            if elem == "vertex":
                n_v = int(p[2])
            elif elem == "face":
                n_f = int(p[2])
        elif p[:1] == ["property"] and elem == "vertex":
            props.append((p[2], {"float": "<f4", "uchar": "u1"}[p[1]]))
    vdt = np.dtype(props)
    v = np.frombuffer(body, vdt, n_v, 0)
    fdt = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
    f = np.frombuffer(body, fdt, n_f, vdt.itemsize * n_v)
    if not (f["n"] == 3).all():
        raise ValueError(f"{path}: only triangle faces are supported")
    verts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    cols = None
    if "red" in vdt.names:
        cols = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float64) / 255.0
    return verts, f["i"].astype(np.int64), cols


def _face_normals(verts, faces):
    """normalize((v2-v1) x (v3-v1)), retried with (v2-v1) x (v3-v2) where
    degenerate (model.rs:226-249)."""
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    with np.errstate(invalid="ignore", divide="ignore"):
        n = np.cross(b - a, c - a)
        n = n / np.linalg.norm(n, axis=1, keepdims=True)
        bad = np.isnan(n).any(axis=1)
        if bad.any():
            n2 = np.cross((b - a)[bad], (c - b)[bad])
            n[bad] = n2 / np.linalg.norm(n2, axis=1, keepdims=True)
    return n


def _v(d, default=(0.0, 0.0, 0.0)):
    if d is None:
        return np.array(default, np.float64)
    return np.array([float(d.get(k, 0.0)) for k in "xyz"])


def _c(d, default=(0.0, 0.0, 0.0)):
    if d is None:
        return np.array(default, np.float64)
    return np.array([float(d.get(k, 0.0)) for k in "rgb"])


def _material(d):
    """(mtype, albedo, vertex, r0, metalness) of a material block."""
    kind = str((d or {}).get("type", "Lambertian")).lower()
    alb = (d or {}).get("albedo")
    vertex = alb is not None and str(alb.get("type", "Rgb")).lower() == "vertex"
    colour = np.ones(3) if alb is None or vertex else _c(alb)
    if kind == "lambertian":
        return M.LAMBERTIAN, colour, vertex, 0.0, 0.0
    if kind == "mirror":
        return M.MIRROR, np.ones(3), False, 0.0, 0.0
    if kind == "gloss":
        return (M.GLOSS, colour, vertex, float(d.get("reflectance", 0.0)),
                float(d.get("metalness", 0.0)))
    raise ValueError(f"the reference does not support material {kind}")


def morton_order(points: np.ndarray) -> np.ndarray:
    """Indices sorting points by the 30-bit Morton code of their position in
    their bounding box."""
    lo, hi = points.min(axis=0), points.max(axis=0)
    q = ((points - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64)
    code = np.zeros(len(points), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + (2 - axis))
    return np.argsort(code, kind="stable")


def build(scene: dict, base_dir: str, device) -> RefScene:
    """The reference's arrays of a configuration's scene dictionary on
    `device`.  Model files resolve against base_dir."""
    rows = []  # (mtype, albedo, vertex, r0, metal)
    sph_c, sph_r, sph_e = [], [], []
    tris = []
    models = {k: v["file"] for k, v in (scene.get("models") or {}).items()}
    for o in scene.get("objects") or []:
        shape = o["shape"]
        kind = str(shape.get("type", "Sphere")).lower()
        rows.append(_material(o.get("material")))
        ent = len(rows) - 1
        if kind == "sphere":
            sph_c.append(_v(shape.get("center")))
            sph_r.append(float(shape.get("radius", 1.0)))
            sph_e.append(ent)
            continue
        if kind != "mesh":
            raise ValueError(f"the reference does not support shape {kind}")
        verts, faces, cols = read_ply(os.path.join(base_dir, models[shape["model"]]))
        if bool(shape.get("smooth_normals", True)):
            raise ValueError("the reference does not support smooth normals")
        r = shape.get("rotation") or {}
        rot = mat.mesh_rotation(float(r.get("pitch", 0.0)), float(r.get("yaw", 0.0)),
                                float(r.get("roll", 0.0)))
        fn = _face_normals(verts, faces) @ rot.T
        w = verts @ rot.T * float(shape.get("scale", 1.0)) + _v(shape.get("translation"))
        ok = ~np.isnan(fn).any(axis=1)
        faces, fn = faces[ok], fn[ok]
        cols = np.ones_like(verts) if cols is None else cols
        tris.append(dict(v0=w[faces[:, 0]], v1=w[faces[:, 1]], v2=w[faces[:, 2]], n=fn,
                         vc0=cols[faces[:, 0]], vc1=cols[faces[:, 1]],
                         vc2=cols[faces[:, 2]], ent=np.full(len(faces), ent)))
    lights = []
    for lt in scene.get("lights") or []:
        g = lt["geometry"]
        if str(g.get("type")).lower() != "sphere":
            raise ValueError("the reference supports sphere lights only")
        rows.append((M.LAMBERTIAN, np.zeros(3), False, 0.0, 0.0))
        ent = len(rows) - 1
        pos, rad = _v(g.get("center")), float(g.get("radius", 1.0))
        colour, inten = _c(lt.get("colour"), (1.0, 1.0, 1.0)), float(lt.get("intensity", 1.0))
        lights.append((pos, rad, colour, inten, ent))
        sph_c.append(pos)
        sph_r.append(rad)
        sph_e.append(ent)

    # Big or far spheres (a radius or a centre coordinate past BIG_SPHERE,
    # the ground planes) first.
    sph_c = np.asarray(sph_c, np.float64).reshape(-1, 3)
    sph_r = np.asarray(sph_r, np.float64)
    big = (sph_r > BIG_SPHERE) | (np.abs(sph_c).max(axis=1, initial=0.0) > BIG_SPHERE)
    first = np.concatenate([np.nonzero(big)[0], np.nonzero(~big)[0]])
    sph_c, sph_r, sph_e = sph_c[first], sph_r[first], np.asarray(sph_e, np.int64)[first]

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    n_ent = len(rows)
    emission = np.zeros((n_ent, 3))
    is_light = np.zeros(n_ent, bool)
    for pos, rad, colour, inten, ent in lights:
        emission[ent] = colour * inten
        is_light[ent] = True

    if tris:
        t = {k: np.concatenate([p[k] for p in tris]) for k in tris[0]}
        order = morton_order((t["v0"] + t["v1"] + t["v2"]) / 3.0)
        t = {k: v[order] for k, v in t.items()}
        n_tris = len(order)
        lo = np.minimum(np.minimum(t["v0"], t["v1"]), t["v2"])
        hi = np.maximum(np.maximum(t["v0"], t["v1"]), t["v2"])
        pad = (-n_tris) % CLUSTER
        lo = np.concatenate([lo, np.full((pad, 3), np.inf)]).reshape(-1, CLUSTER, 3).min(axis=1)
        hi = np.concatenate([hi, np.full((pad, 3), -np.inf)]).reshape(-1, CLUSTER, 3).max(axis=1)
    else:
        z = np.zeros((0, 3))
        t = dict(v0=z, v1=z, v2=z, n=z, vc0=z, vc1=z, vc2=z, ent=np.zeros(0))
        n_tris, lo, hi = 0, np.zeros((0, 3)), np.zeros((0, 3))

    sky = scene.get("skybox") or {}
    skind = str(sky.get("type", "Flat")).lower()
    if skind == "flat":
        sky_type, sky_a, sky_b = FLAT, _c(sky.get("colour")), np.zeros(3)
    elif skind == "gradient":
        sky_type = GRADIENT
        sky_a, sky_b = _c(sky.get("overhead_colour")), _c(sky.get("horizon_colour"))
    else:
        raise ValueError(f"the reference does not support sky {skind}")

    cam = scene["camera"]
    o = cam.get("orientation") or {}
    camera = C.make_camera(
        width=int(cam["image_width"]), height=int(cam["image_height"]),
        location=_v(cam.get("location")).tolist(),
        orientation=(float(o.get("pitch", 0.0)), float(o.get("yaw", 0.0)),
                     float(o.get("roll", 0.0))),
        sensor_width=float(cam["sensor_width"]), sensor_height=float(cam["sensor_height"]),
        focal_length=float(cam["focal_length"]), focus_distance=float(cam["focus_distance"]),
        aperture=float(cam["aperture"]), device=device)

    lp = [l[0] for l in lights] or [np.zeros(3)]
    return RefScene(
        sph_c64=torch.as_tensor(sph_c, device=device),
        sph_r64=torch.as_tensor(sph_r, device=device),
        sph_center=f32(sph_c), sph_r2=f32(sph_r * sph_r), sph_ent=i64(sph_e),
        n_big=int(big.sum()),
        tri_v0=f32(t["v0"]), tri_v1=f32(t["v1"]), tri_v2=f32(t["v2"]), tri_n=f32(t["n"]),
        tri_vc0=f32(t["vc0"]), tri_vc1=f32(t["vc1"]), tri_vc2=f32(t["vc2"]),
        tri_ent=i64(t["ent"]), box_lo=f32(lo), box_hi=f32(hi),
        mat_mtype=i64([r[0] for r in rows]), mat_albedo=f32([r[1] for r in rows]),
        mat_vertex=torch.as_tensor([r[2] for r in rows], device=device),
        mat_r0=f32([r[3] for r in rows]), mat_metalness=f32([r[4] for r in rows]),
        ent_is_light=torch.as_tensor(is_light, device=device), ent_emission=f32(emission),
        light_pos=f32(lp), light_radius=f32([l[1] for l in lights] or [0.0]),
        light_colour=f32([l[2] for l in lights] or [np.zeros(3)]),
        light_intensity=f32([l[3] for l in lights] or [0.0]),
        light_ent=i64([l[4] for l in lights] or [0]),
        n_lights=len(lights), n_spheres=len(sph_c), n_tris=n_tris,
        sky_type=sky_type, sky_a=f32(sky_a), sky_b=f32(sky_b), camera=camera)
