"""Scene build: description -> flattened SoA tensors (port of
``paths_tpu/scene/build.py``).

Reference: Scene::new (scene.rs:143-170) and SceneDescription::scene
(serde.rs:81-155): meshes are expanded to world-space triangles (rotation @
v * scale + translation, geom.rs:251-261), area lights contribute their
sphere primitive, materials resolve (Auto pulls the OBJ diffuse, else white
Lambertian, serde.rs:126-131), and everything lands in SceneArrays.  Host
math runs in f64 and is cast to f32 on upload.

Spheres split as in the reference: big or far spheres (radius or any centre
coordinate past 1e3, the radius-1e6 ground planes) stay on the
double-single path; when more than 32 small spheres remain they are
morton-packed for the traversal kernels and the scene arrays are put in the
packed order, so sphere ids equal the reference package's.  With
``PATHS_TPU_SPH_FLAT=1`` (read once, here) and a table of at most
``SPH_FLAT_MAX_ROWS`` rows they take the flat kernel instead of the walk.
Triangles take one of three routes.  By default (``bvh_threshold=None``)
meshes of more than 64 triangles in all are BVH-ordered and packed for the
triangle kernels (the reference's accelerator or forced-kernel build), and
at most 64 take the unrolled scan in the integrator.  With an integer
``bvh_threshold`` the reference's CPU rule applies instead: more triangles
than that take the BVH route (the skip-link BVH packed for K6,
``ops/packet_traverse.py``), and at most that many take the scan.  No
choice depends on the device: on the CPU the kernel wrappers run their
plain versions.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from paths_tpu_torch import lights as LT
from paths_tpu_torch import materials as M
from paths_tpu_torch import resolve_device
from paths_tpu_torch import sky as SK
from paths_tpu_torch.bvh.build import build_bvh
from paths_tpu_torch.camera import make_camera
from paths_tpu_torch.math import matrix as mat
from paths_tpu_torch.ops import chunk_scan as CS
from paths_tpu_torch.ops import packet_traverse as PK
from paths_tpu_torch.ops import sphere_traverse as ST
from paths_tpu_torch.ops import tri_traverse as TT
from paths_tpu_torch.scene import desc as D
from paths_tpu_torch.scene.hdr_loader import load_hdr
from paths_tpu_torch.scene.models import ModelLibrary
from paths_tpu_torch.scene.types import SceneArrays, SceneStatic

_NO_SUB = (M.LAMBERTIAN, np.zeros(3), 0.0, 0.0, 0.0)  # (mtype, albedo, r0, metal, rough)

# More small spheres than this go to the packed table and the kernels.
KERNEL_MIN_SPHERES = 32
# More triangles than this go to the packed table and the kernels.
KERNEL_MIN_TRIS = 64


def _basic_sub_row(m: D.MaterialD):
    """BasicMaterial (serde.rs:267-272) -> (mtype, albedo, r0, metalness,
    roughness)."""
    kind = m.kind
    if kind == "lambertian":
        return (M.LAMBERTIAN, np.array(m.albedo.colour.tolist()), 0.0, 0.0, 0.0)
    if kind == "mirror":
        return (M.MIRROR, np.ones(3), 0.0, 0.0, 0.0)
    if kind == "gloss":
        return (M.GLOSS, np.array(m.albedo.colour.tolist()), m.reflectance,
                m.metalness, 0.0)
    if kind == "cook_torrance":
        return (M.COOK_TORRANCE, np.array(m.albedo.colour.tolist()), 0.0, 0.0,
                m.roughness)
    raise ValueError(f"Material kind {kind} is not a BasicMaterial")


def _material_row(m: D.MaterialD, model_diffuse=None):
    """MaterialD -> SoA fields (mtype, albedo, vertex_flag, emit, r0,
    metalness, roughness, fd_mtype, fs_row, fresnel_r0)."""
    kind = m.kind
    if kind == "auto":
        # serde.rs:126-131: OBJ diffuse as Lambertian, else white Lambertian.
        albedo = model_diffuse if model_diffuse is not None else np.ones(3)
        return (M.LAMBERTIAN, np.asarray(albedo, np.float64), False, np.zeros(3),
                0.0, 0.0, 0.0, M.LAMBERTIAN, _NO_SUB, 0.0)
    if kind == "lambertian":
        return (M.LAMBERTIAN, np.array(m.albedo.colour.tolist()), m.albedo.is_vertex,
                np.zeros(3), 0.0, 0.0, 0.0, M.LAMBERTIAN, _NO_SUB, 0.0)
    if kind == "mirror":
        return (M.MIRROR, np.ones(3), False, np.zeros(3), 0.0, 0.0, 0.0,
                M.LAMBERTIAN, _NO_SUB, 0.0)
    if kind == "gloss":
        return (M.GLOSS, np.array(m.albedo.colour.tolist()), m.albedo.is_vertex,
                np.zeros(3), m.reflectance, m.metalness, 0.0,
                M.LAMBERTIAN, _NO_SUB, 0.0)
    if kind == "cook_torrance":
        return (M.COOK_TORRANCE, np.array(m.albedo.colour.tolist()), False,
                np.zeros(3), 0.0, 0.0, m.roughness, M.LAMBERTIAN, _NO_SUB, 0.0)
    if kind == "fresnel":
        # FresnelCombination (material.rs:373-428): r0 = ((1-n)/(1+n))^2;
        # diffuse sub-material in the primary columns, specular in fs_.
        n2 = m.refractive_index
        fresnel_r0 = ((1.0 - n2) / (1.0 + n2)) ** 2
        diffuse = m.diffuse if m.diffuse is not None else D.MaterialD(kind="lambertian")
        specular = m.specular if m.specular is not None else D.MaterialD(kind="mirror")
        fd_mtype, d_alb, d_r0, d_metal, d_rough = _basic_sub_row(diffuse)
        is_vertex = diffuse.albedo.is_vertex if diffuse.kind != "mirror" else False
        return (M.FRESNEL, d_alb, is_vertex, np.zeros(3), d_r0, d_metal, d_rough,
                fd_mtype, _basic_sub_row(specular), fresnel_r0)
    raise ValueError(f"Unknown material kind {kind}")


_LIGHT_ROW = (M.LAMBERTIAN, np.zeros(3), False, np.zeros(3), 0.0, 0.0, 0.0,
              M.LAMBERTIAN, _NO_SUB, 0.0)


def _mesh_triangles(mesh: D.MeshD, model, ent: int) -> dict:
    """One model of a mesh object as world-space triangle arrays
    (build.py:160-209 of the reference): rotation, scale and translation
    baked (geom.rs:251-261); degenerate (NaN-normal) faces dropped; smooth
    normals rotated, falling back to the face normal where a vertex has no
    valid face; vertex colours, else ones."""
    rot = mat.mesh_rotation(mesh.rotation.pitch, mesh.rotation.yaw, mesh.rotation.roll)
    if mesh.smooth_normals:
        model.compute_vertex_normals()
    verts_w = model.vertices @ rot.T * mesh.scale + np.array(mesh.translation.tolist())
    fn_w = model.face_normals @ rot.T  # geom.rs:259
    ok = ~np.isnan(fn_w).any(axis=1)  # model.rs:174-192
    faces = model.faces[ok]
    n_w = fn_w[ok]
    smooth = mesh.smooth_normals and model.vertex_normals is not None
    if smooth:
        vn_w = model.vertex_normals @ rot.T  # scene.rs:184
        vn = [vn_w[faces[:, k]] for k in range(3)]
        for arr in vn:
            bad = np.isnan(arr).any(axis=1)
            arr[bad] = n_w[bad]
    else:
        vn = [n_w] * 3
    if model.vertex_colours is not None:
        vc = [model.vertex_colours[faces[:, k]] for k in range(3)]
    else:
        vc = [np.ones((len(faces), 3))] * 3
    return dict(v0=verts_w[faces[:, 0]], v1=verts_w[faces[:, 1]],
                v2=verts_w[faces[:, 2]], n=n_w,
                vn0=vn[0], vn1=vn[1], vn2=vn[2], vc0=vc[0], vc1=vc[1], vc2=vc[2],
                ent=np.full(len(faces), ent, np.int64),
                smooth=np.full(len(faces), smooth, bool))


def build_scene(sd: D.SceneDescription, device=None, bvh_threshold=None):
    """Returns (static, scene_arrays, camera) on ``device`` (default cuda;
    raises without a CUDA device unless device="cpu").  Model files and an
    HDRI sky's image resolve against the working directory, the scene's
    directory and its parent.

    bvh_threshold: None sends meshes of more than 64 triangles to the
    triangle kernels; an integer sends more triangles than that to the BVH
    route and at most that many to the scan (the reference's rule on the
    CPU, where its default is 32768)."""
    device = resolve_device(device)
    search_dirs = [".", sd.base_dir, os.path.dirname(sd.base_dir)]
    library = ModelLibrary(search_dirs=search_dirs)
    for name, filepath in sd.models.items():
        library.declare(name, filepath)
    sph_center, sph_radius, sph_ent = [], [], []
    tri_parts = []  # per mesh model: dict of triangle arrays
    rows = []  # entity/material rows: objects first, lights appended after

    for o in sd.objects:
        if o.shape_kind == "sphere":
            rows.append(_material_row(o.material))
            sph_center.append(np.array(o.sphere.center.tolist()))
            sph_radius.append(o.sphere.radius)
            sph_ent.append(len(rows) - 1)
            continue
        for ix in library.load(o.mesh.model):
            model = library.get(ix)
            rows.append(_material_row(o.material, model.diffuse))
            tri_parts.append(_mesh_triangles(o.mesh, model, len(rows) - 1))

    # Lights (scene.rs:155-164: area lights also become primitives).
    l_type, l_pos, l_rad, l_col, l_int, l_ent = [], [], [], [], [], []
    for l in sd.lights:
        rows.append(_LIGHT_ROW)
        ent = len(rows) - 1
        l_ent.append(ent)
        l_type.append(LT.POINT if l.kind == "point" else LT.SPHERE)
        l_pos.append(np.array(l.position.tolist()))
        l_rad.append(l.radius)
        l_col.append(np.array(l.colour.tolist()))
        l_int.append(l.intensity)
        if l.kind == "sphere":
            sph_center.append(np.array(l.position.tolist()))
            sph_radius.append(l.radius)
            sph_ent.append(ent)

    n_entities = max(1, len(rows))
    n_lights = len(sd.lights)
    while len(rows) < n_entities:
        rows.append(_LIGHT_ROW)

    # ---- entity table ----
    mtype = np.array([r[0] for r in rows], np.int32)
    albedo = np.stack([r[1] for r in rows]).astype(np.float64)
    albedo_vertex = np.array([r[2] for r in rows], bool)
    emit = np.stack([r[3] for r in rows]).astype(np.float64)
    r0 = np.array([r[4] for r in rows], np.float64)
    metalness = np.array([r[5] for r in rows], np.float64)
    roughness = np.array([r[6] for r in rows], np.float64)
    fd_mtype = np.array([r[7] for r in rows], np.int32)
    fs_mtype = np.array([r[8][0] for r in rows], np.int32)
    fs_albedo = np.stack([r[8][1] for r in rows]).astype(np.float64)
    fs_r0 = np.array([r[8][2] for r in rows], np.float64)
    fs_metalness = np.array([r[8][3] for r in rows], np.float64)
    fs_roughness = np.array([r[8][4] for r in rows], np.float64)
    fresnel_r0 = np.array([r[9] for r in rows], np.float64)
    has_fresnel = bool((mtype == M.FRESNEL).any())

    ent_is_light = np.zeros(n_entities, bool)
    ent_light_emission = np.zeros((n_entities, 3), np.float64)
    for li in range(n_lights):
        e = l_ent[li]
        ent_is_light[e] = True
        ent_light_emission[e] = l_col[li] * l_int[li]  # trace.rs:37

    # ---- spheres: big/small split, morton-packed kernel table ----
    n_spheres = len(sph_center)
    psph = None
    sph_chunks = 0
    n_sph_big = 0
    sph_flat = False
    if n_spheres:
        sphc = np.stack(sph_center)
        sphr = np.array(sph_radius, np.float64)
        sphe = np.array(sph_ent, np.int64)
        big = (sphr > 1e3) | (np.abs(sphc).max(axis=1) > 1e3)
        if int((~big).sum()) > KERNEL_MIN_SPHERES:
            order = np.concatenate([np.nonzero(big)[0], np.nonzero(~big)[0]])
            sphc, sphr, sphe, big = sphc[order], sphr[order], sphe[order], big[order]
            n_sph_big = int(big.sum())
            psph, sph_chunks, sorder = ST.pack_spheres_chunked(
                sphc[n_sph_big:], sphr[n_sph_big:], ent=sphe[n_sph_big:],
                gid0=n_sph_big, device=device,
            )
            # Put the scene arrays in the packed order so packed gids index
            # them directly.
            tail = n_sph_big + sorder
            sphc[n_sph_big:] = sphc[tail]
            sphr[n_sph_big:] = sphr[tail]
            sphe[n_sph_big:] = sphe[tail]
            # The opt-in flat sphere kernel, as the reference resolves it.
            sph_flat = (os.environ.get("PATHS_TPU_SPH_FLAT") == "1"
                        and psph.tris.shape[0] <= CS.SPH_FLAT_MAX_ROWS)
        # A big sphere's centre as float32 plus the rest (the ground at
        # y -1000002.8 is -1000002.8125 + 0.0125): the double-single test
        # takes both, so the sphere lies where the scene puts it.
        sphc_lo = np.where(big[:, None], sphc - sphc.astype(np.float32), 0.0)
    else:
        sphc = np.zeros((1, 3)); sphr = np.zeros(1); sphe = np.zeros(1, np.int64)
        sphc_lo = np.zeros((1, 3))

    # ---- triangles: BVH order, then the kernel table or the BVH route ----
    ptris = None
    tri_chunks = 0
    tri_rows = TT.ROWS_PER_CHUNK
    pbvh = None
    n_tris = sum(len(p["v0"]) for p in tri_parts)
    if n_tris:
        tri = {k: np.concatenate([p[k] for p in tri_parts]) for k in tri_parts[0]}
        use_bvh = bvh_threshold is not None and n_tris > bvh_threshold
        if use_bvh or (bvh_threshold is None and n_tris > KERNEL_MIN_TRIS):
            flat = build_bvh(np.minimum(np.minimum(tri["v0"], tri["v1"]), tri["v2"]),
                             np.maximum(np.maximum(tri["v0"], tri["v1"]), tri["v2"]),
                             leaf_size=PK.PACK_LEAF)
            tri = {k: v[flat.order] for k, v in tri.items()}
            if use_bvh:
                pbvh = PK.pack_bvh(flat, tri["v0"], tri["v1"], tri["v2"],
                                   tri["n"], ent=tri["ent"], device=device)
            else:
                ptris, tri_chunks, tri_rows = TT.pack_tris(
                    flat, tri["v0"], tri["v1"], tri["v2"], tri["n"],
                    ent=tri["ent"], device=device)
    else:
        z = np.zeros((1, 3))
        tri = dict(v0=z, v1=z, v2=z, n=z, vn0=z, vn1=z, vn2=z, vc0=z, vc1=z,
                   vc2=z, ent=np.zeros(1, np.int64), smooth=np.zeros(1, bool))

    # ---- lights SoA ----
    if n_lights:
        lt = np.array(l_type, np.int32)
        lp = np.stack(l_pos)
        lr = np.array(l_rad, np.float64)
        lc = np.stack(l_col)
        li_arr = np.array(l_int, np.float64)
        le = np.array(l_ent, np.int64)
    else:
        lt = np.zeros(1, np.int32); lp = np.zeros((1, 3)); lr = np.zeros(1)
        lc = np.zeros((1, 3)); li_arr = np.zeros(1); le = np.zeros(1, np.int64)

    # ---- sky ----
    sb = sd.skybox
    if sb.kind == "flat":
        sky_type, sky_arr = SK.flat(sb.colour.tolist(), device)
    elif sb.kind == "gradient":
        sky_type, sky_arr = SK.gradient(sb.overhead_colour.tolist(),
                                        sb.horizon_colour.tolist(), device)
    elif sb.kind == "hdri":
        path = sb.filename
        if not os.path.exists(path):
            for d in search_dirs:
                cand = os.path.join(d, sb.filename)
                if os.path.exists(cand):
                    path = cand
                    break
        sky_type, sky_arr = SK.hdri(load_hdr(path), device)
    else:
        raise ValueError(f"Unknown skybox kind {sb.kind}")

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    def flag(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    arrays = SceneArrays(
        sph_center=f32(sphc), sph_radius=f32(sphr), sph_ent=i32(sphe),
        sph_center_lo=f32(sphc_lo),
        tri_v0=f32(tri["v0"]), tri_v1=f32(tri["v1"]), tri_v2=f32(tri["v2"]),
        tri_n=f32(tri["n"]),
        tri_vn0=f32(tri["vn0"]), tri_vn1=f32(tri["vn1"]), tri_vn2=f32(tri["vn2"]),
        tri_vc0=f32(tri["vc0"]), tri_vc1=f32(tri["vc1"]), tri_vc2=f32(tri["vc2"]),
        tri_ent=i32(tri["ent"]), tri_smooth=flag(tri["smooth"]),
        ent_is_light=flag(ent_is_light),
        ent_light_emission=f32(ent_light_emission),
        mat_mtype=i32(mtype), mat_albedo=f32(albedo),
        mat_albedo_vertex=flag(albedo_vertex),
        mat_emit=f32(emit), mat_r0=f32(r0),
        mat_metalness=f32(metalness), mat_roughness=f32(roughness),
        mat_fd_mtype=i32(fd_mtype), mat_fs_mtype=i32(fs_mtype),
        mat_fs_albedo=f32(fs_albedo), mat_fs_r0=f32(fs_r0),
        mat_fs_metalness=f32(fs_metalness), mat_fs_roughness=f32(fs_roughness),
        mat_fresnel_r0=f32(fresnel_r0),
        light_ltype=i32(lt), light_pos=f32(lp), light_radius=f32(lr),
        light_colour=f32(lc), light_intensity=f32(li_arr), light_ent=i32(le),
        sky=sky_arr,
        psph=psph,
        ptris=ptris,
        pbvh=pbvh,
    )
    static = SceneStatic(
        n_spheres=n_spheres,
        n_lights=n_lights,
        n_entities=n_entities,
        sky_type=sky_type,
        has_fresnel=has_fresnel,
        sph_chunks=sph_chunks,
        n_sph_big=n_sph_big,
        sph_lo=bool(np.any(sphc_lo != 0.0)),
        sph_flat=sph_flat,
        n_tris=n_tris,
        tri_chunks=tri_chunks,
        tri_rows=tri_rows,
        use_bvh=pbvh is not None,
    )
    cam = make_camera(
        width=sd.camera.image_width,
        height=sd.camera.image_height,
        location=sd.camera.location.tolist(),
        orientation=(
            sd.camera.orientation.pitch,
            sd.camera.orientation.yaw,
            sd.camera.orientation.roll,
        ),
        sensor_width=sd.camera.sensor_width,
        sensor_height=sd.camera.sensor_height,
        focal_length=sd.camera.focal_length,
        focus_distance=sd.camera.focus_distance,
        aperture=sd.camera.aperture,
        device=device,
    )
    return static, arrays, cam
