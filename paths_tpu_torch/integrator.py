"""Wavefront path-tracing integrator (port of ``paths_tpu/integrator.py``).

Reference: src/trace.rs:7-121 (unidirectional path tracer with next-event
estimation and Russian roulette).  A whole wavefront of rays advances in
lockstep with per-lane ``alive`` masks, up to 11 bounces (trace.rs:14).

Semantics as the reference package, including its two robustness
deviations from upstream: self-intersection is prevented by excluding the
originating primitive from traversal (on top of the normal*1e-4 origin
offset, trace.rs:57,89), and point lights use the evidently intended
geometry.  All randomness is a counter-based function of (pixel, sample,
bounce, dim), see ``sampling/hashing.py``.

With ``SceneStatic.env_nee`` on an HDRI sky, each bounce also samples the
sky for direct light (``sky.sample_env``) and sends a second shadow query,
unbounded and excluding no entity, through ``occluded_query``; the block is
the span ``paths_tpu_torch.env_nee`` (``profiling.py``).

The step is written as a generator of stretches (``step_graphs.py``): each
traversal query is a ``yield`` of its wrapper's call, so the eager code
between two queries is one stretch, which replays as a CUDA graph on the
card (``path_step``) and runs as plain code elsewhere.  ``intersect_brief``,
``occluded_query`` and ``intersect_full`` drive their generators eagerly.

Closest-hit and shadow queries over the small spheres and the triangles go
to the traversal kernels (``ops/sphere_traverse.py``,
``ops/tri_traverse.py``; the small spheres to the flat kernel of
``ops/chunk_scan.py`` when the build chose it) when the scene packed them;
big and far spheres, and scenes with at most 32 small spheres, take the
double-single test of ``geom/sphere.py``, and so does NEE's entry distance
into a sphere light: on the card one launch of ``ops/sphere_ds.py``'s kernel
a query.  Meshes on the BVH route take K6
(``ops/packet_traverse.py``: the kernel on the card, its plain version on
the CPU).  Meshes on neither route (by default, those of at most 64
triangles) take an unrolled scan of ``geom/triangle.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from paths_tpu_torch import lights as LT
from paths_tpu_torch import materials as M
from paths_tpu_torch import profiling as P
from paths_tpu_torch import sky as SK
from paths_tpu_torch import step_graphs as SG
from paths_tpu_torch.geom import sphere as GS
from paths_tpu_torch.geom import triangle as GT
from paths_tpu_torch.math import vec
from paths_tpu_torch.ops import chunk_scan as CS
from paths_tpu_torch.ops import lane_rng as RNG
from paths_tpu_torch.ops import packet_traverse as PK
from paths_tpu_torch.ops import sphere_ds as SD
from paths_tpu_torch.ops import sphere_traverse as ST
from paths_tpu_torch.ops import tri_traverse as TT
from paths_tpu_torch.sampling import hashing as H
from paths_tpu_torch.scene.types import SceneArrays, SceneStatic

MAX_BOUNCES = 10  # trace.rs:14: `if loops > 10 break` -> 11 iterations
RR_START = 2  # trace.rs:104
SHADOW_EPS = 1e-4  # trace.rs:57,89
BIG = 3.4e38
DEAD_ORIGIN = 1e30  # origin push for lanes the traversal may skip

# Primitive kinds.
KIND_NONE = 0
KIND_SPHERE = 1
KIND_TRI = 2


def _scan_spheres(static: SceneStatic, scene: SceneArrays, lo: int, hi: int, o, d,
                  excl_kind, excl_idx, t_best, i_best):
    """Closest hit among spheres [lo, hi) by the double-single test, merged
    into (t_best, i_best): a sphere wins where its t is strictly below the
    running best, the lowest index among equal t (the reference's unrolled
    per-sphere loop; ``ops/sphere_ds.closest``)."""
    return SD.closest(o, d, scene.sph_center, scene.sph_radius,
                      scene.sph_center_lo if static.sph_lo else None, lo, hi,
                      excl_kind == KIND_SPHERE, excl_idx, t_best, i_best)


def _closest_spheres(static: SceneStatic, scene: SceneArrays, o, d,
                     excl_kind, excl_idx):
    """Closest sphere hit: (t, idx, ent), t = BIG on a miss.  Big/far
    spheres seed the kernel's t_init, as in the reference's
    _scan_spheres_pallas.  A generator of stretches (``step_graphs.py``)."""
    n = o.shape[0]
    t_best = torch.full((n,), BIG, device=o.device)
    i_best = torch.zeros(n, dtype=torch.int32, device=o.device)
    if static.sph_chunks == 0:
        t_best, i_best = _scan_spheres(static, scene, 0, static.n_spheres, o, d,
                                       excl_kind, excl_idx, t_best, i_best)
        return t_best, i_best, scene.sph_ent[i_best]
    t_best, i_best = _scan_spheres(static, scene, 0, static.n_sph_big, o, d,
                                   excl_kind, excl_idx, t_best, i_best)
    e_best = scene.sph_ent[i_best]
    excl_i = torch.where(excl_kind == KIND_SPHERE, excl_idx, -1).to(torch.int32)
    if static.sph_flat:
        tk, ik, ek = yield SG.Call(CS, "flat_closest_hit", scene.psph.tris, o.contiguous(),
                                   d.contiguous(), excl_i, t_best.contiguous())
    else:
        tk, ik, ek = yield SG.Call(
            ST, "closest_hit_spheres",
            scene.psph, static.sph_chunks, o.contiguous(), d.contiguous(),
            excl_i, t_best.contiguous(),
        )
    better = tk < t_best
    return (torch.where(better, tk, t_best), torch.where(better, ik, i_best),
            torch.where(better, ek, e_best))


def _scan_tris(static: SceneStatic, scene: SceneArrays, o, d, excl_kind,
               excl_idx):
    """Closest hit among the unpacked triangles: (t, idx), a
    triangle winning where its t is strictly below the running best, the
    lowest index among equal t (the reference's unrolled loop)."""
    t, hit, *_ = GT.intersect(o[:, None, :], d[:, None, :],
                              scene.tri_v0[None], scene.tri_v1[None],
                              scene.tri_v2[None], scene.tri_n[None])
    ids = torch.arange(static.n_tris, dtype=torch.int32, device=o.device)
    excl = (excl_kind == KIND_TRI)[:, None] & (excl_idx[:, None] == ids[None, :])
    t = torch.where(hit & ~excl, t, BIG)
    arg = torch.argmin(t, dim=1)
    return torch.gather(t, 1, arg[:, None])[:, 0], arg.to(torch.int32)


def _closest_bvh(scene: SceneArrays, o, d, excl_kind, excl_idx, t_init):
    """The BVH route's closest triangle hit, seeded with t_init: (t, idx,
    ent), t = BIG where nothing beats t_init.  K6 on every device."""
    if scene.pbvh is None:
        raise ValueError("the BVH route needs the packed BVH table "
                         "(scene.pbvh), which build_scene makes")
    excl_i = torch.where(excl_kind == KIND_TRI, excl_idx, -1).to(torch.int32)
    return (yield SG.Call(PK, "closest_hit_packet", scene.pbvh, o.contiguous(),
                          d.contiguous(), excl_i, t_init.contiguous()))


def intersect_brief(static, scene, o, d, excl_kind, excl_idx):
    """Closest hit, identity only: (found, kind, idx, ent, t)."""
    return SG.eager(_intersect_brief(static, scene, o, d, excl_kind, excl_idx))


def _intersect_brief(static, scene, o, d, excl_kind, excl_idx):
    """``intersect_brief`` as a generator of stretches."""
    n = o.shape[0]
    t = torch.full((n,), BIG, device=o.device)
    kind = torch.zeros(n, dtype=torch.int32, device=o.device)
    idx = torch.zeros(n, dtype=torch.int32, device=o.device)
    ent = torch.zeros(n, dtype=torch.int32, device=o.device)
    if static.has_spheres:
        ts, is_, es = yield from _closest_spheres(static, scene, o, d, excl_kind, excl_idx)
        better = ts < t
        t = torch.where(better, ts, t)
        kind = torch.where(better, KIND_SPHERE, kind).to(torch.int32)
        idx = torch.where(better, is_, idx)
        ent = torch.where(better, es, ent)
    if static.has_tris:
        if static.tri_chunks > 0:
            # The sphere hit seeds t_init, as in the reference.
            excl_i = torch.where(excl_kind == KIND_TRI, excl_idx, -1).to(torch.int32)
            tt, it, et = yield SG.Call(
                TT, "closest_hit_tris",
                scene.ptris, static.tri_chunks, o.contiguous(), d.contiguous(),
                excl_i, t.contiguous(),
            )
        elif static.use_bvh:
            tt, it, et = yield from _closest_bvh(scene, o, d, excl_kind, excl_idx, t)
        else:
            tt, it = _scan_tris(static, scene, o, d, excl_kind, excl_idx)
            et = scene.tri_ent[it]
        better = tt < t
        t = torch.where(better, tt, t)
        kind = torch.where(better, KIND_TRI, kind).to(torch.int32)
        idx = torch.where(better, it, idx)
        ent = torch.where(better, et, ent)
    found = t < BIG
    kind = torch.where(found, kind, KIND_NONE).to(torch.int32)
    return found, kind, idx, ent, t


def occluded_query(static, scene, o, d, excl_kind, excl_idx, t_max, excl_ent):
    """Shadow-ray occlusion: True per lane iff some primitive other than the
    originating one and of an entity other than ``excl_ent`` is hit at
    t < t_max (the any-hit form of trace.rs:61-66's occluder-identity
    test).  Excluding the source primitive is sound: a flat triangle cannot
    occlude its own offset ray, and a shadow ray above the local tangent
    plane cannot re-enter the convex sphere it left.

    With a packed triangle table the triangles go to the any-hit kernel, and
    the spheres to theirs (big and far spheres, or all spheres when there are
    at most 32 small ones, by the double-single test).  The reference takes
    this route only when spheres and triangles both have tables, and else
    derives occlusion from the closest hit -- the same predicate up to exact
    ties in t -- so its mesh scenes with few spheres (doom_standin,
    dragon_standin) trace shadow rays with the closest-hit kernel.  Without a
    triangle table (the BVH route, or the scan), the port follows the
    reference: occlusion from the closest hit, through K6 on the BVH route
    (the reference has no BVH any-hit)."""
    return SG.eager(_occluded_query(static, scene, o, d, excl_kind, excl_idx,
                                    t_max, excl_ent))


def _occluded_query(static, scene, o, d, excl_kind, excl_idx, t_max, excl_ent):
    """``occluded_query`` as a generator of stretches."""
    kernels = static.tri_chunks > 0 if static.has_tris else static.sph_chunks > 0
    if not kernels:
        f, _, _, e, t = yield from _intersect_brief(static, scene, o, d, excl_kind,
                                                    excl_idx)
        return f & (t < t_max) & (e != excl_ent)

    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    if static.has_spheres:
        excl_s = excl_kind == KIND_SPHERE
        n_scan = static.n_sph_big if static.sph_chunks else static.n_spheres
        occ = SD.occludes(o, d, scene.sph_center, scene.sph_radius,
                          scene.sph_center_lo if static.sph_lo else None, scene.sph_ent,
                          n_scan, excl_s, excl_idx, t_max, excl_ent, occ)
        if static.sph_chunks:
            excl_i = torch.where(excl_s, excl_idx, -1).to(torch.int32)
            o_eff = torch.where(occ[:, None], DEAD_ORIGIN, o).contiguous()
            if static.sph_flat:
                occ = occ | (yield SG.Call(
                    CS, "flat_occludes",
                    scene.psph.tris, o_eff, d.contiguous(), excl_i,
                    excl_ent.contiguous(), t_max.contiguous()))
            else:
                occ = occ | (yield SG.Call(
                    ST, "occludes_spheres",
                    scene.psph, static.sph_chunks, o_eff, d.contiguous(),
                    excl_i, excl_ent.contiguous(), t_max.contiguous(),
                ))
    if static.has_tris:
        # Lanes already occluded are pushed out (dead: not tested again).
        excl_i = torch.where(excl_kind == KIND_TRI, excl_idx, -1).to(torch.int32)
        o_eff = torch.where(occ[:, None], DEAD_ORIGIN, o)
        occ = occ | (yield SG.Call(
            TT, "occludes_tris",
            scene.ptris, static.tri_chunks, o_eff.contiguous(), d.contiguous(),
            excl_i, excl_ent.contiguous(), t_max.contiguous(),
        ))
    return occ


def intersect_full(static, scene, o, d, excl_kind, excl_idx):
    """Closest hit with shading data: dict(found, kind, idx, ent, t,
    location, normal, vtx_colour).  The sphere normal points outward
    (geom.rs:232); the triangle normal is the geometric normal flipped to
    face the ray (geom.rs:298-300), unless the mesh has smooth normals: then
    the barycentric blend of its (unnormalised) vertex normals
    (scene.rs:178-190, model.rs:142-156).  vtx_colour is the barycentric
    blend of the vertex colours (ones off triangles)."""
    return SG.eager(_intersect_full(static, scene, o, d, excl_kind, excl_idx))


def _intersect_full(static, scene, o, d, excl_kind, excl_idx):
    """``intersect_full`` as a generator of stretches."""
    found, kind, idx, ent, t = yield from _intersect_brief(static, scene, o, d,
                                                           excl_kind, excl_idx)
    location = o + d * torch.where(found, t, 0.0)[..., None]
    normal = torch.zeros_like(o)
    normal[..., 1] = 1.0
    vtx_colour = torch.ones_like(o)
    if static.has_spheres:
        c = scene.sph_center[torch.where(kind == KIND_SPHERE, idx, 0)]
        loc_s, n_s = GS.surface(o, d, t, c)
        sel = (kind == KIND_SPHERE)[..., None]
        location = torch.where(sel, loc_s, location)
        normal = torch.where(sel, n_s, normal)
    if static.has_tris:
        # One packed row gather for all per-triangle shading data.
        rows = torch.cat(
            [scene.tri_v0, scene.tri_v1, scene.tri_v2, scene.tri_n,  # 0:12
             scene.tri_vn0, scene.tri_vn1, scene.tri_vn2,            # 12:21
             scene.tri_vc0, scene.tri_vc1, scene.tri_vc2,            # 21:30
             _col(scene.tri_smooth)],                                # 30
            dim=1,
        )[torch.where(kind == KIND_TRI, idx, 0)]
        n = rows[:, 9:12]
        v0, v1, v2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        # Barycentrics recomputed at the chosen triangle.  Lanes off
        # triangles (a dead lane's far origin among them) ask instead about
        # a ray down the normal onto their row's centroid: every value stays
        # finite, so no zero gradient meets a NaN or an infinity in the
        # backward (0 * NaN is NaN).  Those lanes take the defaults below.
        on_tri = kind == KIND_TRI
        sel = on_tri[..., None]
        o_t = torch.where(sel, o, (v0 + v1 + v2) / 3.0 + n)
        d_t = torch.where(sel, d, -n)
        _, _, bx, by, bz, cos = GT.intersect(o_t, d_t, v0, v1, v2, n)
        geo_n = n * torch.where(cos > 0.0, -1.0, 1.0)[..., None]
        smooth_n = (rows[:, 12:15] * bx[..., None] + rows[:, 15:18] * by[..., None]
                    + rows[:, 18:21] * bz[..., None])
        tri_normal = torch.where((rows[:, 30] > 0.5)[..., None], smooth_n, geo_n)
        vc = (rows[:, 21:24] * bx[..., None] + rows[:, 24:27] * by[..., None]
              + rows[:, 27:30] * bz[..., None])
        normal = torch.where(sel, tri_normal, normal)
        vtx_colour = torch.where(sel, vc, vtx_colour)
    return dict(found=found, kind=kind, idx=idx, ent=ent, t=t,
                location=location, normal=normal, vtx_colour=vtx_colour)


def _col(a):
    return a.to(torch.float32)[:, None]


def _gather_material(static: SceneStatic, scene: SceneArrays, ent, kind,
                     vtx_colour):
    """Per-lane material record + light identity from one packed-row gather;
    vertex albedo (material.rs:183-195) on triangle hits of materials that
    ask for it.  Returns (mat_record, is_light, light_emission)."""
    table = torch.cat(
        [
            scene.mat_albedo,                       # 0:3
            scene.mat_emit,                         # 3:6
            _col(scene.mat_r0),                     # 6
            _col(scene.mat_metalness),              # 7
            _col(scene.mat_roughness),              # 8
            _col(scene.mat_mtype),                  # 9
            _col(scene.mat_albedo_vertex),          # 10
            _col(scene.ent_is_light),               # 11
            scene.ent_light_emission,               # 12:15
        ],
        dim=1,
    )
    rows = table[ent]
    use_v = (rows[:, 10] > 0.5) & (kind == KIND_TRI)
    rec = dict(
        mtype=rows[:, 9].to(torch.int32),
        albedo=torch.where(use_v[..., None], vtx_colour, rows[:, 0:3]),
        emit=rows[:, 3:6],
        r0=rows[:, 6],
        metalness=rows[:, 7],
        roughness=rows[:, 8],
    )
    if static.has_fresnel:
        ftable = torch.cat(
            [
                _col(scene.mat_fd_mtype),           # 0
                _col(scene.mat_fs_mtype),           # 1
                scene.mat_fs_albedo,                # 2:5
                _col(scene.mat_fs_r0),              # 5
                _col(scene.mat_fs_metalness),       # 6
                _col(scene.mat_fs_roughness),       # 7
                _col(scene.mat_fresnel_r0),         # 8
            ],
            dim=1,
        )
        frows = ftable[ent]
        rec.update(
            fd_mtype=frows[:, 0].to(torch.int32),
            fs_mtype=frows[:, 1].to(torch.int32),
            fs_albedo=frows[:, 2:5],
            fs_r0=frows[:, 5],
            fs_metalness=frows[:, 6],
            fs_roughness=frows[:, 7],
            fresnel_r0=frows[:, 8],
        )
    return rec, rows[:, 11] > 0.5, rows[:, 12:15]


def _gather_light(scene: SceneArrays, li):
    return dict(
        ltype=scene.light_ltype[li],
        position=scene.light_pos[li],
        radius=scene.light_radius[li],
        colour=scene.light_colour[li],
        intensity=scene.light_intensity[li],
        ent_id=scene.light_ent[li],
    )


@P.span("paths_tpu_torch.path_step")
def path_step(static: SceneStatic, scene: SceneArrays, bounce, state, u):
    """Advance every lane's path by one segment (one bounce of trace.rs's
    loop, trace.rs:13-118).

    bounce: per-lane (N,) int64 or a Python int (RNG counter + RR gate).
    state: (o, d, throughput, colour, alive, last_spec, excl_kind, excl_idx).
    u(bounce, dim): per-lane uniform for this bounce and dimension slot; a
    ``LaneUniforms`` (``lane_uniforms``) or any callable.

    The step's eager stretches, between its traversal-kernel calls, replay
    as CUDA graphs (``step_graphs.run``) where bounce, state and a
    ``LaneUniforms``' seed and keys are all CUDA tensors and nothing
    requires grad: the regenerating wavefront's iterations
    (``render.render_samples``).  The returned state is then the graphs'
    buffers, which the next such call overwrites.  Elsewhere (the CPU, the
    gradient, an integer bounce, another u) the stretches run eagerly.
    """
    if isinstance(u, LaneUniforms):
        return SG.run(_lane_step, (static, scene), (bounce, *state, *u))
    return SG.eager(_path_step(static, scene, bounce, state, u))


def _lane_step(static, scene, bounce, *lanes):
    """``_path_step`` on flat inputs: the state's eight tensors, then the
    ``LaneUniforms``' three."""
    return (yield from _path_step(static, scene, bounce, lanes[:8],
                                  LaneUniforms(*lanes[8:])))


def _path_step(static: SceneStatic, scene: SceneArrays, bounce, state, u):
    """``path_step`` as a generator of stretches: each traversal query ends
    one; the environment light's stretches and query are the span
    ``paths_tpu_torch.env_nee``."""
    env_nee = static.env_nee and static.sky_type == SK.HDRI
    (o, d, throughput, colour, alive, last_spec, excl_kind, excl_idx) = state

    # Dead lanes keep stale rays; their origins are pushed far outside the
    # scene so the traversal skips them.  Results are masked by `alive`.
    o_eff = torch.where(alive[..., None], o, DEAD_ORIGIN)
    hit = yield from _intersect_full(static, scene, o_eff, d, excl_kind, excl_idx)

    # Miss -> skybox, evaluated at -direction (trace.rs:18-23).  With
    # environment NEE on, diffuse-bounce misses are already covered by the
    # environment samples, so an escaping ray collects the sky only after a
    # specular bounce -- the rule for area lights (trace.rs:30-41).
    sky_col = SK.ambient_light(static.sky_type, scene.sky, -d)
    miss = alive & ~hit["found"]
    if env_nee:
        miss = miss & last_spec
    colour = colour + torch.where(miss[..., None], throughput * sky_col, 0.0)
    alive = alive & hit["found"]

    # Facing check (trace.rs:25-28): cos_in = d . -n must be > 0.
    normal = hit["normal"]
    cos_in = vec.dot(d, -normal)
    alive = alive & (cos_in > 0.0)

    mat, is_light, light_emission = _gather_material(
        static, scene, hit["ent"], hit["kind"], hit["vtx_colour"])

    # Direct light hit (trace.rs:30-41): counts only after a specular
    # bounce (NEE covers the rest); the path ends either way.
    light_gain = alive & is_light & last_spec
    colour = colour + torch.where(light_gain[..., None],
                                  throughput * light_emission, 0.0)
    alive = alive & ~is_light

    location = hit["location"]
    vec_out = -d

    # ---- Next Event Estimation (trace.rs:52-81) ----
    if static.n_lights > 0:
        u_pick = u(bounce, H.DIM_LIGHT_PICK)
        li = torch.clamp_max((u_pick * static.n_lights).to(torch.int64),
                             static.n_lights - 1)
        light = _gather_light(scene, li)
        in_dir, inv_pdf, max_dist = LT.sample(
            light, location, u(bounce, H.DIM_LIGHT_U), u(bounce, H.DIM_LIGHT_V)
        )
        shadow_dir = -in_dir
        shadow_o = location + normal * SHADOW_EPS
        cos_theta = torch.clamp_min(vec.dot(normal, shadow_dir), 0.0)
        brdf = M.eval_brdf(mat, vec_out, -shadow_dir, normal)
        direct = (light["colour"] * light["intensity"][..., None] * brdf
                  * inv_pdf[..., None])
        # The shadow ray matters only where the unshadowed contribution is
        # nonzero; other lanes get their origin pushed out.
        want = alive & (cos_theta > 0.0) & (vec.max_component(direct) > 0.0)
        is_point = light["ltype"] == LT.POINT
        # Bound the query at the light itself: its analytic entry distance
        # (sphere lights) or the point light's distance.
        t_light, l_hit = SD.intersect(shadow_o, shadow_dir, light["position"],
                                      light["radius"])
        t_max_q = torch.where(is_point, max_dist,
                              torch.where(l_hit, t_light, BIG))
        excl_ent_q = torch.where(is_point, -1, light["ent_id"]).to(torch.int32)
        shadow_o_eff = torch.where(want[..., None], shadow_o, DEAD_ORIGIN)
        occluded = yield from _occluded_query(static, scene, shadow_o_eff, shadow_dir,
                                              hit["kind"], hit["idx"], t_max_q, excl_ent_q)
        ok = want & ~occluded
        colour = colour + torch.where(ok[..., None], direct * throughput, 0.0)

    # ---- Environment NEE: the HDRI sampled for direct light (the
    # reference package's extension; upstream only collects the sky on a
    # miss) ----
    if env_nee:
        yield SG.Enter("paths_tpu_torch.env_nee")
        e_dir, e_inv_pdf, e_rad = SK.sample_env(
            scene.sky, u(bounce, H.DIM_ENV_CDF), u(bounce, H.DIM_ENV_JX),
            u(bounce, H.DIM_ENV_JY))
        e_shadow_dir = -e_dir  # surface -> sky
        e_shadow_o = location + normal * SHADOW_EPS
        e_cos = vec.dot(normal, e_shadow_dir)
        e_brdf = M.eval_brdf(mat, vec_out, e_dir, normal)
        e_direct = e_rad * e_brdf * e_inv_pdf[..., None]
        # Any hit at all blocks the sky: t_max BIG and no entity excluded,
        # as (N,) lanes, as the wrappers take them.
        e_want = alive & (e_cos > 0.0) & (vec.max_component(e_direct) > 0.0)
        e_o_eff = torch.where(e_want[..., None], e_shadow_o, DEAD_ORIGIN)
        n = o.shape[0]
        e_occ = yield from _occluded_query(
            static, scene, e_o_eff, e_shadow_dir, hit["kind"], hit["idx"],
            torch.full((n,), BIG, device=o.device),
            torch.full((n,), -1, dtype=torch.int32, device=o.device))
        e_ok = e_want & ~e_occ
        colour = colour + torch.where(e_ok[..., None], e_direct * throughput, 0.0)
        yield SG.EXIT

    # ---- BSDF sample & bounce (trace.rs:84-101) ----
    new_dir, pdf, brdf, is_spec = M.sample(
        mat, vec_out, normal,
        u(bounce, H.DIM_LOBE), u(bounce, H.DIM_BSDF_U), u(bounce, H.DIM_BSDF_V),
    )
    pdf_safe = torch.where(pdf == 0.0, 1.0, pdf)
    attenuation = torch.where((pdf == 0.0)[..., None], 0.0,
                              brdf / pdf_safe[..., None])
    new_throughput = throughput * attenuation
    # Non-finite throughput terminates the path (the analogue of upstream's
    # energy-check panic, colour.rs:56-60).
    tp_finite = torch.isfinite(new_throughput).all(dim=-1)
    dead = (vec.max_component(new_throughput) <= 0.0) | ~tp_finite  # trace.rs:96-98

    emit = M.emittance(mat)  # trace.rs:100-101 (post-attenuation T)
    colour = colour + torch.where((alive & ~dead)[..., None],
                                  emit * new_throughput, 0.0)

    # Russian roulette from bounce 2 (trace.rs:103-111).
    survival = vec.max_component(new_throughput)
    u_rr = u(bounce, H.DIM_RR)
    rr_active = torch.as_tensor(bounce, device=o.device) >= RR_START
    rr_kill = rr_active & (u_rr > survival)
    survival_safe = torch.where(survival == 0.0, 1.0, survival)
    new_throughput = torch.where((rr_active & ~rr_kill)[..., None],
                                 new_throughput / survival_safe[..., None],
                                 new_throughput)

    step_alive = alive & ~dead & ~rr_kill
    sa3 = step_alive[..., None]
    throughput = torch.where(sa3, new_throughput, throughput)
    o = torch.where(sa3, location + normal * SHADOW_EPS, o)
    d = torch.where(sa3, new_dir, d)
    last_spec = torch.where(step_alive, is_spec, last_spec)
    excl_kind = torch.where(step_alive, hit["kind"], excl_kind)
    excl_idx = torch.where(step_alive, hit["idx"], excl_idx)
    return (o, d, throughput, colour, step_alive, last_spec, excl_kind, excl_idx)


def fresh_path_state(o, d):
    """Initial per-lane path state for fresh rays (trace.rs:9-11)."""
    n = o.shape[0]
    dev = o.device
    return (
        o,
        d,
        torch.ones((n, 3), device=dev),
        torch.zeros((n, 3), device=dev),
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.ones(n, dtype=torch.bool, device=dev),  # trace.rs:11
        torch.full((n,), KIND_NONE, dtype=torch.int32, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
    )


class LaneUniforms(NamedTuple):
    """u(bounce, dim) for lanes with identity (pixel_id, sample_id) under
    seed (an integer, or a one-element int64 tensor on the lanes' device):
    one launch of ``ops/lane_rng.py``'s kernel a draw on the card."""
    seed: object
    pixel_id: torch.Tensor
    sample_id: torch.Tensor

    def __call__(self, bounce, dim):
        with P.span("paths_tpu_torch.rng"):
            return RNG.shading_uniform(self.seed, self.pixel_id, self.sample_id,
                                       bounce, dim)


def lane_uniforms(seed, pixel_id, sample_id) -> LaneUniforms:
    return LaneUniforms(seed, pixel_id, sample_id)


def trace_rays(static: SceneStatic, scene: SceneArrays, ray_o, ray_d,
               pixel_id, sample_id, seed) -> torch.Tensor:
    """Radiance along N rays over the fixed bounce schedule (the forward of
    the reference's differentiable path).  Returns (N, 3)."""
    u = lane_uniforms(seed, pixel_id, sample_id)
    state = fresh_path_state(ray_o, ray_d)
    for bounce in range(static.max_bounces + 1):
        # Whole-wave early out once every lane is dead.
        if not bool(state[4].any()):
            break
        state = path_step(static, scene, bounce, state, u)
    return state[3]
