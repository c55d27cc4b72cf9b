"""The reference path tracer: camera sample waves, intersection and the
shading step, in plain PyTorch over the reference's own scene arrays
(``scene.py``).

The shading step follows upstream's trace.rs:7-121 as the program states
it: next-event estimation towards sphere lights, Russian roulette from
bounce 2, the originating primitive excluded from every query, up to 11
bounce iterations.  Every random number is the counter-based hash of
(seed, pixel, sample, bounce, dimension) (``hashing.py``), so the reference
draws the program's samples and not merely samples of the same
distribution.  Intersection is its own: every sphere in f64 (no
double-single arithmetic, no tables), and the triangles by brute force over
the clusters whose boxes the ray enters (``scene.clusters``).

A sample wave here runs the fixed schedule (every lane to the end of its
path); the program's regenerating wavefront banks the same samples in the
same order per lane.
"""

from __future__ import annotations

import torch

from portbench.reference import cmj
from portbench.reference import hashing as H
from portbench.reference import lights as LT
from portbench.reference import materials as M
from portbench.reference import triangle as GT
from portbench.reference import vec
from portbench.reference.camera import get_rays
from portbench.reference.scene import CLUSTER, FLAT, RefScene

RR_START = 2
SHADOW_EPS = 1e-4
BIG = 3.4e38
DEAD_ORIGIN = 1e30
KIND_NONE, KIND_SPHERE, KIND_TRI = 0, 1, 2
PAT_M = PAT_N = 4
_SQUARE_TAG = 0x5153
_DISK_TAG = 0xD15C
# Lanes per block of the sphere test, and (lane, cluster) pairs per block of
# the triangle test: they bound the temporaries.
SPHERE_PAIRS = 1 << 24
LANE_BLOCK = 8192
PAIR_BLOCK = 1 << 18
# Lanes traced at once by render_sum.
LANES_PER_CALL = 1 << 18


def camera_rays(cam, px, py, pixel_id, sample_id, seed):
    """Primary rays of (pixel, sample) lanes: CMJ sensor jitter and lens
    point (worker.rs:68-86), the pattern re-seeded every 16 samples."""
    pixel_id = H.as_u32(pixel_id)
    sample_id = H.as_u32(sample_id)
    s = sample_id % (PAT_M * PAT_N)
    batch = sample_id // (PAT_M * PAT_N)
    sq = cmj.cmj_square(s, PAT_M, PAT_N, H.hash_u32(seed, pixel_id, batch, _SQUARE_TAG))
    dk = cmj.cmj_disk(s, PAT_M, PAT_N, H.hash_u32(seed, pixel_id, batch, _DISK_TAG))
    return get_rays(cam, px, py, sq, dk)


def _sphere_t(o, d, c64, r64):
    """(t f32, hit) of rays against spheres in f64, broadcast over the
    leading dimensions (o, d, c64: (..., 3); r64: (...)): t = the nearer
    root if positive, else the farther; a miss where the discriminant is
    negative or the farther root is behind."""
    oc = o.double() - c64
    b = (d.double() * oc).sum(-1)
    c = (oc * oc).sum(-1) - r64 * r64
    disc = b * b - c
    root = torch.sqrt(torch.clamp_min(disc, 0.0))
    d1, d2 = -b + root, -b - root
    t = torch.where(d2 > 0.0, d2, d1)
    hit = (disc >= 0.0) & (d1 >= 0.0)
    return t.float(), hit


def fma(a, b, c):
    """Correctly rounded f32 fused multiply-add: the product of two f32 is
    exact in f64; the f64 sum is made round-to-odd from its exact error so
    that its one rounding to f32 is correct."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _sphere_t32(o, d, c, r2):
    """(t, hit) in f32 with three fused multiply-adds: b = d.(o-c),
    c2 = |o-c|^2 - r^2, disc = b^2 - c2, broadcast as _sphere_t."""
    oc = o - c
    b = fma(d[..., 2], oc[..., 2], fma(d[..., 0], oc[..., 0], d[..., 1] * oc[..., 1]))
    c2 = fma(oc[..., 2], oc[..., 2], fma(oc[..., 0], oc[..., 0], oc[..., 1] * oc[..., 1])) - r2
    disc = fma(b, b, -c2)
    root = vec.sqrt(torch.clamp_min(disc, 0.0))
    d1, d2 = -b + root, -b - root
    t = torch.where(d2 > 0.0, d2, d1)
    return t, (disc >= 0.0) & (d1 >= 0.0)


def _spheres_t(S: RefScene, o, d):
    """(t, hit) of rays (L, 3) against every sphere: (L, S)."""
    nb = S.n_big
    t64, h64 = _sphere_t(o[:, None], d[:, None], S.sph_c64[None, :nb], S.sph_r64[None, :nb])
    t32, h32 = _sphere_t32(o[:, None], d[:, None], S.sph_center[None, nb:], S.sph_r2[None, nb:])
    return torch.cat([t64, t32], dim=1), torch.cat([h64, h32], dim=1)


def _blocks(n, width):
    step = max(1, SPHERE_PAIRS // max(width, 1))
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def closest_spheres(S: RefScene, o, d, excl):
    """(t, idx) of the nearest sphere other than excl (-1: none), lowest
    index among equal t; t = BIG on a miss."""
    n = o.shape[0]
    t_out = torch.full((n,), BIG, device=o.device)
    i_out = torch.zeros(n, dtype=torch.int64, device=o.device)
    ids = torch.arange(S.n_spheres, device=o.device)
    for a, b in _blocks(n, S.n_spheres):
        t, hit = _spheres_t(S, o[a:b], d[a:b])
        ok = hit & (ids[None] != excl[a:b, None])
        t = torch.where(ok, t, BIG)
        arg = torch.argmin(t, dim=1)
        t_out[a:b] = torch.gather(t, 1, arg[:, None])[:, 0]
        i_out[a:b] = arg
    return t_out, i_out


def occluded_spheres(S: RefScene, o, d, excl, excl_ent, t_max):
    n = o.shape[0]
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    ids = torch.arange(S.n_spheres, device=o.device)
    for a, b in _blocks(n, S.n_spheres):
        t, hit = _spheres_t(S, o[a:b], d[a:b])
        ok = (hit & (t < t_max[a:b, None]) & (ids[None] != excl[a:b, None])
              & (S.sph_ent[None] != excl_ent[a:b, None]))
        occ[a:b] = ok.any(dim=1)
    return occ


def _cluster_pairs(S: RefScene, o, d, t_bound):
    """(lane, cluster) pairs whose box the lane's ray enters before
    t_bound; NaN slabs count as entered."""
    inv = 1.0 / d
    none = torch.zeros(0, dtype=torch.int64, device=o.device)
    lanes, clus = [none], [none]
    for a in range(0, o.shape[0], LANE_BLOCK):
        b = min(a + LANE_BLOCK, o.shape[0])
        t0 = (S.box_lo[None] - o[a:b, None]) * inv[a:b, None]
        t1 = (S.box_hi[None] - o[a:b, None]) * inv[a:b, None]
        t_near = torch.minimum(t0, t1).amax(-1)
        t_far = torch.maximum(t0, t1).amin(-1)
        enter = ~(t_near > t_far) & ~(t_far < 0.0) & ~(t_near >= t_bound[a:b, None])
        li, ci = torch.nonzero(enter, as_tuple=True)
        lanes.append(li + a)
        clus.append(ci)
    return torch.cat(lanes), torch.cat(clus)


def _pair_tests(S: RefScene, o, d, lanes, clus):
    """Yields (lane, tri, t, hit) over the triangles of the given
    (lane, cluster) pairs, a block at a time."""
    k = torch.arange(CLUSTER, device=o.device)
    for a in range(0, lanes.shape[0], PAIR_BLOCK):
        li = lanes[a:a + PAIR_BLOCK, None].expand(-1, CLUSTER).reshape(-1)
        ti = (clus[a:a + PAIR_BLOCK, None] * CLUSTER + k[None]).reshape(-1)
        keep = ti < S.n_tris
        li, ti = li[keep], ti[keep]
        t, hit, *_ = GT.intersect(o[li], d[li], S.tri_v0[ti], S.tri_v1[ti],
                                  S.tri_v2[ti], S.tri_n[ti])
        yield li, ti, t, hit


def closest_tris(S: RefScene, o, d, excl, t_init):
    """(t, idx) of the nearest triangle other than excl (-1: none) hit
    strictly before t_init, lowest index among equal t; t = BIG (idx 0)
    where none is."""
    n = o.shape[0]
    t_best = torch.full((n,), BIG, device=o.device)
    i_best = torch.full((n,), S.n_tris, dtype=torch.int64, device=o.device)
    lanes, clus = _cluster_pairs(S, o, d, t_init)
    hits = []
    for li, ti, t, hit in _pair_tests(S, o, d, lanes, clus):
        ok = hit & (t < t_init[li]) & (ti != excl[li])
        li, ti, t = li[ok], ti[ok], t[ok]
        t_best.scatter_reduce_(0, li, t, "amin")
        hits.append((li, ti, t))
    for li, ti, t in hits:
        first = t == t_best[li]
        i_best.scatter_reduce_(0, li[first], ti[first], "amin")
    found = i_best < S.n_tris
    return torch.where(found, t_best, BIG), torch.where(found, i_best, 0)


def occluded_tris(S: RefScene, o, d, excl, excl_ent, t_max):
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    lanes, clus = _cluster_pairs(S, o, d, t_max)
    for li, ti, t, hit in _pair_tests(S, o, d, lanes, clus):
        ok = hit & (t < t_max[li]) & (ti != excl[li]) & (S.tri_ent[ti] != excl_ent[li])
        occ[li[ok]] = True
    return occ


def _live(o):
    return torch.nonzero(~(o[:, 0] > 1e29), as_tuple=True)[0]


def intersect(S: RefScene, o, d, excl_kind, excl_idx):
    """Closest hit: (found, kind, idx, ent, t); spheres first, then the
    triangles seeded with the sphere's t (a triangle wins only strictly
    nearer)."""
    n = o.shape[0]
    t = torch.full((n,), BIG, device=o.device)
    kind = torch.zeros(n, dtype=torch.int64, device=o.device)
    idx = torch.zeros(n, dtype=torch.int64, device=o.device)
    live = _live(o)
    ol, dl, kl, xl = o[live], d[live], excl_kind[live], excl_idx[live]
    tl = torch.full((live.shape[0],), BIG, device=o.device)
    il = torch.zeros(live.shape[0], dtype=torch.int64, device=o.device)
    kd = torch.zeros(live.shape[0], dtype=torch.int64, device=o.device)
    if S.n_spheres:
        ts, is_ = closest_spheres(S, ol, dl, torch.where(kl == KIND_SPHERE, xl, -1))
        better = ts < tl
        tl, il = torch.where(better, ts, tl), torch.where(better, is_, il)
        kd = torch.where(better, KIND_SPHERE, kd)
    if S.n_tris:
        tt, it = closest_tris(S, ol, dl, torch.where(kl == KIND_TRI, xl, -1), tl)
        better = tt < tl
        tl, il = torch.where(better, tt, tl), torch.where(better, it, il)
        kd = torch.where(better, KIND_TRI, kd)
    t[live], idx[live], kind[live] = tl, il, kd
    found = t < BIG
    kind = torch.where(found, kind, KIND_NONE)
    ent = torch.zeros_like(idx)
    if S.n_spheres:
        ent = torch.where(kind == KIND_SPHERE, S.sph_ent[idx.clamp_max(S.n_spheres - 1)], ent)
    if S.n_tris:
        ent = torch.where(kind == KIND_TRI, S.tri_ent[idx.clamp_max(S.n_tris - 1)], ent)
    return found, kind, idx, ent, t


def occluded(S: RefScene, o, d, excl_kind, excl_idx, t_max, excl_ent):
    """True where a primitive other than the originating one, of an entity
    other than excl_ent, is hit at t < t_max."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    live = _live(o)
    ol, dl, kl, xl = o[live], d[live], excl_kind[live], excl_idx[live]
    tm, ee = t_max[live], excl_ent[live]
    got = torch.zeros(live.shape[0], dtype=torch.bool, device=o.device)
    if S.n_spheres:
        got = got | occluded_spheres(S, ol, dl, torch.where(kl == KIND_SPHERE, xl, -1), ee, tm)
    if S.n_tris:
        rest = torch.nonzero(~got, as_tuple=True)[0]
        got[rest] = occluded_tris(S, ol[rest], dl[rest],
                                  torch.where(kl[rest] == KIND_TRI, xl[rest], -1),
                                  ee[rest], tm[rest])
    occ[live] = got
    return occ


def surface(S: RefScene, o, d, found, kind, idx, t, vc_rows):
    """Location, normal and vertex colour of each hit (geom.rs:230-233,
    264-303): the sphere normal outward, the triangle's geometric normal
    facing the ray, the vertex colours blended barycentrically."""
    location = o + d * torch.where(found, t, 0.0)[..., None]
    normal = torch.zeros_like(o)
    normal[..., 1] = 1.0
    vtx = torch.ones_like(o)
    if S.n_spheres:
        c = S.sph_center[torch.where(kind == KIND_SPHERE, idx, 0)]
        loc_s = o + d * t[..., None]
        n_s = vec.normalize_safe(loc_s - c)
        sel = (kind == KIND_SPHERE)[..., None]
        location = torch.where(sel, loc_s, location)
        normal = torch.where(sel, n_s, normal)
    if S.n_tris:
        ti = torch.where(kind == KIND_TRI, idx, 0)
        v0, v1, v2, n = S.tri_v0[ti], S.tri_v1[ti], S.tri_v2[ti], S.tri_n[ti]
        on = (kind == KIND_TRI)[..., None]
        # Lanes off triangles ask about a ray down the normal onto the
        # centroid, so every value stays finite for the backward.
        o_t = torch.where(on, o, (v0 + v1 + v2) / 3.0 + n)
        d_t = torch.where(on, d, -n)
        _, _, bx, by, bz, cos = GT.intersect(o_t, d_t, v0, v1, v2, n)
        geo_n = n * torch.where(cos > 0.0, -1.0, 1.0)[..., None]
        rows = vc_rows[ti]
        vc = (rows[:, 0:3] * bx[..., None] + rows[:, 3:6] * by[..., None]
              + rows[:, 6:9] * bz[..., None])
        normal = torch.where(on, geo_n, normal)
        vtx = torch.where(on, vc, vtx)
    return location, normal, vtx


def sky(S: RefScene, direction):
    if S.sky_type == FLAT:
        return S.sky_a.expand(direction.shape)
    cos_theta = direction[..., 1:2]
    return S.sky_a * cos_theta + S.sky_b * (1.0 - cos_theta)


def path_step(S: RefScene, bounce, state, u, vc_rows):
    """One bounce of trace.rs:13-118 for every lane."""
    (o, d, throughput, colour, alive, last_spec, excl_kind, excl_idx) = state
    o_eff = torch.where(alive[..., None], o, DEAD_ORIGIN)
    found, kind, idx, ent, t = intersect(S, o_eff, d, excl_kind, excl_idx)
    location, normal, vtx = surface(S, o_eff, d, found, kind, idx, t, vc_rows)

    miss = alive & ~found
    colour = colour + torch.where(miss[..., None], throughput * sky(S, -d), 0.0)
    alive = alive & found
    alive = alive & (vec.dot(d, -normal) > 0.0)

    use_v = S.mat_vertex[ent] & (kind == KIND_TRI)
    mat = dict(mtype=S.mat_mtype[ent],
               albedo=torch.where(use_v[..., None], vtx, S.mat_albedo[ent]),
               emit=torch.zeros_like(o), r0=S.mat_r0[ent],
               metalness=S.mat_metalness[ent], roughness=torch.zeros_like(t))
    is_light = S.ent_is_light[ent]
    gain = alive & is_light & last_spec
    colour = colour + torch.where(gain[..., None], throughput * S.ent_emission[ent], 0.0)
    alive = alive & ~is_light
    vec_out = -d

    if S.n_lights > 0:
        u_pick = u(bounce, H.DIM_LIGHT_PICK)
        li = torch.clamp_max((u_pick * S.n_lights).to(torch.int64), S.n_lights - 1)
        light = dict(ltype=torch.full_like(li, LT.SPHERE), position=S.light_pos[li],
                     radius=S.light_radius[li], colour=S.light_colour[li],
                     intensity=S.light_intensity[li])
        in_dir, inv_pdf, _ = LT.sample(light, location, u(bounce, H.DIM_LIGHT_U),
                                       u(bounce, H.DIM_LIGHT_V))
        shadow_dir = -in_dir
        shadow_o = location + normal * SHADOW_EPS
        cos_theta = torch.clamp_min(vec.dot(normal, shadow_dir), 0.0)
        brdf = M.eval_brdf(mat, vec_out, -shadow_dir, normal)
        direct = light["colour"] * light["intensity"][..., None] * brdf * inv_pdf[..., None]
        want = alive & (cos_theta > 0.0) & (vec.max_component(direct) > 0.0)
        # The query stops at the light's own surface along the ray.
        t_l, l_hit = _sphere_t(shadow_o, shadow_dir, S.light_pos.double()[li],
                               S.light_radius.double()[li])
        t_max = torch.where(l_hit, t_l, BIG)
        o_q = torch.where(want[..., None], shadow_o, DEAD_ORIGIN)
        occ = occluded(S, o_q, shadow_dir, kind, idx, t_max, S.light_ent[li])
        ok = want & ~occ
        colour = colour + torch.where(ok[..., None], direct * throughput, 0.0)

    new_dir, pdf, brdf, is_spec = M.sample(mat, vec_out, normal, u(bounce, H.DIM_LOBE),
                                           u(bounce, H.DIM_BSDF_U), u(bounce, H.DIM_BSDF_V))
    pdf_safe = torch.where(pdf == 0.0, 1.0, pdf)
    attenuation = torch.where((pdf == 0.0)[..., None], 0.0, brdf / pdf_safe[..., None])
    new_tp = throughput * attenuation
    dead = (vec.max_component(new_tp) <= 0.0) | ~torch.isfinite(new_tp).all(dim=-1)
    survival = vec.max_component(new_tp)
    rr_active = torch.as_tensor(bounce, device=o.device) >= RR_START
    rr_kill = rr_active & (u(bounce, H.DIM_RR) > survival)
    surv_safe = torch.where(survival == 0.0, 1.0, survival)
    new_tp = torch.where((rr_active & ~rr_kill)[..., None], new_tp / surv_safe[..., None],
                         new_tp)
    step_alive = alive & ~dead & ~rr_kill
    sa3 = step_alive[..., None]
    return (torch.where(sa3, location + normal * SHADOW_EPS, o),
            torch.where(sa3, new_dir, d),
            torch.where(sa3, new_tp, throughput), colour, step_alive,
            torch.where(step_alive, is_spec, last_spec),
            torch.where(step_alive, kind, excl_kind),
            torch.where(step_alive, idx, excl_idx))


def trace(S: RefScene, o, d, pixel_id, sample_id, seed, vc_rows=None):
    """Radiance along rays over the whole bounce schedule: (N, 3)."""
    if vc_rows is None:
        vc_rows = vertex_colour_rows(S)
    pixel_id, sample_id = H.as_u32(pixel_id), H.as_u32(sample_id)

    def u(bounce, dim):
        ctr = (H.mul32(H.as_u32(bounce, o.device), H.DIMS_PER_BOUNCE) + dim) & H.MASK32
        return H.uniform(seed, pixel_id, sample_id, ctr)

    n = o.shape[0]
    state = (o, d, torch.ones((n, 3), device=o.device), torch.zeros((n, 3), device=o.device),
             torch.ones(n, dtype=torch.bool, device=o.device),
             torch.ones(n, dtype=torch.bool, device=o.device),
             torch.zeros(n, dtype=torch.int64, device=o.device),
             torch.zeros(n, dtype=torch.int64, device=o.device))
    for bounce in range(S.max_bounces + 1):
        if not bool(state[4].any()):
            break
        state = path_step(S, bounce, state, u, vc_rows)
    return state[3]


def vertex_colour_rows(S: RefScene, vc=None):
    """(T, 9) rows of the three vertex colours (vc: their tensors, default
    the scene's)."""
    vc = vc or (S.tri_vc0, S.tri_vc1, S.tri_vc2)
    return torch.cat(list(vc), dim=1)


def render_wave(S: RefScene, cam, px, py, pixel_id, sample_id, seed, vc_rows=None):
    """One weighted sample per lane (worker.rs:77): (N, 3)."""
    o, d, w = camera_rays(cam, px, py, pixel_id, sample_id, seed)
    return trace(S, o, d, pixel_id, sample_id, seed, vc_rows) * w[..., None]


def render_sum(S: RefScene, cam, px, py, pixel_id, sample_start, n_samples, seed):
    """Sum of n_samples consecutive weighted samples per lane, accumulated
    in sample order in f32: (N, 3)."""
    acc = torch.zeros((px.shape[0], 3), device=px.device)
    for a in range(0, px.shape[0], LANES_PER_CALL):
        sl = slice(a, a + LANES_PER_CALL)
        for s in range(sample_start, sample_start + n_samples):
            sid = torch.full_like(pixel_id[sl], s)
            acc[sl] = acc[sl] + render_wave(S, cam, px[sl], py[sl], pixel_id[sl], sid, seed)
    return acc


def frame_mean(S: RefScene, width: int, height: int, spp: int, seed: int,
               sample_batch: int = 8):
    """(H, W, 3) f64 per-pixel means of samples 0..spp-1: each batch of
    sample_batch samples summed in f32, the batches summed in f64 (as the
    program's estimator folds them)."""
    import numpy as np

    pid = torch.arange(width * height, device=S.sph_center.device)
    px, py = pid % width, pid // width
    acc = np.zeros((width * height, 3))
    for s in range(0, spp, sample_batch):
        k = min(sample_batch, spp - s)
        acc += render_sum(S, S.camera, px, py, pid, s, k, seed).cpu().numpy().astype(np.float64)
    return (acc / spp).reshape(height, width, 3)
