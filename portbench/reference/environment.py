"""The reference for scenes lit by an HDRI sky with environment NEE, in
plain float32 PyTorch: its own RGBE reader, the equirectangular lookup, the
importance-sampling tables and their sampler, and a shading step whose
direct light is the sky's.  It imports nothing of the program; the camera,
intersection, occlusion, surface, materials, hash and CMJ are
``trace.py``'s and the scene ``scene.py``'s, built with the skybox set
aside and the map attached after.

Departures from the upstream, each as the reference package states it:

- environment NEE is the reference package's extension: upstream only
  collects the sky on a miss (trace.rs:18-23).  With it on, each bounce
  samples the map for direct light and sends an any-hit query with no
  bound and no excluded entity (any hit blocks the sky); a ray that escapes
  collects the sky only after a specular bounce, the rule for area lights
  (trace.rs:30-41);
- the lookup (scene.rs:95-111) floors the texel coordinates and clamps
  them to the map, a NaN coordinate to texel 0;
- the tables weight a texel by its luminance times the sine of its
  latitude, build the flat CDF over all texels in float64 and keep it in
  float32, and take each texel's reciprocal solid-angle pdf from the
  float64 probabilities.  At a 4096x2048 map many float32 CDF steps are 0
  and others far from their probabilities: the sampler and the weights
  disagree, as they do in the program (a recorded fault, not fixed here);
- scenes without lights only (the environment is the light).

The scene's numbers are the configuration's, as ``scene.py`` reads them:
a big sphere's centre and radius in float64 for its float64 test (the
ground at y -1000002.8, which float32 would put 1.25 cm lower).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import hashing as H
from portbench.reference import materials as M
from portbench.reference import scene as RS
from portbench.reference import trace as RT
from portbench.reference import vec

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PI = 3.141592653589793


def read_rgbe(path: str) -> np.ndarray:
    """(H, W, 3) float32 linear RGB of a Radiance file in the ``-Y h +X w``
    raster, each scanline flat or new-style RLE (2, 2, width, then each of
    the four components as runs (128 + n, byte) and literals (n, bytes))."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith((b"#?RADIANCE", b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance file")
    head, sep, rest = data.partition(b"\n\n")
    if not sep or b"FORMAT=32-bit_rle_rgbe" not in head:
        raise ValueError(f"{path}: no 32-bit_rle_rgbe header")
    res, _, body = rest.partition(b"\n")
    p = res.split()
    if len(p) != 4 or p[0] != b"-Y" or p[2] != b"+X":
        raise ValueError(f"{path}: unsupported raster {res!r}")
    h, w = int(p[1]), int(p[3])
    out = np.empty((h, 4, w), np.uint8)
    off = 0
    for y in range(h):
        if body[off:off + 2] == b"\x02\x02" and (body[off + 2] << 8 | body[off + 3]) == w:
            off += 4
            for c in range(4):
                row = bytearray(w)
                x = 0
                while x < w:
                    n = body[off]
                    if n > 128:
                        row[x:x + n - 128] = body[off + 1:off + 2] * (n - 128)
                        x, off = x + n - 128, off + 2
                    else:
                        row[x:x + n] = body[off + 1:off + 1 + n]
                        x, off = x + n, off + 1 + n
                out[y, c] = np.frombuffer(row, np.uint8)
        else:
            out[y] = np.frombuffer(body, np.uint8, 4 * w, off).reshape(w, 4).T
            off += 4 * w
    e = out[:, 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136)).astype(np.float32)
    return np.moveaxis(out[:, :3], 1, 2).astype(np.float32) * scale[..., None]


@dataclass
class EnvMap:
    image: torch.Tensor  # (H, W, 3) f32
    cdf: torch.Tensor  # (H*W,) f32, inclusive
    inv_pdf: torch.Tensor  # (H, W) f32: 1 / solid-angle pdf, 0 off the energy


def env_map(image: np.ndarray, device) -> EnvMap:
    """The map and its sampling tables, built in float64 and kept in
    float32."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[0], img.shape[1]
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    lat = PI * (1.0 - (np.arange(h, dtype=np.float64) + 0.5) / h)
    sin_lat = np.maximum(np.sin(lat), 0.0)
    weight = lum.astype(np.float64) * sin_lat[:, None]
    if weight.sum() <= 0.0:  # a black map: uniform over the sphere
        weight = np.ones_like(weight) * sin_lat[:, None]
    prob = weight / weight.sum()
    omega = (PI / h) * (2.0 * PI / w) * sin_lat[:, None]
    inv_pdf = np.where(prob > 0.0, omega / np.maximum(prob, 1e-30), 0.0)
    cdf = np.cumsum(prob.reshape(-1))
    cdf[-1] = 1.0
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return EnvMap(f32(img), f32(cdf), f32(inv_pdf))


def _texel(v, n):
    """floor(v) clamped to [0, n - 1], NaN to 0; clamped again as an index,
    since a lower precision may round n - 1 up to n."""
    t = torch.nan_to_num(torch.floor(v).clamp(0, n - 1), nan=0.0)
    return t.to(torch.int64).clamp(0, n - 1)


def lookup(env: EnvMap, direction):
    """The map's radiance seen along (..., 3) directions."""
    h, w = env.image.shape[0], env.image.shape[1]
    lat = torch.arccos(direction[..., 1].clamp(-1.0, 1.0))
    long = torch.atan2(direction[..., 2], direction[..., 0])
    x = (w / 2.0) * (long / PI) + w / 2.0
    y = h * (1.0 - lat / PI)
    return env.image[_texel(y, h), _texel(x, w)]


def sample_env(env: EnvMap, u_cdf, u_jx, u_jy):
    """(in_dir, inv_pdf, radiance) of a texel drawn by the CDF and a point
    jittered inside it: in_dir points from the sky toward the surface, so
    ``lookup(env, in_dir)`` is the radiance of a ray escaping along
    -in_dir."""
    h, w = env.image.shape[0], env.image.shape[1]
    idx = torch.searchsorted(env.cdf, u_cdf.contiguous(), right=True).clamp(0, h * w - 1)
    y, x = idx // w, idx % w
    long = PI * (2.0 * (x.to(torch.float32) + u_jx) / w - 1.0)
    lat = PI * (1.0 - (y.to(torch.float32) + u_jy) / h)
    s = torch.sin(lat)
    in_dir = torch.stack([s * torch.cos(long), torch.cos(lat), s * torch.sin(long)], dim=-1)
    return in_dir, env.inv_pdf[y, x], env.image[y, x]


@dataclass
class EnvScene:
    scene: RS.RefScene
    env: EnvMap


def build(scene: dict, base_dir: str, device) -> EnvScene:
    """The reference's scene of a configuration whose skybox is an HDRI
    (its file resolved against base_dir) and which has no lights."""
    sky = scene.get("skybox") or {}
    if str(sky.get("type", "")).lower() != "hdri":
        raise ValueError("the environment reference needs an HDRI skybox")
    if scene.get("lights"):
        raise ValueError("the environment reference supports scenes without lights")
    S = RS.build(dict(scene, skybox={"type": "Flat"}), base_dir, device)
    env = env_map(read_rgbe(os.path.join(base_dir, sky["filename"])), device)
    return EnvScene(S, env)


def path_step(E: EnvScene, bounce, state, u, vc_rows):
    """One bounce of trace.rs:13-118 with the sky as the light: environment
    NEE, and a miss collecting the sky only after a specular bounce."""
    S = E.scene
    (o, d, throughput, colour, alive, last_spec, excl_kind, excl_idx) = state
    o_eff = torch.where(alive[..., None], o, RT.DEAD_ORIGIN)
    found, kind, idx, ent, t = RT.intersect(S, o_eff, d, excl_kind, excl_idx)
    location, normal, vtx = RT.surface(S, o_eff, d, found, kind, idx, t, vc_rows)

    miss = alive & ~found & last_spec
    colour = colour + torch.where(miss[..., None], throughput * lookup(E.env, -d), 0.0)
    alive = alive & found & (vec.dot(d, -normal) > 0.0)

    use_v = S.mat_vertex[ent] & (kind == RT.KIND_TRI)
    mat = dict(mtype=S.mat_mtype[ent],
               albedo=torch.where(use_v[..., None], vtx, S.mat_albedo[ent]),
               emit=torch.zeros_like(o), r0=S.mat_r0[ent],
               metalness=S.mat_metalness[ent], roughness=torch.zeros_like(t))
    vec_out = -d

    e_dir, inv_pdf, radiance = sample_env(E.env, u(bounce, H.DIM_ENV_CDF),
                                          u(bounce, H.DIM_ENV_JX), u(bounce, H.DIM_ENV_JY))
    shadow_dir = -e_dir
    direct = radiance * M.eval_brdf(mat, vec_out, e_dir, normal) * inv_pdf[..., None]
    want = alive & (vec.dot(normal, shadow_dir) > 0.0) & (vec.max_component(direct) > 0.0)
    o_q = torch.where(want[..., None], location + normal * RT.SHADOW_EPS, RT.DEAD_ORIGIN)
    n = o.shape[0]
    occ = RT.occluded(S, o_q, shadow_dir, kind, idx, torch.full((n,), RT.BIG, device=o.device),
                      torch.full((n,), -1, dtype=torch.int64, device=o.device))
    colour = colour + torch.where((want & ~occ)[..., None], direct * throughput, 0.0)

    new_dir, pdf, brdf, is_spec = M.sample(mat, vec_out, normal, u(bounce, H.DIM_LOBE),
                                           u(bounce, H.DIM_BSDF_U), u(bounce, H.DIM_BSDF_V))
    pdf_safe = torch.where(pdf == 0.0, 1.0, pdf)
    attenuation = torch.where((pdf == 0.0)[..., None], 0.0, brdf / pdf_safe[..., None])
    new_tp = throughput * attenuation
    dead = (vec.max_component(new_tp) <= 0.0) | ~torch.isfinite(new_tp).all(dim=-1)
    survival = vec.max_component(new_tp)
    rr_active = torch.as_tensor(bounce, device=o.device) >= RT.RR_START
    rr_kill = rr_active & (u(bounce, H.DIM_RR) > survival)
    surv_safe = torch.where(survival == 0.0, 1.0, survival)
    new_tp = torch.where((rr_active & ~rr_kill)[..., None], new_tp / surv_safe[..., None],
                         new_tp)
    step_alive = alive & ~dead & ~rr_kill
    sa3 = step_alive[..., None]
    return (torch.where(sa3, location + normal * RT.SHADOW_EPS, o),
            torch.where(sa3, new_dir, d),
            torch.where(sa3, new_tp, throughput), colour, step_alive,
            torch.where(step_alive, is_spec, last_spec),
            torch.where(step_alive, kind, excl_kind),
            torch.where(step_alive, idx, excl_idx))


def trace(E: EnvScene, o, d, pixel_id, sample_id, seed, vc_rows):
    """Radiance along rays over the whole bounce schedule: (N, 3)."""
    pixel_id, sample_id = H.as_u32(pixel_id), H.as_u32(sample_id)

    def u(bounce, dim):
        ctr = (H.mul32(H.as_u32(bounce, o.device), H.DIMS_PER_BOUNCE) + dim) & H.MASK32
        return H.uniform(seed, pixel_id, sample_id, ctr)

    n = o.shape[0]
    z = torch.zeros(n, dtype=torch.int64, device=o.device)
    on = torch.ones(n, dtype=torch.bool, device=o.device)
    state = (o, d, torch.ones((n, 3), device=o.device), torch.zeros((n, 3), device=o.device),
             on, on, z, z)
    for bounce in range(E.scene.max_bounces + 1):
        if not bool(state[4].any()):
            break
        state = path_step(E, bounce, state, u, vc_rows)
    return state[3]


def frame_mean(E: EnvScene, width: int, height: int, spp: int, seed: int,
               sample_batch: int = 8):
    """(H, W, 3) f64 per-pixel means of samples 0..spp-1, as
    ``trace.frame_mean`` folds them: each batch of sample_batch weighted
    samples summed in f32, the batches in f64."""
    S = E.scene
    device = S.sph_center.device
    vc_rows = RT.vertex_colour_rows(S)
    pid = torch.arange(width * height, device=device)
    px, py = pid % width, pid // width
    acc = np.zeros((width * height, 3))
    for s0 in range(0, spp, sample_batch):
        part = torch.zeros((pid.shape[0], 3), device=device)
        for a in range(0, pid.shape[0], RT.LANES_PER_CALL):
            sl = slice(a, a + RT.LANES_PER_CALL)
            for s in range(s0, min(s0 + sample_batch, spp)):
                sid = torch.full_like(pid[sl], s)
                o, d, w = RT.camera_rays(S.camera, px[sl], py[sl], pid[sl], sid, seed)
                part[sl] = part[sl] + trace(E, o, d, pid[sl], sid, seed, vc_rows) * w[..., None]
        acc += part.cpu().numpy().astype(np.float64)
    return (acc / spp).reshape(height, width, 3)
