"""Vectorised BSDF sampling and evaluation with material-id dispatch (port
of ``paths_tpu/materials.py``).

Reference: src/material.rs.  Every lane carries a material id and per-lane
parameters gathered from the scene's entity table; all lobes are evaluated
branchlessly and then selected.

Material ids:
  0 Lambertian   (material.rs:198-240)
  1 Mirror       (material.rs:242-272)
  2 Gloss        (material.rs:274-371)  -- Schlick lerp of Lambertian/Mirror
  3 CookTorrance (material.rs:430-524)  -- Beckmann microfacet
  4 Fresnel      (material.rs:373-428)  -- Fresnel blend of two sub-materials

Semantics as the reference package, including the non-unit cosine
hemisphere sample (geom.rs:10-24), Mirror brdf == BLACK for NEE, the Gloss
specular chance rule (material.rs:307-310) and CookTorrance/Fresnel
sampling (capability extensions over upstream).

A "material record" is a dict of per-lane tensors with keys
mtype (i32), albedo (.,3), emit (.,3), r0, metalness, roughness
(+ fd_mtype, fs_* and fresnel_r0 when the scene has a Fresnel material).
"""

from __future__ import annotations

import torch

from portbench.reference import vec

LAMBERTIAN = 0
MIRROR = 1
GLOSS = 2
COOK_TORRANCE = 3
FRESNEL = 4

_PI = 3.141592653589793
_INV_PI = 1.0 / _PI


def cosine_hemisphere_local(u, v):
    """geom.rs:10-24: NOT unit length before normalisation (y = 1-u)."""
    r = vec.sqrt(u)
    theta = 2.0 * _PI * v
    return torch.stack([r * torch.cos(theta), 1.0 - u, r * torch.sin(theta)], dim=-1)


def sample_hemisphere_world(normal, u, v):
    """Cosine-ish hemisphere sample about `normal`, normalised
    (material.rs:224-231)."""
    local = cosine_hemisphere_local(u, v)
    i, j, k = vec.form_basis(normal)
    return vec.normalize_safe(vec.switch_basis(local, i, j, k))


def schlick(r0, cos_theta):
    """Schlick Fresnel: r0 + (1-r0)(1-cos)^5 (material.rs:303-305)."""
    m = 1.0 - cos_theta
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


def _beckmann_d(roughness, cos_h):
    """Beckmann NDF as written in material.rs:437-447, with the reference
    package's guarded denominator and double-where, kept as written (they
    keep gradients finite at roughness == 0)."""
    m2 = roughness * roughness
    m2e = torch.clamp_min(m2, 1e-12)
    c = torch.clamp(cos_h, -1.0, 1.0)
    c2 = torch.clamp_min(c * c, 1e-12)
    tan2 = (1.0 - c2) / c2
    e = torch.exp(-tan2 / m2e)
    den = _PI * m2e * c2 * c2
    live = den > 1e-20
    d0 = torch.where(live, e / torch.where(live, den, 1.0), 0.0)
    return torch.clamp_min(d0 * c, 0.0)


def eval_lambertian_brdf(albedo, vec_in, normal):
    """material.rs:237-239: albedo * (n . -vec_in) / pi."""
    cos = vec.dot(normal, -vec_in)
    return albedo * (cos * _INV_PI)[..., None]


def eval_cook_torrance_brdf(albedo, roughness, vec_out, vec_in, normal):
    """material.rs:505-523."""
    h = vec.normalize_safe(vec_out - vec_in)
    d = _beckmann_d(roughness, vec.dot(normal, h))
    ndl = vec.dot(normal, -vec_in)
    vdh = vec.dot(vec_out, h)
    ndh = vec.dot(normal, h)
    ndv = vec.dot(normal, vec_out)
    vdh_safe = torch.where(vdh == 0.0, 1e-12, vdh)
    g = torch.clamp(
        torch.minimum((2.0 * ndh * ndv) / vdh_safe, (2.0 * ndh * ndl) / vdh_safe),
        0.0,
        1.0,
    )
    denom = 4.0 * ndv * ndl
    denom_safe = torch.where(denom == 0.0, 1e-12, denom)
    return albedo * ((d * g) / denom_safe)[..., None]


def _basic_brdf(mtype, albedo, r0, metalness, roughness, vec_out, vec_in, normal):
    """BasicMaterial::brdf dispatch (material.rs:120-128)."""
    lam = eval_lambertian_brdf(albedo, vec_in, normal)
    mirror = torch.zeros_like(lam)  # material.rs:268-271
    r = schlick(r0, vec.dot(vec_out, normal))
    gloss = lam * ((1.0 - metalness) * (1.0 - r))[..., None]
    ct = eval_cook_torrance_brdf(albedo, roughness, vec_out, vec_in, normal)
    mt = mtype[..., None]
    out = torch.where(mt == LAMBERTIAN, lam, 0.0)
    out = torch.where(mt == MIRROR, mirror, out)
    out = torch.where(mt == GLOSS, gloss, out)
    out = torch.where(mt == COOK_TORRANCE, ct, out)
    return out


def eval_brdf(mat, vec_out, vec_in, normal):
    """Material::brdf including FresnelCombination (material.rs:421-427)."""
    primary = _basic_brdf(
        mat["mtype"], mat["albedo"], mat["r0"], mat["metalness"],
        mat["roughness"], vec_out, vec_in, normal,
    )
    if "fresnel_r0" not in mat:
        return primary
    diff = _basic_brdf(
        mat["fd_mtype"], mat["albedo"], mat["r0"], mat["metalness"],
        mat["roughness"], vec_out, vec_in, normal,
    )
    spec = _basic_brdf(
        mat["fs_mtype"], mat["fs_albedo"], mat["fs_r0"], mat["fs_metalness"],
        mat["fs_roughness"], vec_out, vec_in, normal,
    )
    r = schlick(mat["fresnel_r0"], vec.dot(vec_out, normal))[..., None]
    blended = diff * (1.0 - r) + spec * r
    return torch.where(mat["mtype"][..., None] == FRESNEL, blended, primary)


def emittance(mat):
    """Material::emittance (material.rs:110-118): only Lambertian emits;
    Fresnel defers to its diffuse sub-material (material.rs:416-418)."""
    is_lam = mat["mtype"] == LAMBERTIAN
    if "fresnel_r0" in mat:
        is_lam = is_lam | ((mat["mtype"] == FRESNEL) & (mat["fd_mtype"] == LAMBERTIAN))
    return torch.where(is_lam[..., None], mat["emit"], 0.0)


def _basic_sample(mtype, albedo, r0, metalness, roughness, vec_out, normal,
                  u_lobe, u1, u2):
    """BasicMaterial::sample dispatch (material.rs:81-88).  Returns
    (direction, pdf, brdf, is_specular) as the reference package does."""
    n_dot = vec.dot(normal, vec_out)

    # Lambertian (material.rs:211-216).
    diff_dir = sample_hemisphere_world(normal, u1, u2)
    diff_cos = vec.dot(normal, diff_dir)
    diff_pdf = diff_cos * _INV_PI
    diff_brdf = albedo * (diff_cos * _INV_PI)[..., None]

    # Mirror (material.rs:250-252).
    mirr_dir = vec.reflect(vec_out, normal)
    mirr_pdf = torch.ones_like(diff_pdf)
    mirr_brdf = torch.ones_like(diff_brdf)

    # Gloss (material.rs:302-325).
    r = schlick(r0, n_dot)
    spec_chance = torch.where(r0 > 0.5, r, 0.5)
    gloss_is_spec = u_lobe <= spec_chance
    metal = metalness[..., None]
    gloss_spec_brdf = (albedo * metal + (1.0 - metal)) * r[..., None]
    gloss_diff_brdf = diff_brdf * ((1.0 - metal) * (1.0 - r[..., None]))
    gloss_dir = torch.where(gloss_is_spec[..., None], mirr_dir, diff_dir)
    gloss_pdf = torch.where(gloss_is_spec, spec_chance, diff_pdf * (1.0 - spec_chance))
    gloss_brdf = torch.where(gloss_is_spec[..., None], gloss_spec_brdf, gloss_diff_brdf)

    # CookTorrance (extension; material.rs:465-499 semantics).
    a = roughness
    t2 = -(a * a) * torch.log(torch.clamp_min(1.0 - u1, 1e-12))
    ct_cos = 1.0 / vec.sqrt(1.0 + t2)
    # Double-where around the sqrt, kept as the reference package writes it.
    s2 = torch.clamp_min(1.0 - ct_cos * ct_cos, 0.0)
    ct_sin = torch.where(s2 > 0.0, vec.sqrt(torch.where(s2 > 0.0, s2, 1.0)), 0.0)
    phi = 2.0 * _PI * u2
    facet_local = torch.stack(
        [ct_sin * torch.cos(phi), ct_cos, ct_sin * torch.sin(phi)], dim=-1
    )
    i, j, k = vec.form_basis(normal)
    facet_world = vec.normalize_safe(vec.switch_basis(facet_local, i, j, k))
    ct_dir = vec.reflect(vec_out, facet_world)
    h = vec.normalize_safe(vec_out - (-ct_dir))
    ct_d = _beckmann_d(a, vec.dot(normal, h))
    ct_pdf = ct_d * torch.abs(vec.dot(normal, h)) / torch.clamp_min(
        4.0 * torch.abs(vec.dot(vec_out, h)), 1e-12
    )
    ct_brdf = eval_cook_torrance_brdf(albedo, a, vec_out, -ct_dir, normal)

    mt = mtype
    mt3 = mt[..., None]
    direction = torch.where(mt3 == LAMBERTIAN, diff_dir, gloss_dir)
    direction = torch.where(mt3 == MIRROR, mirr_dir, direction)
    direction = torch.where(mt3 == COOK_TORRANCE, ct_dir, direction)
    pdf = torch.where(mt == LAMBERTIAN, diff_pdf, gloss_pdf)
    pdf = torch.where(mt == MIRROR, mirr_pdf, pdf)
    pdf = torch.where(mt == COOK_TORRANCE, ct_pdf, pdf)
    brdf = torch.where(mt3 == LAMBERTIAN, diff_brdf, gloss_brdf)
    brdf = torch.where(mt3 == MIRROR, mirr_brdf, brdf)
    brdf = torch.where(mt3 == COOK_TORRANCE, ct_brdf, brdf)
    is_specular = (mt == MIRROR) | ((mt == GLOSS) & gloss_is_spec)
    return direction, pdf, brdf, is_specular


def sample(mat, vec_out, normal, u_lobe, u1, u2):
    """Material::sample including FresnelCombination: the mixture picks the
    specular sub-material with probability r (the Schlick weight) and folds
    the branch probability into pdf and brdf, as Gloss does."""
    direction, pdf, brdf, is_spec = _basic_sample(
        mat["mtype"], mat["albedo"], mat["r0"], mat["metalness"],
        mat["roughness"], vec_out, normal, u_lobe, u1, u2,
    )
    if "fresnel_r0" not in mat:
        return direction, pdf, brdf, is_spec

    r = schlick(mat["fresnel_r0"], vec.dot(vec_out, normal))
    pick_spec = u_lobe <= r
    # Re-uniformise u_lobe within the chosen branch.
    u_spec = u_lobe / torch.clamp_min(r, 1e-8)
    u_diff = (u_lobe - r) / torch.clamp_min(1.0 - r, 1e-8)
    d_dir, d_pdf, d_brdf, d_is_spec = _basic_sample(
        mat["fd_mtype"], mat["albedo"], mat["r0"], mat["metalness"],
        mat["roughness"], vec_out, normal, u_diff, u1, u2,
    )
    s_dir, s_pdf, s_brdf, s_is_spec = _basic_sample(
        mat["fs_mtype"], mat["fs_albedo"], mat["fs_r0"], mat["fs_metalness"],
        mat["fs_roughness"], vec_out, normal, u_spec, u1, u2,
    )
    ps3 = pick_spec[..., None]
    f_dir = torch.where(ps3, s_dir, d_dir)
    f_pdf = torch.where(pick_spec, r * s_pdf, (1.0 - r) * d_pdf)
    f_brdf = torch.where(ps3, s_brdf * r[..., None], d_brdf * (1.0 - r)[..., None])
    f_is_spec = torch.where(pick_spec, s_is_spec, d_is_spec)

    is_fres = mat["mtype"] == FRESNEL
    if3 = is_fres[..., None]
    return (
        torch.where(if3, f_dir, direction),
        torch.where(is_fres, f_pdf, pdf),
        torch.where(if3, f_brdf, brdf),
        torch.where(is_fres, f_is_spec, is_spec),
    )
