"""Vectorised BSDF sampling and evaluation with material-id dispatch.

Reference: src/material.rs.  The reference dispatches through a Rust enum per
ray; here every lane of the wavefront carries a material id and per-lane
parameters gathered from the scene's SoA entity table, and all lobes are
evaluated branchlessly then selected -- the wavefront replacement for enum
dispatch.

Material ids:
  0 Lambertian   (material.rs:198-240)
  1 Mirror       (material.rs:242-272)
  2 Gloss        (material.rs:274-371)  -- Schlick lerp of Lambertian/Mirror
  3 CookTorrance (material.rs:430-524)  -- Beckmann microfacet
  4 Fresnel      (material.rs:373-428)  -- Fresnel blend of two sub-materials

Semantics preserved exactly, including:
  - the reference's non-unit cosine-hemisphere sample (geom.rs:10-24 uses
    y = 1-u, then normalises) -- the *distribution* differs slightly from a
    true cosine lobe but brdf/pdf still collapses to albedo;
  - Mirror brdf == BLACK for NEE (material.rs:268-271);
  - Gloss specular_chance = r if r0 > 0.5 else 0.5 (material.rs:307-310);
  - Material::sample only implemented for Lambertian/Mirror/Gloss in the
    reference (material.rs:81-88 panics otherwise); we additionally implement
    CookTorrance sampling (a capability extension -- Beckmann importance
    sample per material.rs:465-499) instead of crashing.

A "material record" is a dict of per-lane arrays with keys:
  mtype (i32), albedo (.,3), emit (.,3), r0, metalness, roughness
"""

from __future__ import annotations

import jax.numpy as jnp

from paths_tpu.math import vec

LAMBERTIAN = 0
MIRROR = 1
GLOSS = 2
COOK_TORRANCE = 3
FRESNEL = 4

_PI = 3.141592653589793
_INV_PI = 1.0 / _PI


def cosine_hemisphere_local(u, v):
    """The reference's hemisphere sample (geom.rs:10-24): NOT unit length
    before normalisation (y = 1-u), y is up."""
    r = jnp.sqrt(u)
    theta = 2.0 * _PI * v
    return jnp.stack([r * jnp.cos(theta), 1.0 - u, r * jnp.sin(theta)], axis=-1)


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
    """Beckmann NDF as written in material.rs:437-447 (via alpha = acos).

    Runs branchlessly for EVERY lane (the material dispatch selects after
    the fact), so it must have finite gradients even at roughness == 0:
    the old ``e / max(pi m2 c2 c2, 1e-20)`` form floored the denominator at
    1e-20, whose reciprocal-square in the division VJP overflows f32 to
    inf, and 0 * inf minted NaN cotangents that poisoned
    d/d(roughness) for every GLOSS entity (where-NaN-grad trap).  Using
    the same guarded m2 in both the exponent and the normalisation keeps
    the denominator >= ~1e-36 pre-floor and a double-where zeroes the
    floored region exactly (e == 0 there anyway)."""
    m2 = roughness * roughness
    m2e = jnp.maximum(m2, 1e-12)
    c = jnp.clip(cos_h, -1.0, 1.0)
    c2 = jnp.maximum(c * c, 1e-12)
    tan2 = (1.0 - c2) / c2
    e = jnp.exp(-tan2 / m2e)
    den = _PI * m2e * c2 * c2
    live = den > 1e-20
    d0 = jnp.where(live, e / jnp.where(live, den, 1.0), 0.0)
    return jnp.maximum(0.0, d0 * c)


def eval_lambertian_brdf(albedo, vec_in, normal):
    """material.rs:237-239: albedo * (n . -vec_in) / pi.  vec_in points
    *into* the surface (reference convention)."""
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
    vdh_safe = jnp.where(vdh == 0.0, 1e-12, vdh)
    g = jnp.clip(
        jnp.minimum((2.0 * ndh * ndv) / vdh_safe, (2.0 * ndh * ndl) / vdh_safe),
        0.0,
        1.0,
    )
    denom = 4.0 * ndv * ndl
    denom_safe = jnp.where(denom == 0.0, 1e-12, denom)
    return albedo * ((d * g) / denom_safe)[..., None]


def _basic_brdf(mtype, albedo, r0, metalness, roughness, vec_out, vec_in, normal):
    """BasicMaterial::brdf dispatch (material.rs:120-128) over the four basic
    lobes.  vec_out points away from the surface toward the previous vertex;
    vec_in points into the surface from the light.  Returns (..., 3)."""
    lam = eval_lambertian_brdf(albedo, vec_in, normal)
    # Mirror: BLACK (material.rs:268-271).
    mirror = jnp.zeros_like(lam)
    # Gloss (material.rs:360-370): diffuse*(1-metal)*(1-r); specular term is
    # the mirror brdf == BLACK.
    r = schlick(r0, vec.dot(vec_out, normal))
    gloss = lam * ((1.0 - metalness) * (1.0 - r))[..., None]
    ct = eval_cook_torrance_brdf(albedo, roughness, vec_out, vec_in, normal)
    mt = mtype[..., None]
    out = jnp.where(mt == LAMBERTIAN, lam, 0.0)
    out = jnp.where(mt == MIRROR, mirror, out)
    out = jnp.where(mt == GLOSS, gloss, out)
    out = jnp.where(mt == COOK_TORRANCE, ct, out)
    return out


def eval_brdf(mat, vec_out, vec_in, normal):
    """Material::brdf dispatch including FresnelCombination
    (material.rs:421-427): diffuse*(1-r) + specular*r with r the Schlick
    weight from the refractive-index r0.  The Fresnel sub-material columns
    (fd_/fs_) are present in the record only when the scene contains a
    Fresnel material (SceneStatic.has_fresnel), so ordinary scenes pay
    nothing for the second dispatch."""
    primary = _basic_brdf(
        mat["mtype"], mat["albedo"], mat["r0"], mat["metalness"],
        mat["roughness"], vec_out, vec_in, normal,
    )
    if "fresnel_r0" not in mat:
        return primary
    # Diffuse sub-material lives in the primary columns under fd_mtype.
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
    return jnp.where(mat["mtype"][..., None] == FRESNEL, blended, primary)


def emittance(mat):
    """Material::emittance (material.rs:110-118): only Lambertian emits;
    Fresnel defers to its diffuse sub-material (material.rs:416-418)."""
    is_lam = mat["mtype"] == LAMBERTIAN
    if "fresnel_r0" in mat:
        is_lam = is_lam | ((mat["mtype"] == FRESNEL) & (mat["fd_mtype"] == LAMBERTIAN))
    return jnp.where(is_lam[..., None], mat["emit"], 0.0)


def _basic_sample(mtype, albedo, r0, metalness, roughness, vec_out, normal,
                  u_lobe, u1, u2):
    """BasicMaterial::sample dispatch (material.rs:81-88).

    vec_out: unit vector from the surface toward the previous path vertex.
    u_lobe, u1, u2: per-lane uniforms.

    Returns (direction, pdf, brdf, is_specular):
      direction: next bounce direction (unit),
      pdf / brdf follow the reference exactly so attenuation brdf/pdf
      reproduces trace.rs:93.
    """
    mat = dict(mtype=mtype, albedo=albedo, r0=r0, metalness=metalness,
               roughness=roughness)
    n_dot = vec.dot(normal, vec_out)

    # --- Lambertian sample (material.rs:211-216) ---
    diff_dir = sample_hemisphere_world(normal, u1, u2)
    diff_cos = vec.dot(normal, diff_dir)
    diff_pdf = diff_cos * _INV_PI  # weight_pdf(.., -dir, n) = n.dir/pi
    diff_brdf = mat["albedo"] * (diff_cos * _INV_PI)[..., None]

    # --- Mirror sample (material.rs:250-252) ---
    mirr_dir = vec.reflect(vec_out, normal)
    mirr_pdf = jnp.ones_like(diff_pdf)
    mirr_brdf = jnp.ones_like(diff_brdf)

    # --- Gloss sample (material.rs:302-325) ---
    r = schlick(mat["r0"], n_dot)
    spec_chance = jnp.where(mat["r0"] > 0.5, r, 0.5)
    gloss_is_spec = u_lobe <= spec_chance
    metal = mat["metalness"][..., None]
    gloss_spec_brdf = (mat["albedo"] * metal + (1.0 - metal)) * r[..., None]
    gloss_diff_brdf = diff_brdf * ((1.0 - metal) * (1.0 - r[..., None]))
    gloss_dir = jnp.where(gloss_is_spec[..., None], mirr_dir, diff_dir)
    gloss_pdf = jnp.where(
        gloss_is_spec, spec_chance, diff_pdf * (1.0 - spec_chance)
    )
    gloss_brdf = jnp.where(gloss_is_spec[..., None], gloss_spec_brdf, gloss_diff_brdf)

    # --- CookTorrance sample (extension; material.rs:465-499 semantics) ---
    a = mat["roughness"]
    # theta = atan(sqrt(-a^2 ln(1-u))) -> cos/sin via identities.
    t2 = -(a * a) * jnp.log(jnp.maximum(1.0 - u1, 1e-12))
    ct_cos = 1.0 / jnp.sqrt(1.0 + t2)
    # Double-where around the sqrt: at roughness == 0 (every non-CT lane --
    # the lobe runs branchlessly for the whole wave) sin^2 is exactly 0 and
    # sqrt's infinite slope there turns the zero cotangent of the unselected
    # branch into 0 * inf = NaN, poisoning d/d(roughness) for *gloss*
    # entities (the classic where-NaN-grad trap).  Forward value unchanged.
    s2 = jnp.maximum(1.0 - ct_cos * ct_cos, 0.0)
    ct_sin = jnp.where(s2 > 0.0, jnp.sqrt(jnp.where(s2 > 0.0, s2, 1.0)), 0.0)
    phi = 2.0 * _PI * u2
    facet_local = jnp.stack(
        [ct_sin * jnp.cos(phi), ct_cos, ct_sin * jnp.sin(phi)], axis=-1
    )
    i, j, k = vec.form_basis(normal)
    facet_world = vec.normalize_safe(vec.switch_basis(facet_local, i, j, k))
    ct_dir = vec.reflect(vec_out, facet_world)
    # weight_pdf (material.rs:451-462): d * |n.h| / (4 |v.h|)
    h = vec.normalize_safe(vec_out - (-ct_dir))
    ct_d = _beckmann_d(a, vec.dot(normal, h))
    ct_pdf = ct_d * jnp.abs(vec.dot(normal, h)) / jnp.maximum(
        4.0 * jnp.abs(vec.dot(vec_out, h)), 1e-12
    )
    ct_brdf = eval_cook_torrance_brdf(mat["albedo"], a, vec_out, -ct_dir, normal)

    mt = mat["mtype"]
    mt3 = mt[..., None]
    direction = jnp.where(mt3 == LAMBERTIAN, diff_dir, gloss_dir)
    direction = jnp.where(mt3 == MIRROR, mirr_dir, direction)
    direction = jnp.where(mt3 == COOK_TORRANCE, ct_dir, direction)
    pdf = jnp.where(mt == LAMBERTIAN, diff_pdf, gloss_pdf)
    pdf = jnp.where(mt == MIRROR, mirr_pdf, pdf)
    pdf = jnp.where(mt == COOK_TORRANCE, ct_pdf, pdf)
    brdf = jnp.where(mt3 == LAMBERTIAN, diff_brdf, gloss_brdf)
    brdf = jnp.where(mt3 == MIRROR, mirr_brdf, brdf)
    brdf = jnp.where(mt3 == COOK_TORRANCE, ct_brdf, brdf)
    is_specular = jnp.where(
        mt == MIRROR, True, jnp.where(mt == GLOSS, gloss_is_spec, False)
    )
    return direction, pdf, brdf, is_specular


def sample(mat, vec_out, normal, u_lobe, u1, u2):
    """Material::sample including FresnelCombination (capability extension:
    the reference panics on Fresnel sample, material.rs:81-88 /
    material.rs:398-413 only implements the NEE-side sample_pdf).  The
    mixture picks the specular sub-material with probability r (the Schlick
    weight, matching sample_pdf's branch probability) and folds the branch
    probability into pdf and brdf exactly like Gloss does
    (material.rs:302-325), so attenuation brdf/pdf stays unbiased."""
    direction, pdf, brdf, is_spec = _basic_sample(
        mat["mtype"], mat["albedo"], mat["r0"], mat["metalness"],
        mat["roughness"], vec_out, normal, u_lobe, u1, u2,
    )
    if "fresnel_r0" not in mat:
        return direction, pdf, brdf, is_spec

    r = schlick(mat["fresnel_r0"], vec.dot(vec_out, normal))
    pick_spec = u_lobe <= r
    # Re-uniformise u_lobe within the chosen branch so sub-materials with
    # their own lobe choice (Gloss) still see a uniform variate.
    u_spec = u_lobe / jnp.maximum(r, 1e-8)
    u_diff = (u_lobe - r) / jnp.maximum(1.0 - r, 1e-8)
    d_dir, d_pdf, d_brdf, d_is_spec = _basic_sample(
        mat["fd_mtype"], mat["albedo"], mat["r0"], mat["metalness"],
        mat["roughness"], vec_out, normal, u_diff, u1, u2,
    )
    s_dir, s_pdf, s_brdf, s_is_spec = _basic_sample(
        mat["fs_mtype"], mat["fs_albedo"], mat["fs_r0"], mat["fs_metalness"],
        mat["fs_roughness"], vec_out, normal, u_spec, u1, u2,
    )
    ps3 = pick_spec[..., None]
    f_dir = jnp.where(ps3, s_dir, d_dir)
    f_pdf = jnp.where(pick_spec, r * s_pdf, (1.0 - r) * d_pdf)
    f_brdf = jnp.where(ps3, s_brdf * r[..., None], d_brdf * (1.0 - r)[..., None])
    f_is_spec = jnp.where(pick_spec, s_is_spec, d_is_spec)

    is_fres = mat["mtype"] == FRESNEL
    if3 = is_fres[..., None]
    return (
        jnp.where(if3, f_dir, direction),
        jnp.where(is_fres, f_pdf, pdf),
        jnp.where(if3, f_brdf, brdf),
        jnp.where(is_fres, f_is_spec, is_spec),
    )
