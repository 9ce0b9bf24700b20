"""Wavefront path-tracing integrator.

Reference: src/trace.rs:7-121 (unidirectional path tracer with next-event
estimation and Russian roulette).  The reference recurses per ray on a CPU
thread; here an entire wavefront of rays advances in lockstep under one
``jax.jit``: fixed shapes, per-lane ``alive`` masks, and a ``lax.fori_loop``
over <=11 bounces (trace.rs:14 caps ``loops > 10``).

Semantics preserved exactly (see trace.rs line refs inline), with two
deliberate robustness deviations, both documented:
  - self-intersection is prevented by *excluding the originating primitive*
    from traversal (exact for convex spheres / planar triangles) in addition
    to the reference's normal*1e-4 origin offset (trace.rs:57,89) -- the
    offset alone is insufficient once the radius-1e6 ground spheres are
    traced in f32;
  - point lights use the evidently intended geometry (see lights.py) since
    the reference's point-light sampling is broken and unused.

All randomness is a counter-based pure function of (pixel, sample, bounce,
dim) -- see paths_tpu.sampling.hashing.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax.numpy as jnp
from jax import lax

from paths_tpu import lights as LT
from paths_tpu import materials as M
from paths_tpu import sky as SK
from paths_tpu.geom import sphere as GS
from paths_tpu.geom import triangle as GT
from paths_tpu.math import vec
from paths_tpu.sampling import hashing as H
from paths_tpu.scene.types import SceneArrays, SceneStatic

MAX_BOUNCES = 10  # trace.rs:14: `if loops > 10 break` -> 11 iterations
RR_START = 2  # trace.rs:104
SHADOW_EPS = 1e-4  # trace.rs:57,89
# numpy scalar, NOT a jnp array: a module-level jnp constant would be placed
# on whatever device is active at import time.
BIG = np.float32(3.4e38)

# Primitive kinds.
KIND_NONE = 0
KIND_SPHERE = 1
KIND_TRI = 2

_SPH_CHUNK = 128
_TRI_CHUNK = 256


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_chunks(arrs, n: int, chunk: int):
    """Pad leading dim to a multiple of chunk and reshape to
    (n_chunks, chunk, ...)."""
    npad = _ceil_to(max(n, 1), chunk)
    out = []
    for a in arrs:
        pad = [(0, npad - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        a = jnp.pad(a, pad)
        out.append(a.reshape((npad // chunk, chunk) + a.shape[1:]))
    return out, npad


# Below this primitive count, streams are unrolled per primitive: each test
# is pure (N,)-shaped elementwise math -- no (N, chunk) intermediates and no
# padding waste (a 6-sphere scene padded to a 128-wide chunk wastes 21x the
# flops).
_UNROLL_MAX = 64


def _scan_spheres(static: SceneStatic, scene: SceneArrays, o, d, excl_kind, excl_idx):
    """Closest sphere hit via a chunked scan (memory-bounded brute force).
    Returns (t_best [N], idx_best [N])."""
    S = static.n_spheres
    if S <= _UNROLL_MAX:
        excl = excl_kind == KIND_SPHERE
        t_best = jnp.full(o.shape[0], BIG)
        i_best = jnp.zeros(o.shape[0], jnp.int32)
        for s in range(S):
            t, hit = GS.intersect(o, d, scene.sph_center[s], scene.sph_radius[s])
            ok = hit & ~(excl & (excl_idx == s)) & (t < t_best)
            t_best = jnp.where(ok, t, t_best)
            i_best = jnp.where(ok, jnp.int32(s), i_best)
        return t_best, i_best
    (centers, radii), npad = _pad_chunks([scene.sph_center, scene.sph_radius], S, _SPH_CHUNK)
    n_chunks = npad // _SPH_CHUNK
    gidx = jnp.arange(npad, dtype=jnp.int32).reshape(n_chunks, _SPH_CHUNK)

    excl = (excl_kind == KIND_SPHERE)

    def body(carry, xs):
        c, r, gi = xs
        t, hit = GS.intersect(o[:, None, :], d[:, None, :], c[None, :, :], r[None, :])
        valid = (gi < S)[None, :]
        not_excl = ~(excl[:, None] & (excl_idx[:, None] == gi[None, :]))
        t = jnp.where(valid & not_excl, t, BIG)
        tmin = jnp.min(t, axis=1)
        amin = jnp.argmin(t, axis=1).astype(jnp.int32)
        best_t, best_i = carry
        better = tmin < best_t
        return (
            jnp.where(better, tmin, best_t),
            jnp.where(better, gi[amin], best_i),
        ), None

    init = (jnp.full(o.shape[0], BIG), jnp.zeros(o.shape[0], jnp.int32))
    (t_best, i_best), _ = lax.scan(body, init, (centers, radii, gidx))
    return t_best, i_best


def _scan_tris(static: SceneStatic, scene: SceneArrays, o, d, excl_kind, excl_idx):
    """Closest triangle hit via a chunked scan (brute force; the BVH path in
    paths_tpu.bvh.traverse replaces this for large meshes)."""
    T = static.n_tris
    if T <= _UNROLL_MAX:
        excl = excl_kind == KIND_TRI
        t_best = jnp.full(o.shape[0], BIG)
        i_best = jnp.zeros(o.shape[0], jnp.int32)
        for s in range(T):
            t, hit, *_ = GT.intersect(
                o, d, scene.tri_v0[s], scene.tri_v1[s], scene.tri_v2[s], scene.tri_n[s]
            )
            ok = hit & ~(excl & (excl_idx == s)) & (t < t_best)
            t_best = jnp.where(ok, t, t_best)
            i_best = jnp.where(ok, jnp.int32(s), i_best)
        return t_best, i_best
    (v0, v1, v2, n), npad = _pad_chunks(
        [scene.tri_v0, scene.tri_v1, scene.tri_v2, scene.tri_n], T, _TRI_CHUNK
    )
    n_chunks = npad // _TRI_CHUNK
    gidx = jnp.arange(npad, dtype=jnp.int32).reshape(n_chunks, _TRI_CHUNK)

    excl = (excl_kind == KIND_TRI)

    def body(carry, xs):
        cv0, cv1, cv2, cn, gi = xs
        t, hit, bx, by, bz, cos = GT.intersect(
            o[:, None, :], d[:, None, :],
            cv0[None], cv1[None], cv2[None], cn[None],
        )
        valid = (gi < T)[None, :]
        not_excl = ~(excl[:, None] & (excl_idx[:, None] == gi[None, :]))
        t = jnp.where(valid & not_excl, t, BIG)
        tmin = jnp.min(t, axis=1)
        amin = jnp.argmin(t, axis=1).astype(jnp.int32)
        best_t, best_i = carry
        better = tmin < best_t
        return (
            jnp.where(better, tmin, best_t),
            jnp.where(better, gi[amin], best_i),
        ), None

    init = (jnp.full(o.shape[0], BIG), jnp.zeros(o.shape[0], jnp.int32))
    (t_best, i_best), _ = lax.scan(body, init, (v0, v1, v2, n, gidx))
    return t_best, i_best


def _excl_tri(excl_kind, excl_idx):
    return jnp.where(excl_kind == KIND_TRI, excl_idx, jnp.int32(-1))


def intersect_brief(static, scene, o, d, excl_kind, excl_idx):
    """Closest hit, identity only: (found, kind, idx, ent, t).
    Used for shadow rays (trace.rs:61-66 only needs the occluder entity)."""
    N = o.shape[0]
    t = jnp.full(N, BIG)
    kind = jnp.zeros(N, jnp.int32)
    idx = jnp.zeros(N, jnp.int32)

    if static.has_spheres:
        ts, is_ = _scan_spheres(static, scene, o, d, excl_kind, excl_idx)
        better = ts < t
        t = jnp.where(better, ts, t)
        kind = jnp.where(better, KIND_SPHERE, kind)
        idx = jnp.where(better, is_, idx)
    if static.has_tris:
        if static.bvh_kernel:
            from paths_tpu.ops import bvh_walk

            tt, it = bvh_walk.closest_hit(
                scene.walk, o, d, _excl_tri(excl_kind, excl_idx), t
            )
        elif static.use_bvh:
            from paths_tpu.bvh.traverse import closest_hit_bvh

            tt, it = closest_hit_bvh(scene, o, d, excl_kind, excl_idx, t)
        else:
            tt, it = _scan_tris(static, scene, o, d, excl_kind, excl_idx)
        better = tt < t
        t = jnp.where(better, tt, t)
        kind = jnp.where(better, KIND_TRI, kind)
        idx = jnp.where(better, it, idx)

    found = t < BIG
    ent = jnp.where(kind == KIND_TRI, scene.tri_ent[idx],
                    jnp.where(kind == KIND_SPHERE, scene.sph_ent[idx], 0))
    kind = jnp.where(found, kind, KIND_NONE)
    return found, kind, idx, ent, t


def occluded_query(static, scene, o, d, excl_kind, excl_idx, t_max, excl_ent):
    """Shadow-ray occlusion: True per lane iff some primitive other than the
    originating one and other than entity ``excl_ent`` is hit at t < t_max.

    This is the any-hit form of the reference's shadow test: trace.rs:61-66
    finds the closest hit and compares its entity id to the sampled light's,
    which is equivalent to "no non-light hit before the light's own first
    intersection" -- the t_max the caller derives analytically.  Spheres
    (and, off the kernel path, triangles) derive it from the closest hit;
    the BVH walk kernel runs its any-hit form instead, where a lane stops at
    its first occluder.  Lanes whose contribution is already known zero
    arrive with origin pushed to 1e30 and miss the scene at once.

    Source-primitive exclusion is sound for BOTH kinds: a flat triangle
    cannot occlude its own offset ray, and a sphere is convex -- a shadow
    ray with cos_theta > 0 (above the local tangent plane, the only rays
    NEE casts) can never re-enter the sphere it left, from outside or
    inside.  So excluding the source only removes f32 acne, never real
    occlusion."""
    N = o.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (N,))
    excl_ent = jnp.broadcast_to(jnp.asarray(excl_ent, jnp.int32), (N,))
    if not (static.has_tris and static.bvh_kernel):
        # Anything closer than the light occludes; the light itself, when
        # closest, does not.
        f, _, _, e, t = intersect_brief(static, scene, o, d, excl_kind, excl_idx)
        return f & (t < t_max) & (e != excl_ent)

    from paths_tpu.ops import bvh_walk

    occ = jnp.zeros(N, bool)
    if static.has_spheres:
        ts, is_ = _scan_spheres(static, scene, o, d, excl_kind, excl_idx)
        occ = (ts < t_max) & (scene.sph_ent[is_] != excl_ent)
    o_eff = jnp.where(occ[..., None], 1e30, o)
    return occ | bvh_walk.occluded(
        scene.walk, o_eff, d, _excl_tri(excl_kind, excl_idx), excl_ent, t_max
    )


def intersect_full(static, scene, o, d, excl_kind, excl_idx):
    """Closest hit with full shading data.

    Returns dict(found, kind, idx, ent, t, location, normal, bary(3,),
    vtx_colour(3,)).  Normal follows the reference: sphere normal outward
    (geom.rs:232), triangle geometric normal backface-flipped
    (geom.rs:298-300) unless the mesh uses smooth normals, in which case the
    barycentric-interpolated (unnormalised!) vertex normal replaces it
    (scene.rs:178-190, model.rs:142-156)."""
    found, kind, idx, ent, t = intersect_brief(static, scene, o, d, excl_kind, excl_idx)
    N = o.shape[0]
    location = o + d * jnp.where(found, t, 0.0)[..., None]
    normal = jnp.zeros_like(o).at[..., 1].set(1.0)
    bary = jnp.zeros((N, 3))
    vtx_colour = jnp.ones((N, 3))

    if static.has_spheres:
        c = jnp.take(scene.sph_center, idx, axis=0)
        loc_s, n_s = GS.surface(o, d, t, c)
        sel = (kind == KIND_SPHERE)[..., None]
        location = jnp.where(sel, loc_s, location)
        normal = jnp.where(sel, n_s, normal)

    if static.has_tris:
        # One packed row gather for all per-triangle shading data instead
        # of twelve separate ones.
        ttable = jnp.concatenate(
            [
                scene.tri_v0, scene.tri_v1, scene.tri_v2, scene.tri_n,  # 0:12
                scene.tri_vn0, scene.tri_vn1, scene.tri_vn2,            # 12:21
                scene.tri_vc0, scene.tri_vc1, scene.tri_vc2,            # 21:30
                _f32col(scene.tri_smooth),                              # 30
            ],
            axis=1,
        )
        trows = jnp.take(ttable, idx, axis=0)
        v0 = trows[:, 0:3]
        v1 = trows[:, 3:6]
        v2 = trows[:, 6:9]
        n = trows[:, 9:12]
        # Recompute bary at the chosen triangle (cheaper than carrying it
        # through the scan).  Lanes that hit no triangle read some other
        # row and may get NaN weights; zero them, or the masked-off branch
        # of the selects below turns vertex-colour gradients into NaN.
        _, _, bx, by, bz, cos = GT.intersect(o, d, v0, v1, v2, n)
        on_tri = kind == KIND_TRI
        bx, by, bz = (jnp.where(on_tri, w, 0.0) for w in (bx, by, bz))
        flip = jnp.where(cos > 0.0, -1.0, 1.0)[..., None]
        geo_n = n * flip
        smooth_n = (
            trows[:, 12:15] * bx[..., None]
            + trows[:, 15:18] * by[..., None]
            + trows[:, 18:21] * bz[..., None]
        )
        tri_normal = jnp.where((trows[:, 30] > 0.5)[..., None], smooth_n, geo_n)
        vc = (
            trows[:, 21:24] * bx[..., None]
            + trows[:, 24:27] * by[..., None]
            + trows[:, 27:30] * bz[..., None]
        )
        sel = on_tri[..., None]
        normal = jnp.where(sel, tri_normal, normal)
        bary = jnp.where(sel, jnp.stack([bx, by, bz], -1), bary)
        vtx_colour = jnp.where(sel, vc, vtx_colour)

    return dict(
        found=found, kind=kind, idx=idx, ent=ent, t=t,
        location=location, normal=normal, bary=bary, vtx_colour=vtx_colour,
    )


def _f32col(a):
    return a.astype(jnp.float32)[:, None]


def _gather_material(static: SceneStatic, scene: SceneArrays, ent, kind, vtx_colour):
    """Per-lane material record + light identity, via ONE packed-row
    gather instead of per-column gathers; vertex-albedo
    resolution per material.rs:183-195 (only meaningful for triangle hits).
    Fresnel sub-material columns ride a second table only when the scene has
    a Fresnel material, so the common case pays exactly one gather.

    Returns (mat_record, is_light, light_emission)."""
    table = jnp.concatenate(
        [
            scene.mat_albedo,                       # 0:3
            scene.mat_emit,                         # 3:6
            _f32col(scene.mat_r0),                  # 6
            _f32col(scene.mat_metalness),           # 7
            _f32col(scene.mat_roughness),           # 8
            _f32col(scene.mat_mtype),               # 9
            _f32col(scene.mat_albedo_vertex),       # 10
            _f32col(scene.ent_is_light),            # 11
            scene.ent_light_emission,               # 12:15
        ],
        axis=1,
    )
    rows = jnp.take(table, ent, axis=0)
    albedo = rows[:, 0:3]
    use_v = (rows[:, 10] > 0.5) & (kind == KIND_TRI)
    albedo = jnp.where(use_v[..., None], vtx_colour, albedo)
    rec = dict(
        mtype=rows[:, 9].astype(jnp.int32),
        albedo=albedo,
        emit=rows[:, 3:6],
        r0=rows[:, 6],
        metalness=rows[:, 7],
        roughness=rows[:, 8],
    )
    if static.has_fresnel:
        ftable = jnp.concatenate(
            [
                _f32col(scene.mat_fd_mtype),        # 0
                _f32col(scene.mat_fs_mtype),        # 1
                scene.mat_fs_albedo,                # 2:5
                _f32col(scene.mat_fs_r0),           # 5
                _f32col(scene.mat_fs_metalness),    # 6
                _f32col(scene.mat_fs_roughness),    # 7
                _f32col(scene.mat_fresnel_r0),      # 8
            ],
            axis=1,
        )
        frows = jnp.take(ftable, ent, axis=0)
        rec.update(
            fd_mtype=frows[:, 0].astype(jnp.int32),
            fs_mtype=frows[:, 1].astype(jnp.int32),
            fs_albedo=frows[:, 2:5],
            fs_r0=frows[:, 5],
            fs_metalness=frows[:, 6],
            fs_roughness=frows[:, 7],
            fresnel_r0=frows[:, 8],
        )
    return rec, rows[:, 11] > 0.5, rows[:, 12:15]


def _gather_light(static: SceneStatic, scene: SceneArrays, li):
    table = jnp.concatenate(
        [
            _f32col(scene.light_ltype),             # 0
            scene.light_pos,                        # 1:4
            _f32col(scene.light_radius),            # 4
            scene.light_colour,                     # 5:8
            _f32col(scene.light_intensity),         # 8
            _f32col(scene.light_ent),               # 9
        ],
        axis=1,
    )
    rows = jnp.take(table, li, axis=0)
    return dict(
        ltype=rows[:, 0].astype(jnp.int32),
        position=rows[:, 1:4],
        radius=rows[:, 4],
        colour=rows[:, 5:8],
        intensity=rows[:, 8],
        ent_id=rows[:, 9].astype(jnp.int32),
    )


def path_step(static: SceneStatic, scene: SceneArrays, bounce, state, u):
    """Advance every lane's path by one segment (one bounce of trace.rs's
    loop, trace.rs:13-118).

    bounce: per-lane (N,) or scalar bounce index (RNG counter + RR gate).
    state: (o, d, throughput, colour, alive, last_spec, excl_kind, excl_idx).
    u(bounce, dim): per-lane uniform for this bounce and dimension slot.

    This is the shared hot body used both by the fixed-schedule
    ``trace_rays`` (differentiable) and the regenerating wavefront in
    paths_tpu.render (forward-only, no dead-lane waste).
    """
    env_nee = static.env_nee and static.sky_type == SK.HDRI
    (o, d, throughput, colour, alive, last_spec, excl_kind, excl_idx) = state

    # Dead lanes (RR-killed, retired regen slots) keep stale rays; pushing
    # their origins far outside the scene makes the BVH root test reject
    # them at once instead of walking a stale ray.  Results are masked by
    # `alive` everywhere downstream, so this is purely a performance select.
    o_eff = jnp.where(alive[..., None], o, 1e30)

    hit = intersect_full(static, scene, o_eff, d, excl_kind, excl_idx)

    # Miss -> skybox, evaluated at -direction (trace.rs:18-23).  With
    # environment NEE active, diffuse-bounce misses are already covered
    # by the env samples, so the escaping ray only collects the sky on a
    # specular previous bounce -- the same double-counting rule the
    # reference applies to area lights (trace.rs:30-41).
    sky_col = SK.ambient_light(static.sky_type, scene.sky, -d)
    miss = alive & ~hit["found"]
    if env_nee:
        miss = miss & last_spec
    colour = colour + jnp.where(miss[..., None], throughput * sky_col, 0.0)
    alive = alive & hit["found"]

    # Facing check (trace.rs:25-28): cos_in = d . -n must be > 0.
    normal = hit["normal"]
    cos_in = vec.dot(d, -normal)
    alive = alive & (cos_in > 0.0)

    # Material + light identity in one packed-row selection.
    mat, is_light, light_emission = _gather_material(
        static, scene, hit["ent"], hit["kind"], hit["vtx_colour"]
    )

    # Direct light hit (trace.rs:30-41): accumulate only on specular
    # previous bounce (NEE covers the rest); path ends either way.
    light_gain = alive & is_light & last_spec
    colour = colour + jnp.where(
        light_gain[..., None], throughput * light_emission, 0.0
    )
    alive = alive & ~is_light

    location = hit["location"]
    vec_out = -d

    # ---- Next Event Estimation (trace.rs:52-81) ----
    if static.n_lights > 0:
        u_pick = u(bounce, H.DIM_LIGHT_PICK)
        li = jnp.minimum(
            (u_pick * static.n_lights).astype(jnp.int32), static.n_lights - 1
        )
        light = _gather_light(static, scene, li)
        in_dir, inv_pdf, max_dist = LT.sample(
            light, location, u(bounce, H.DIM_LIGHT_U), u(bounce, H.DIM_LIGHT_V)
        )
        shadow_dir = -in_dir
        shadow_o = location + normal * SHADOW_EPS
        cos_theta = jnp.maximum(0.0, vec.dot(normal, shadow_dir))
        brdf = M.eval_brdf(mat, vec_out, -shadow_dir, normal)
        direct = (
            light["colour"]
            * light["intensity"][..., None]
            * brdf
            * inv_pdf[..., None]
        )
        # The shadow ray only matters where the unshadowed contribution is
        # nonzero: alive, front-facing, pdf > 0 (uniform sphere sampling
        # back-faces half its samples, inv_pdf == 0), and a BRDF that talks
        # to NEE at all (mirrors report BLACK, material.rs:265-267).  Dead
        # lanes get their origin pushed out so the occlusion walk rejects
        # them at the root.
        want = (
            alive
            & (cos_theta > 0.0)
            & (vec.max_component(direct) > 0.0)
        )
        is_point = light["ltype"] == LT.POINT
        # Bound the query at the light itself: its analytic entry distance
        # (sphere lights -- equivalent to the reference's occluder-identity
        # check, trace.rs:61-66) or the point light's distance.  A sphere
        # sample whose ray numerically misses its own light keeps t_max BIG,
        # matching the closest-hit formulation (anything hit occludes).
        t_light, l_hit = GS.intersect(
            shadow_o, shadow_dir, light["position"], light["radius"]
        )
        t_max_q = jnp.where(
            is_point, max_dist, jnp.where(l_hit, t_light, jnp.float32(BIG))
        )
        excl_ent_q = jnp.where(is_point, jnp.int32(-1), light["ent_id"])
        shadow_o_eff = jnp.where(want[..., None], shadow_o, 1e30)
        occluded = occluded_query(
            static, scene, shadow_o_eff, shadow_dir, hit["kind"], hit["idx"],
            t_max_q, excl_ent_q,
        )
        ok = want & ~occluded
        colour = colour + jnp.where(ok[..., None], direct * throughput, 0.0)

    # ---- Environment NEE (capability extension; SURVEY.md section 7
    # stage 5: 2D-CDF importance sampling of the HDRI for direct
    # lighting, where the reference only collects skybox on miss) ----
    if env_nee:
        e_dir, e_inv_pdf, e_rad = SK.sample_env(
            scene.sky,
            u(bounce, H.DIM_ENV_CDF),
            u(bounce, H.DIM_ENV_JX),
            u(bounce, H.DIM_ENV_JY),
        )
        e_shadow_dir = -e_dir  # surface -> sky
        e_shadow_o = location + normal * SHADOW_EPS
        e_cos = vec.dot(normal, e_shadow_dir)
        e_brdf = M.eval_brdf(mat, vec_out, e_dir, normal)
        e_direct = e_rad * e_brdf * e_inv_pdf[..., None]
        # Any hit at all blocks the sky; mask lanes whose contribution is
        # already zero so the occlusion walk skips them (see NEE above).
        e_want = (
            alive & (e_cos > 0.0) & (vec.max_component(e_direct) > 0.0)
        )
        e_o_eff = jnp.where(e_want[..., None], e_shadow_o, 1e30)
        e_occ = occluded_query(
            static, scene, e_o_eff, e_shadow_dir, hit["kind"], hit["idx"],
            jnp.float32(BIG), jnp.int32(-1),
        )
        e_ok = e_want & ~e_occ
        colour = colour + jnp.where(e_ok[..., None], e_direct * throughput, 0.0)

    # ---- BSDF sample & bounce (trace.rs:84-101) ----
    new_dir, pdf, brdf, is_spec = M.sample(
        mat, vec_out, normal,
        u(bounce, H.DIM_LOBE), u(bounce, H.DIM_BSDF_U), u(bounce, H.DIM_BSDF_V),
    )
    pdf_safe = jnp.where(pdf == 0.0, 1.0, pdf)
    attenuation = jnp.where(
        (pdf == 0.0)[..., None], 0.0, brdf / pdf_safe[..., None]
    )
    new_throughput = throughput * attenuation
    # Non-finite throughput (pdf underflow at grazing samples -> brdf/pdf
    # overflows; inf/inf in the RR division would then mint NaNs) terminates
    # the path -- the analogue of the reference panicking on its energy
    # checks (colour.rs:56-60) instead of propagating garbage.
    tp_finite = jnp.isfinite(new_throughput).all(axis=-1)
    dead = (vec.max_component(new_throughput) <= 0.0) | ~tp_finite  # trace.rs:96-98

    emit = M.emittance(mat)  # trace.rs:100-101 (post-attenuation T)
    colour = colour + jnp.where(
        (alive & ~dead)[..., None], emit * new_throughput, 0.0
    )

    # Russian roulette from bounce 2 (trace.rs:103-111).
    survival = vec.max_component(new_throughput)
    u_rr = u(bounce, H.DIM_RR)
    rr_active = bounce >= RR_START
    rr_kill = rr_active & (u_rr > survival)
    survival_safe = jnp.where(survival == 0.0, 1.0, survival)
    new_throughput = jnp.where(
        (rr_active & ~rr_kill)[..., None],
        new_throughput / survival_safe[..., None],
        new_throughput,
    )

    step_alive = alive & ~dead & ~rr_kill
    throughput = jnp.where(step_alive[..., None], new_throughput, throughput)
    o = jnp.where(step_alive[..., None], location + normal * SHADOW_EPS, o)
    d = jnp.where(step_alive[..., None], new_dir, d)
    last_spec = jnp.where(step_alive, is_spec, last_spec)
    excl_kind = jnp.where(step_alive, hit["kind"], excl_kind)
    excl_idx = jnp.where(step_alive, hit["idx"], excl_idx)

    return (o, d, throughput, colour, step_alive, last_spec, excl_kind, excl_idx)


def fresh_path_state(o, d):
    """Initial per-lane path state for freshly generated rays
    (trace.rs:9-11)."""
    N = o.shape[0]
    return (
        o,
        d,
        jnp.ones((N, 3)),
        jnp.zeros((N, 3)),
        jnp.ones(N, bool),
        jnp.ones(N, bool),  # trace.rs:11: first light hit counts
        jnp.full(N, KIND_NONE, jnp.int32),
        jnp.zeros(N, jnp.int32),
    )


def trace_rays(
    static: SceneStatic,
    scene: SceneArrays,
    ray_o: jnp.ndarray,  # (N, 3)
    ray_d: jnp.ndarray,  # (N, 3)
    pixel_id: jnp.ndarray,  # (N,) uint32 -- RNG identity
    sample_id: jnp.ndarray,  # (N,) uint32
    seed,
) -> jnp.ndarray:
    """Estimate radiance along N rays.  Pure, jit-able, differentiable in
    ``scene``'s continuous parameters.  Returns (N, 3)."""
    seed = jnp.asarray(seed).astype(jnp.uint32)

    def u(bounce, dim):
        return H.uniform(
            seed, pixel_id, sample_id,
            jnp.asarray(bounce).astype(jnp.uint32) * jnp.uint32(H.DIMS_PER_BOUNCE)
            + jnp.uint32(dim),
        )

    def body(bounce, state):
        # Whole-wave early out: once every lane is dead (common from bounce
        # ~3 on), skip the remaining bounce iterations entirely.  The
        # predicate is a scalar so lax.cond stays jit-able under SPMD.
        alive = state[4]
        return lax.cond(
            jnp.any(alive),
            lambda s: path_step(static, scene, bounce, s, u),
            lambda s: s,
            state,
        )

    state = fresh_path_state(ray_o, ray_d)
    state = lax.fori_loop(0, static.max_bounces + 1, body, state)
    return state[3]
