"""Brute-force oracle for the BVH walks (bvh/traverse.py, ops/bvh_walk.py).

Two f32 implementations of one walk may disagree where the answer is
ill-conditioned: two triangles at the same distance, a ray through a
triangle's edge, a hit at the query's limit, or a ray whose origin is so
far out that the hit point is lost to rounding.  A compiler that contracts
a multiply and an add into one FMA moves those cases.  So the oracle tests
every ray against every triangle with the renderer's own formula
(geom/triangle.py) and a per-pair rounding bound, and returns two
distances per lane:

  robust_hi   nearest hit that is certain (barycentric margin and t clear
              of the edges and the limit by more than the bound), plus its
              t error bound; BIG where there is none;
  possible_lo nearest hit that rounding could make real, minus its bound;
              BIG where there is none.

A correct closest hit lies in [possible_lo, robust_hi] and a miss is only
correct where robust_hi is BIG.  A correct any-hit occludes wherever a
robust hit exists and only where a possible one does.  Lanes with origins
at 1e29 or beyond are the integrator's dead lanes and must miss.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

BIG = np.float32(3.4e38)
EPS32 = float(np.finfo(np.float32).eps)
DEAD = 1e29
CHUNK = 128


def _pairs(o, d, v0, v1, v2, n):
    """Per (lane, triangle): t, hit validity, barycentric margin and the
    rounding bounds of both (lanes on axis 0, triangles on axis 1)."""
    dot = lambda a, b: jnp.sum(a * b, axis=-1)
    o, d = o[:, None], d[:, None]
    cos = dot(n, d)
    denom = jnp.where(cos == 0.0, 1.0, cos)
    t = (dot(n, v0) - dot(n, o)) / denom
    p = o + d * t[..., None]
    area = dot(n, jnp.cross(v1 - v0, v2 - v0))
    denom_a = jnp.where(area == 0.0, 1.0, area)
    bx = dot(n, jnp.cross(v1 - p, v2 - p)) / denom_a
    by = dot(n, jnp.cross(v2 - p, v0 - p)) / denom_a
    margin = jnp.minimum(jnp.minimum(bx, by), 1.0 - bx - by)
    amax = lambda a: jnp.max(jnp.abs(a), axis=-1)
    scale = amax(o) + amax(p) + amax(v0) + 1.0
    reach = (jnp.linalg.norm(v0 - p, axis=-1) + jnp.linalg.norm(v1 - p, axis=-1)
             + jnp.linalg.norm(v2 - p, axis=-1))
    err_b = 16 * EPS32 * scale * reach / jnp.abs(denom_a)
    err_t = 16 * EPS32 * (amax(v0) + amax(o)) / jnp.abs(denom) + 1e-5 * jnp.abs(t)
    ok = (cos != 0.0) & (area != 0.0) & jnp.isfinite(t) & jnp.isfinite(margin)
    return t, ok, margin, err_b, err_t


@jax.jit
def bounds(v0, v1, v2, n, ent, o, d, excl, limit, excl_ent):
    """(robust_hi, possible_lo) per lane for hits with t < limit on
    triangles other than ``excl`` and not of entity ``excl_ent`` (-1: any
    entity qualifies)."""
    T = v0.shape[0]
    pad = -T % CHUNK
    tri = [jnp.pad(a, ((0, pad), (0, 0))).reshape(-1, CHUNK, 3)
           for a in (v0, v1, v2, n)]
    ids = jnp.arange(T + pad, dtype=jnp.int32).reshape(-1, CHUNK)
    ents = jnp.pad(ent, (0, pad)).reshape(-1, CHUNK)
    dead = jnp.max(jnp.abs(o), axis=-1) >= DEAD

    def body(carry, xs):
        robust_hi, possible_lo = carry
        cv0, cv1, cv2, cn, ci, ce = xs
        t, ok, margin, err_b, err_t = _pairs(o, d, cv0, cv1, cv2, cn)
        ok = ok & (ci[None] < T) & (ci[None] != excl[:, None])
        ok = ok & ((excl_ent[:, None] < 0) | (ce[None] != excl_ent[:, None]))
        ok = ok & ~dead[:, None]
        lim = limit[:, None]
        robust = ok & (margin > err_b) & (t - err_t >= 0.0) & (t + err_t < lim)
        possible = ok & (margin >= -err_b) & (t + err_t >= 0.0) & (t - err_t < lim)
        robust_hi = jnp.minimum(
            robust_hi, jnp.min(jnp.where(robust, t + err_t, BIG), axis=1))
        possible_lo = jnp.minimum(
            possible_lo, jnp.min(jnp.where(possible, t - err_t, BIG), axis=1))
        return (robust_hi, possible_lo), None

    init = (jnp.full(o.shape[0], BIG), jnp.full(o.shape[0], BIG))
    (robust_hi, possible_lo), _ = lax.scan(body, init, (*tri, ids, ents))
    return robust_hi, possible_lo


@jax.jit
def index_is_possible(v0, v1, v2, n, o, d, t, idx):
    """Whether triangle ``idx`` is a possible hit of each lane at ``t``."""
    tt, ok, margin, err_b, err_t = _pairs(
        o, d, v0[idx][:, None], v1[idx][:, None], v2[idx][:, None],
        n[idx][:, None])
    tt, ok, margin, err_b, err_t = (a[:, 0] for a in (tt, ok, margin, err_b, err_t))
    return ok & (margin >= -err_b) & (jnp.abs(tt - t) <= err_t + 1e-5 * jnp.abs(t))


def closest_ok(tris, o, d, excl, t_init, t, idx):
    """Per lane: is (t, idx) a correct closest hit (t = BIG for a miss)?"""
    v0, v1, v2, n, ent = tris
    minus = jnp.full(excl.shape, -1, jnp.int32)
    robust_hi, possible_lo = bounds(v0, v1, v2, n, ent, o, d, excl, t_init, minus)
    hit = t < BIG
    in_range = (t >= possible_lo) & (t <= robust_hi)
    idx_ok = index_is_possible(v0, v1, v2, n, o, d, t, idx)
    return np.asarray(jnp.where(hit, in_range & idx_ok, robust_hi >= BIG))


def anyhit_ok(tris, o, d, excl, excl_ent, t_max, occ):
    """Per lane: is ``occ`` a correct any-hit answer?"""
    v0, v1, v2, n, ent = tris
    robust_hi, possible_lo = bounds(v0, v1, v2, n, ent, o, d, excl, t_max, excl_ent)
    return np.asarray(jnp.where(occ, possible_lo < BIG, robust_hi >= BIG))


@jax.jit
def _reference_walk(bvh, v0, v1, v2, n, o, d, kind, excl, t_init):
    from types import SimpleNamespace

    from paths_tpu.bvh.traverse import closest_hit_bvh

    scene = SimpleNamespace(bvh=bvh, tri_v0=v0, tri_v1=v1, tri_v2=v2, tri_n=n)
    return closest_hit_bvh(scene, o, d, kind, excl, t_init)


def salt(rng, o, d, n_tris, frac=0.05):
    """Salt a wave with the lanes that break careless walks: dead lanes
    (origin 1e30), near-overflow live origins (1e18), axis-parallel
    directions (slab t = +-inf / NaN) and excluded triangles.  Returns
    (o, d, excl) as numpy arrays."""
    o = np.array(o, np.float32)
    d = np.array(d, np.float32)
    n = len(o)
    k = max(1, int(n * frac))
    lanes = rng.permutation(n)
    dead, far, axis, ex = (lanes[i * k:(i + 1) * k] for i in range(4))
    o[dead] = 1e30
    o[far] = np.float32(1e18) * np.where(o[far] < 0, -1.0, 1.0)
    d[axis] = 0.0
    d[axis, rng.integers(0, 3, len(axis))] = rng.choice([-1.0, 1.0], len(axis))
    excl = np.full(n, -1, np.int32)
    excl[ex] = rng.integers(0, n_tris, len(ex))
    return o, d, excl


def walk_parity(tables, scene, o, d, excl, t_max, excl_ent, n_brute=4096,
                interpret=False):
    """Compare the GPU walk kernel (ops/bvh_walk.py) with the plain walk
    (bvh/traverse.py) on every lane, and check both against the brute-force
    bounds on the first ``n_brute`` lanes plus every lane where the two
    disagree (up to ``n_brute`` of them).  ``scene`` needs .bvh and the
    tri_* arrays.  Returns a dict of counts: ``*_bad`` must be zero."""
    from paths_tpu.ops import bvh_walk

    o, d = jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
    excl = jnp.asarray(excl, jnp.int32)
    t_max = jnp.asarray(t_max, jnp.float32)
    excl_ent = jnp.asarray(excl_ent, jnp.int32)
    n = o.shape[0]
    kind = jnp.where(excl >= 0, 2, 0)
    big = jnp.full(n, BIG)
    tris = (scene.tri_v0, scene.tri_v1, scene.tri_v2, scene.tri_n, scene.tri_ent)

    walk_args = (scene.bvh, *tris[:4], o, d, kind, excl)
    t_k, i_k = bvh_walk.closest_hit(tables, o, d, excl, big, interpret=interpret)
    t_r, i_r = _reference_walk(*walk_args, big)
    occ_k = bvh_walk.occluded(tables, o, d, excl, excl_ent, t_max,
                              interpret=interpret)
    t_q, i_q = _reference_walk(*walk_args, t_max)
    t_k, i_k, t_r, i_r, occ_k, t_q, i_q = (
        np.asarray(a) for a in (t_k, i_k, t_r, i_r, occ_k, t_q, i_q))
    ent = np.asarray(scene.tri_ent)
    # Closest-hit-derived occlusion equals any-hit where every triangle
    # shares one entity; elsewhere only the brute-force bounds decide.
    occ_r = (t_q < BIG) & (ent[i_q] != np.asarray(excl_ent))

    hit_k, hit_r = t_k < BIG, t_r < BIG
    both = hit_k & hit_r
    rel = np.where(both, np.abs(t_k - t_r) / np.maximum(np.abs(t_r), 1e-30), 0.0)
    closest_differ = (hit_k != hit_r) | (both & ((i_k != i_r) | (rel > 1e-5)))
    anyhit_differ = occ_k != occ_r

    def lanes(differ):
        extra = np.nonzero(differ)[0][:n_brute]
        sel = np.concatenate([np.arange(min(n, n_brute)), extra])
        return np.pad(sel, (0, 2 * n_brute - len(sel)), mode="edge")

    sel = lanes(closest_differ)
    sub = lambda a: jnp.asarray(np.asarray(a)[sel])
    args = (tris, sub(o), sub(d), sub(excl), sub(big))
    bad_k = ~closest_ok(*args, sub(t_k), sub(i_k))
    bad_r = ~closest_ok(*args, sub(t_r), sub(i_r))
    sel_a = lanes(anyhit_differ)
    sub = lambda a: jnp.asarray(np.asarray(a)[sel_a])
    bad_a = ~anyhit_ok(tris, sub(o), sub(d), sub(excl), sub(excl_ent),
                       sub(t_max), sub(occ_k))
    same = both & (i_k == i_r)
    return dict(
        lanes=int(n),
        hits=int(hit_k.sum()),
        t_rel_max=float(rel[same].max()) if same.any() else 0.0,
        closest_differ=int(closest_differ.sum()),
        closest_bad=int(len(np.unique(sel[bad_k]))),
        reference_bad=int(len(np.unique(sel[bad_r]))),
        occluded=int(occ_k.sum()),
        anyhit_differ=int(anyhit_differ.sum()),
        anyhit_bad=int(len(np.unique(sel_a[bad_a]))),
        checked=int(len(np.unique(sel))),
    )
