"""Stackless BVH traversal as a vectorised gather + select loop.

The reference walks its cluster tree with an explicit per-ray stack,
descending the nearer child first (bvh.rs:78-141).  Per-lane stacks don't
vectorise; instead every ray carries a single node cursor through the
preorder layout built by bvh/build.py:

    cursor = AABB hit ? hit_link : miss_link

with closest-hit pruning folded into the slab test (tmin < t_best, the same
early-out as bvh.rs:16).  Leaves intersect a shape-static LEAF_SIZE block of
triangles.  The loop is a single ``lax.while_loop`` over the whole wavefront;
a lane finishing early (cursor == -1) just idles until the wave drains.
It is the CPU path for large meshes and the plain reference the GPU kernel
(ops/bvh_walk.py) is tested against.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from paths_tpu.bvh.build import LEAF_SIZE
from paths_tpu.geom import triangle as GT
from paths_tpu.math import vec

BIG = np.float32(3.4e38)  # numpy, not jnp: see integrator.py BIG comment


def closest_hit_bvh(scene, o, d, excl_kind, excl_idx, t_init):
    """Closest triangle hit via the skip-link BVH.

    o, d: (N, 3); t_init: (N,) initial best distance (e.g. from the sphere
    pass, enabling cross-primitive pruning).  Returns (t, idx).
    KIND_TRI exclusion handled via excl_kind/excl_idx (see integrator.py).

    The walk is a discrete selector: (t, idx) carry no gradients, so its ray
    and table inputs are cut from autodiff (reverse mode cannot pass a
    while_loop); shading recomputes everything differentiable at the
    returned index.
    """
    bvh, o, d, t_init = lax.stop_gradient((scene.bvh, o, d, t_init))
    tri_v0, tri_v1, tri_v2, tri_n = lax.stop_gradient(
        (scene.tri_v0, scene.tri_v1, scene.tri_v2, scene.tri_n))
    N = o.shape[0]
    inv_d = 1.0 / d
    excl = excl_kind == 2  # KIND_TRI
    excl_i = jnp.where(excl, excl_idx, jnp.int32(-1))

    def cond(state):
        cursor, t_best, i_best = state
        return jnp.any(cursor >= 0)

    def body(state):
        cursor, t_best, i_best = state
        cur = jnp.maximum(cursor, 0)  # safe gather index for finished lanes
        nmin = bvh.node_min[cur]
        nmax = bvh.node_max[cur]
        t0 = (nmin - o) * inv_d
        t1 = (nmax - o) * inv_d
        tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
        hit = (tmin < tmax) & (tmin < t_best) & (tmax > 0.0)

        count = bvh.prim_count[cur]
        start = bvh.prim_start[cur]
        do_leaf = hit & (count > 0)

        for k in range(LEAF_SIZE):
            pidx = start + k
            pidx_safe = jnp.minimum(pidx, tri_v0.shape[0] - 1)
            v0 = tri_v0[pidx_safe]
            v1 = tri_v1[pidx_safe]
            v2 = tri_v2[pidx_safe]
            n = tri_n[pidx_safe]
            t, h, *_ = GT.intersect(o, d, v0, v1, v2, n)
            ok = (
                do_leaf
                & (k < count)
                & h
                & (t < t_best)
                & (pidx_safe != excl_i)
            )
            t_best = jnp.where(ok, t, t_best)
            i_best = jnp.where(ok, pidx_safe, i_best)

        nxt = jnp.where(hit, bvh.hit_link[cur], bvh.miss_link[cur])
        cursor = jnp.where(cursor >= 0, nxt, cursor)
        return cursor, t_best, i_best

    cursor0 = jnp.zeros(N, jnp.int32)
    state = (cursor0, t_init.astype(jnp.float32), jnp.zeros(N, jnp.int32))
    cursor, t_best, i_best = lax.while_loop(cond, body, state)
    t_out = jnp.where(t_best < t_init, t_best, BIG)
    return t_out, i_best
