"""Skip-link BVH walk as a GPU kernel (Pallas, Triton route).

The same walk as the plain reference in bvh/traverse.py -- cursor = AABB hit
? hit_link : miss_link over the preorder layout of bvh/build.py -- but one
ray per lane and the whole walk inside one kernel: each program takes
``BLOCK`` lanes and loops until every lane of its block has left the tree.
A lane that finishes early idles only until its own block drains, not the
whole wave, and the loop costs no kernel launches or host round trips.

Tables are row-packed so that one lane's node or triangle fetch is one
contiguous row (32 or 64 bytes):

  nodes  (n_nodes, NODE_W) f32: min xyz, max xyz, miss link, leaf code
         (the two ints stored bit-for-bit; leaf code = start << 4 | count,
         -1 for an inner node, whose hit link is always the next row);
  tris   (n_tris, TRI_W) f32: v0, v1, v2, n (xyz each), entity id (bits).

Both are flattened to 1-D so each field is one gather by ``row * W + k``.
Triangle rows keep the scene's (BVH-ordered) triangle order, so indices
returned here index SceneArrays' triangle arrays directly.

The kernel is a discrete selector: its outputs (t, index, occluded) carry
no gradients, so the wrappers stop gradients at the ray and table inputs.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from paths_tpu.bvh.build import LEAF_SIZE

BIG = np.float32(3.4e38)  # numpy, not jnp: see integrator.py BIG comment
NODE_W = 8
TRI_W = 16
# Lanes per program, one warp per 32 lanes.  One warp per program measured
# fastest on the H100 for every wave of the dragon (32 < 64 < 128 lanes;
# PERF.md, PR 1): a warp then waits only for its own slowest lane.
BLOCK = 32


class WalkTables(NamedTuple):
    nodes: jnp.ndarray  # (n_nodes * NODE_W,) f32
    tris: jnp.ndarray  # (n_tris * TRI_W,) f32


def pack_tables(flat, v0, v1, v2, n, ent) -> WalkTables:
    """Host-side packing of a FlatBvh and its (already BVH-ordered)
    triangles into the kernel's row tables."""
    nodes = np.zeros((flat.n_nodes, NODE_W), np.float32)
    nodes[:, 0:3] = flat.node_min
    nodes[:, 3:6] = flat.node_max
    ints = nodes.view(np.int32)
    ints[:, 6] = flat.miss_link
    leaf = flat.prim_count > 0
    ints[:, 7] = np.where(
        leaf, (flat.prim_start.astype(np.int64) << 4) | flat.prim_count, -1
    ).astype(np.int32)
    tris = np.zeros((len(v0), TRI_W), np.float32)
    for k, a in enumerate((v0, v1, v2, n)):
        tris[:, 3 * k:3 * k + 3] = a
    tris.view(np.int32)[:, 12] = ent
    return WalkTables(jnp.asarray(nodes.ravel()), jnp.asarray(tris.ravel()))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _tri_test(o, d, v0, v1, v2, n):
    """geom/triangle.intersect on per-component lanes: (t, hit)."""
    cos_theta = _dot(n, d)
    denom = jnp.where(cos_theta == 0.0, 1.0, cos_theta)
    t = (_dot(n, v0) - _dot(n, o)) / denom
    valid = (cos_theta != 0.0) & (t >= 0.0) & jnp.isfinite(t)
    p = (o[0] + d[0] * t, o[1] + d[1] * t, o[2] + d[2] * t)
    area_abc = _dot(n, _cross(_sub(v1, v0), _sub(v2, v0)))
    area_pbc = _dot(n, _cross(_sub(v1, p), _sub(v2, p)))
    area_pca = _dot(n, _cross(_sub(v2, p), _sub(v0, p)))
    denom_a = jnp.where(area_abc == 0.0, 1.0, area_abc)
    bx = area_pbc / denom_a
    by = area_pca / denom_a
    bz = 1.0 - bx - by
    inside = (bx >= 0.0) & (by >= 0.0) & (bz >= 0.0) & (area_abc != 0.0)
    return t, valid & inside


def _walk_kernel(nodes_ref, tris_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref,
                 dz_ref, excl_ref, tlim_ref, eent_ref, *out_refs, any_hit):
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    inv = (1.0 / d[0], 1.0 / d[1], 1.0 / d[2])
    excl = excl_ref[...]
    t_lim = tlim_ref[...]
    excl_ent = eent_ref[...]

    def field(ref, row, width, k, mask, dtype=jnp.float32):
        v = plgpu.load(ref.at[row * width + k], mask=mask, other=0.0)
        return v if dtype == jnp.float32 else lax.bitcast_convert_type(v, dtype)

    def cond(carry):
        return jnp.max(carry[0]) >= 0

    def body(carry):
        cursor, t_best, i_best = carry
        live = cursor >= 0
        cur = jnp.maximum(cursor, 0)
        lo = [field(nodes_ref, cur, NODE_W, k, live) for k in range(3)]
        hi = [field(nodes_ref, cur, NODE_W, 3 + k, live) for k in range(3)]
        miss = field(nodes_ref, cur, NODE_W, 6, live, jnp.int32)
        code = field(nodes_ref, cur, NODE_W, 7, live, jnp.int32)
        tmin = tmax = None
        for k in range(3):
            t0 = (lo[k] - o[k]) * inv[k]
            t1 = (hi[k] - o[k]) * inv[k]
            a, b = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
            tmin = a if tmin is None else jnp.maximum(tmin, a)
            tmax = b if tmax is None else jnp.minimum(tmax, b)
        hit = live & (tmin < tmax) & (tmin < t_best) & (tmax > 0.0)
        leaf = code >= 0
        start = jnp.right_shift(code, 4)
        count = jnp.bitwise_and(code, 15)
        found = jnp.zeros_like(live)
        for k in range(LEAF_SIZE):
            pidx = start + k
            m = hit & leaf & (k < count)
            row = [field(tris_ref, pidx, TRI_W, c, m) for c in range(12)]
            t, h = _tri_test(o, d, row[0:3], row[3:6], row[6:9], row[9:12])
            ok = m & h & (t < t_best) & (pidx != excl)
            if any_hit:
                ent = field(tris_ref, pidx, TRI_W, 12, m, jnp.int32)
                found = found | (ok & (ent != excl_ent))
            else:
                t_best = jnp.where(ok, t, t_best)
                i_best = jnp.where(ok, pidx, i_best)
        nxt = jnp.where(hit & ~leaf, cur + 1, miss)
        if any_hit:
            i_best = jnp.where(found, 1, i_best)
            nxt = jnp.where(found, -1, nxt)
        return jnp.where(live, nxt, cursor), t_best, i_best

    zeros = jnp.zeros_like(excl)
    _, t_best, i_best = lax.while_loop(cond, body, (zeros, t_lim, zeros))
    if any_hit:
        out_refs[0][...] = i_best
    else:
        out_refs[0][...] = jnp.where(t_best < t_lim, t_best, BIG)
        out_refs[1][...] = i_best


@partial(jax.jit, static_argnames=("any_hit", "interpret", "block"))
def _walk(tables, o, d, excl, t_lim, excl_ent, *, any_hit, interpret, block):
    tables, o, d, t_lim = lax.stop_gradient((tables, o, d, t_lim))
    n = o.shape[0]
    pad = -n % block
    lanes = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]]
    # Padding lanes start outside any scene and miss the root.
    fills = [1e30, 1e30, 1e30, 1.0, 1.0, 1.0]
    lanes = [jnp.pad(x.astype(jnp.float32), (0, pad), constant_values=f)
             for x, f in zip(lanes, fills)]
    lanes += [jnp.pad(excl.astype(jnp.int32), (0, pad), constant_values=-1),
              jnp.pad(t_lim.astype(jnp.float32), (0, pad)),
              jnp.pad(excl_ent.astype(jnp.int32), (0, pad), constant_values=-1)]
    n_pad = n + pad
    lane_spec = pl.BlockSpec((block,), lambda i: (i,))
    table_spec = lambda a: pl.BlockSpec(a.shape, lambda i: (0,))
    out_shape = [jax.ShapeDtypeStruct((n_pad,), jnp.int32)]
    if not any_hit:
        out_shape.insert(0, jax.ShapeDtypeStruct((n_pad,), jnp.float32))
    outs = pl.pallas_call(
        partial(_walk_kernel, any_hit=any_hit),
        out_shape=out_shape,
        grid=(n_pad // block,),
        in_specs=[table_spec(tables.nodes), table_spec(tables.tris)]
        + [lane_spec] * 9,
        out_specs=[lane_spec] * len(out_shape),
        compiler_params=plgpu.CompilerParams(num_warps=max(1, block // 32)),
        backend="triton",
        interpret=interpret,
        name="bvh_walk_anyhit" if any_hit else "bvh_walk_closest",
    )(tables.nodes, tables.tris, *lanes)
    return [x[:n] for x in outs]


def closest_hit(tables, o, d, excl, t_init, *, interpret=False, block=BLOCK):
    """Closest triangle hit closer than ``t_init``: (t, idx), t = BIG where
    none.  o, d: (N, 3); excl: (N,) triangle index to skip (-1 for none)."""
    t, idx = _walk(tables, o, d, excl, t_init, jnp.full(excl.shape, -1),
                   any_hit=False, interpret=interpret, block=block)
    return t, idx


def occluded(tables, o, d, excl, excl_ent, t_max, *, interpret=False,
             block=BLOCK):
    """Any-hit: True where some triangle other than ``excl`` and not of
    entity ``excl_ent`` is hit at t < t_max.  A lane stops at its first
    such hit."""
    (occ,) = _walk(tables, o, d, excl, t_max, excl_ent,
                   any_hit=True, interpret=interpret, block=block)
    return occ > 0
