"""Triangle traversal against brute force.

Both walks of the skip-link BVH -- the plain XLA walk (bvh/traverse.py, the
CPU path and the reference) and the GPU walk kernel (ops/bvh_walk.py, here
in Pallas interpret mode) -- are checked lane by lane against the
brute-force bounds of bvh/check.py, for closest hits and any-hit queries,
over rays chosen to break careless walks.
"""

import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from paths_tpu.bvh import check
from paths_tpu.bvh.build import build_bvh
from paths_tpu.bvh.traverse import closest_hit_bvh
from paths_tpu.ops import bvh_walk
from paths_tpu.scene.obj_loader import load_obj_file
from paths_tpu.scene.types import BvhArrays

GRID_OBJ = os.path.join(os.path.dirname(__file__), "goldens", "assets", "grid.obj")
N = 256
N_ENT = 3


def _soup(T, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-3, 3, (T, 3))
    return v0, v0 + rng.uniform(-1, 1, (T, 3)), v0 + rng.uniform(-1, 1, (T, 3))


def _grid():
    (m,) = load_obj_file(GRID_OBJ)
    f = np.asarray(m.faces)
    v = np.asarray(m.vertices)
    return v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]


def _mesh(v0, v1, v2):
    """BVH-ordered triangles, both walks' tables, and the oracle's arrays."""
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    flat = build_bvh(np.minimum(np.minimum(v0, v1), v2),
                     np.maximum(np.maximum(v0, v1), v2))
    v0, v1, v2, n = (a[flat.order] for a in (v0, v1, v2, n))
    ent = np.arange(len(v0)) % N_ENT
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    scene = SimpleNamespace(
        bvh=BvhArrays(*(jnp.asarray(getattr(flat, k)) for k in (
            "node_min", "node_max", "hit_link", "miss_link", "prim_start",
            "prim_count"))),
        tri_v0=f32(v0), tri_v1=f32(v1), tri_v2=f32(v2), tri_n=f32(n),
        tri_ent=jnp.asarray(ent, jnp.int32),
    )
    tables = bvh_walk.pack_tables(flat, v0, v1, v2, n, ent)
    return scene, tables


def _rays(rng, n, tris, spread=6.0):
    """Origins around the mesh aimed at points inside random triangles."""
    o = rng.uniform(-spread, spread, (n, 3))
    k = rng.integers(0, len(tris[0]), n)
    w = rng.dirichlet(np.ones(3), n)
    tgt = sum(w[:, j:j + 1] * tris[j][k] for j in range(3))
    d = tgt - o
    d[: n // 4] = rng.normal(size=(n // 4, 3))  # some rays aim anywhere
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _case(scenario, query):
    """(scene, tables, o, d, excl, limit, excl_ent) for one scenario."""
    rng = np.random.default_rng(2 * SCENARIOS.index(scenario) + (query == "anyhit"))
    n = N
    tris = {"grid": _grid, "leaf8": lambda: _soup(8, 1),
            "leaf9": lambda: _soup(9, 2)}.get(scenario, lambda: _soup(200))()
    scene, tables = _mesh(*tris)
    if scenario == "ragged":
        n = 200  # not a multiple of the kernel block
    if scenario == "grid":
        o = np.stack([rng.uniform(-2.5, 2.5, n), np.full(n, 2.0),
                      rng.uniform(-2.5, 2.5, n)], -1)
        d = np.stack([rng.normal(0, 0.2, n), -np.ones(n), rng.normal(0, 0.2, n)], -1)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    else:
        o, d = _rays(rng, n, tris)
    excl = np.full(n, -1, np.int32)
    excl_ent = np.full(n, -1, np.int32)
    limit = np.full(n, check.BIG, np.float32)
    if query == "anyhit":
        limit = rng.uniform(1.0, 10.0, n).astype(np.float32)
    T = len(tris[0])
    if scenario in ("dead", "overflow", "axis"):
        o, d, _ = check.salt(rng, o, d, T, frac=0.2)
    if scenario == "excl":
        # Exclude each lane's own first hit (as a bounce ray leaving it
        # does), a random triangle, or an entity.
        t0, i0 = closest_hit_bvh(scene, jnp.asarray(o, jnp.float32),
                                 jnp.asarray(d, jnp.float32),
                                 jnp.zeros(n, jnp.int32), jnp.asarray(excl),
                                 jnp.full(n, check.BIG))
        own = np.asarray(t0) < check.BIG
        excl = np.where(own, np.asarray(i0), -1).astype(np.int32)
        excl[n // 2:] = rng.integers(0, T, n - n // 2)
        excl_ent[::3] = rng.integers(0, N_ENT, len(excl_ent[::3]))
    if scenario == "t_init":
        limit = rng.uniform(0.5, 8.0, n).astype(np.float32)
    return scene, tables, o, d, excl, limit, excl_ent


SCENARIOS = ["soup", "grid", "dead", "overflow", "axis", "excl", "t_init",
             "ragged", "leaf8", "leaf9"]


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("query", ["closest", "anyhit"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_walk_matches_bruteforce(scenario, query, impl):
    scene, tables, o, d, excl, limit, excl_ent = _case(scenario, query)
    tris = (scene.tri_v0, scene.tri_v1, scene.tri_v2, scene.tri_n, scene.tri_ent)
    oj, dj = jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
    ej, lj, eej = jnp.asarray(excl), jnp.asarray(limit), jnp.asarray(excl_ent)
    kind = jnp.where(ej >= 0, 2, 0)
    if query == "closest" or impl == "xla":
        # The XLA path answers occlusion from the closest hit below t_max.
        if impl == "kernel":
            t, idx = bvh_walk.closest_hit(tables, oj, dj, ej, lj, interpret=True)
        else:
            t, idx = check._reference_walk(
                scene.bvh, *tris[:4], oj, dj, kind, ej, lj)
        ok = check.closest_ok(tris, oj, dj, ej, lj, t, idx)
        hits = np.asarray(t) < check.BIG
    else:
        occ = bvh_walk.occluded(tables, oj, dj, ej, eej, lj, interpret=True)
        ok = check.anyhit_ok(tris, oj, dj, ej, eej, lj, occ)
        hits = np.asarray(occ)
    assert ok.all(), f"{(~ok).sum()} wrong lanes: {np.nonzero(~ok)[0][:10]}"
    assert hits.sum() >= 5, "the case must exercise hits"
    dead = np.abs(o).max(axis=1) >= check.DEAD
    assert not hits[dead].any()
    if scenario == "t_init" and query == "closest":
        assert (np.asarray(t)[hits] < limit[hits]).all()


def test_walk_parity_report_on_salted_wave():
    """The report chip_smoke.py prints for the card, here in interpret mode:
    kernel and plain walk agree and both pass the brute-force bounds."""
    scene, tables = _mesh(*_grid())
    rng = np.random.default_rng(3)
    o = np.stack([rng.uniform(-2.5, 2.5, 512), np.full(512, 2.0),
                  rng.uniform(-2.5, 2.5, 512)], -1)
    d = np.stack([rng.normal(0, 0.3, 512), -np.ones(512),
                  rng.normal(0, 0.3, 512)], -1)
    o, d, excl = check.salt(rng, o, d / np.linalg.norm(d, axis=1, keepdims=True),
                            int(scene.tri_v0.shape[0]))
    t_max = rng.uniform(0.5, 3.0, 512).astype(np.float32)
    excl_ent = np.where(rng.uniform(size=512) < 0.2, 1, -1).astype(np.int32)
    rep = check.walk_parity(tables, scene, o, d, excl, t_max, excl_ent,
                            n_brute=256, interpret=True)
    assert rep["closest_bad"] == rep["reference_bad"] == rep["anyhit_bad"] == 0, rep
    assert rep["hits"] > 100 and rep["occluded"] > 10, rep
    assert rep["t_rel_max"] <= 1e-5, rep


@pytest.mark.gpu
def test_walk_kernel_compiled_on_gpu():
    """The same report with the kernel compiled for the card (chip_smoke.py
    runs this check at the dragon's full wave)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
    tris = _soup(5000)
    scene, tables = _mesh(*tris)
    rng = np.random.default_rng(4)
    o, d = _rays(rng, 65536, tris)
    o, d, excl = check.salt(rng, o, d, 5000)
    t_max = rng.uniform(0.5, 8.0, len(o)).astype(np.float32)
    rep = check.walk_parity(tables, scene, o, d, excl, t_max,
                            np.full(len(o), -1, np.int32))
    assert rep["closest_bad"] == rep["reference_bad"] == rep["anyhit_bad"] == 0, rep
