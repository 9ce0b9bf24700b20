"""The platform decision (paths_tpu/platform.py) and what build_scene and the
integrator do with it, including the kernel wiring run in interpret mode."""

import dataclasses
import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from paths_tpu import platform
from paths_tpu.ops import bvh_walk
from paths_tpu.render import render_wave
from paths_tpu.scene.build import build_scene
from paths_tpu.scene.stress import generate_mixed_scene


@pytest.mark.parametrize("backend, want", [("cpu", "xla"), ("gpu", "kernel")])
def test_backend_picks_traversal(monkeypatch, backend, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert platform.traversal_backend() == want


def test_other_backend_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="rocm"):
        platform.traversal_backend()


@pytest.fixture(scope="module")
def mixed_builds(tmp_path_factory):
    sd = generate_mixed_scene(str(tmp_path_factory.mktemp("mixed")))
    xla = build_scene(sd)
    mp = pytest.MonkeyPatch()
    mp.setattr(platform, "traversal_backend", lambda: "kernel")
    try:
        kernel = build_scene(sd)
    finally:
        mp.undo()
    return xla, kernel


def test_build_scene_selects_walk(mixed_builds):
    (st_x, sc_x, _), (st_k, sc_k, _) = mixed_builds
    # 128 triangles: brute force on the CPU, the walk kernel on the GPU.
    assert not st_x.use_bvh and not st_x.bvh_kernel and sc_x.walk is None
    assert st_k.use_bvh and st_k.bvh_kernel
    assert sc_k.walk.nodes.size % bvh_walk.NODE_W == 0
    assert sc_k.walk.tris.size == st_k.n_tris * bvh_walk.TRI_W


def test_kernel_integrator_matches_xla(mixed_builds, monkeypatch):
    """The integrator's kernel branches (closest hit and any-hit shadow
    rays), run in interpret mode, render what the XLA path renders."""
    (st_x, sc_x, cam), (st_k, sc_k, _) = mixed_builds
    monkeypatch.setattr(bvh_walk, "closest_hit",
                        partial(bvh_walk.closest_hit, interpret=True))
    monkeypatch.setattr(bvh_walk, "occluded",
                        partial(bvh_walk.occluded, interpret=True))
    W = H = 16
    pix = np.arange(W * H, dtype=np.uint32)
    args = (jnp.asarray((pix % W).astype(np.int32)),
            jnp.asarray((pix // W).astype(np.int32)), jnp.asarray(pix),
            jnp.zeros(W * H, jnp.uint32), 7)
    out = [np.asarray(render_wave(dataclasses.replace(st, max_bounces=3),
                                  sc, cam, *args))
           for st, sc in ((st_x, sc_x), (st_k, sc_k))]
    assert np.isfinite(out[1]).all()
    # Same paths, same physics; f32 order of ops differs on grazing hits.
    close = np.isclose(out[1], out[0], rtol=1e-3, atol=1e-3)
    assert close.mean() > 0.995, close.mean()


def test_compile_cache_env_wins(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    platform.enable_compile_cache()
    assert calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    platform.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert ("jax_compilation_cache_dir", os.path.join(repo, ".jax_cache")) in calls
