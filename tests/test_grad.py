"""Differentiability gates: autodiff pixel
gradients must match central finite differences computed with common random
numbers -- same seed means FD and autodiff follow identical paths, so the
comparison is tight, not statistical."""

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from paths_tpu import camera as C
from paths_tpu import grad as G
from paths_tpu.scene import desc as D
from paths_tpu.scene.build import build_scene
from paths_tpu.scene.stress import generate_stress_scene


def _wave_args(cam, n=256, W=16):
    H = max(1, n // W)
    cam = C.resize(cam, W, H)
    pix = np.arange(n, dtype=np.uint32)
    px = jnp.asarray((pix % W).astype(np.int32))
    py = jnp.asarray((pix // W % H).astype(np.int32))
    pid = jnp.asarray(pix)
    sid = jnp.zeros(n, jnp.uint32)
    return cam, px, py, pid, sid


def _mean_lum(static, scene, params, cam, px, py, pid, sid):
    col = G.render_with_params(static, scene, params, cam, px, py, pid, sid, 0)
    return jnp.mean(col)


def _fd_check(static, scene, cam, field, index, rel_tol, eps=2e-3, sky=False):
    cam, px, py, pid, sid = _wave_args(cam)
    params = G.get_params(scene)
    f = jax.jit(partial(_mean_lum, static, scene))

    grad_fn = jax.jit(jax.grad(partial(_mean_lum, static, scene)))
    g = grad_fn(params, cam, px, py, pid, sid)
    g_val = float((g["sky"][field] if sky else g[field])[index])

    def with_delta(d):
        p = {k: (v.copy() if hasattr(v, "copy") else v) for k, v in params.items()}
        if sky:
            p["sky"] = dict(p["sky"])
            p["sky"][field] = p["sky"][field].at[index].add(d)
        else:
            p[field] = p[field].at[index].add(d)
        return float(f(p, cam, px, py, pid, sid))

    fd = (with_delta(eps) - with_delta(-eps)) / (2 * eps)
    assert np.isfinite(g_val)
    np.testing.assert_allclose(g_val, fd, rtol=rel_tol, atol=1e-5)
    return g_val


@pytest.fixture(scope="module")
def stress8():
    sd = generate_stress_scene(8, seed=2)
    static, scene, cam = build_scene(sd)
    return dataclasses.replace(static, max_bounces=3), scene, cam


@pytest.fixture(scope="module")
def lit_sphere():
    sd = D.SceneDescription()
    sd.skybox = D.SkyboxD(kind="gradient",
                          overhead_colour=D.ColourD(0.2, 0.3, 0.5),
                          horizon_colour=D.ColourD(0.8, 0.7, 0.6))
    mat = D.MaterialD(kind="lambertian")
    mat.albedo = D.MaterialColourD(colour=D.ColourD(0.5, 0.4, 0.3))
    sd.objects = [D.ObjectD(shape_kind="sphere",
                            sphere=D.SphereD(D.Vec3D(0, 0, 3), 1.0),
                            material=mat)]
    sd.lights = [D.LightD(kind="sphere", position=D.Vec3D(3, 3, 0), radius=0.5,
                          colour=D.ColourD(1.0, 0.9, 0.8), intensity=2.0)]
    static, scene, cam = build_scene(sd)
    return dataclasses.replace(static, max_bounces=3), scene, cam


def test_fd_albedo(lit_sphere):
    static, scene, cam = lit_sphere
    g = _fd_check(static, scene, cam, "mat_albedo", (0, 0), rel_tol=5e-3)
    assert g > 0  # brighter albedo -> brighter pixel


def test_fd_light_intensity(lit_sphere):
    static, scene, cam = lit_sphere
    g = _fd_check(static, scene, cam, "light_intensity", (0,), rel_tol=5e-3)
    assert g > 0


def test_fd_light_colour(lit_sphere):
    static, scene, cam = lit_sphere
    _fd_check(static, scene, cam, "light_colour", (0, 1), rel_tol=5e-3)


def test_fd_sky_colour(lit_sphere):
    static, scene, cam = lit_sphere
    g = _fd_check(static, scene, cam, "colour_a", (2,), rel_tol=5e-3, sky=True)
    assert g > 0


def test_fd_stress_scene_albedo(stress8):
    """Gradients through the multi-material stress scene (gloss + mirror +
    lambertian mix, RR active)."""
    static, scene, cam = stress8
    for e in range(3):
        _fd_check(static, scene, cam, "mat_albedo", (e, 0), rel_tol=2e-2)


def test_inverse_rendering_recovers_albedo(lit_sphere):
    """End-to-end gate: gradient descent on the l2 loss recovers a perturbed
    albedo (the inverse-rendering loop the sharded train step runs)."""
    static, scene, cam = lit_sphere
    cam, px, py, pid, sid = _wave_args(cam, n=512)

    target_params = G.get_params(scene)
    render = jax.jit(partial(G.render_with_params, static, scene))
    target = render(target_params, cam, px, py, pid, sid, 0)

    params = jax.tree.map(lambda x: x, target_params)
    params["mat_albedo"] = params["mat_albedo"].at[0].set(
        jnp.asarray([0.9, 0.1, 0.9]))

    loss_fn = jax.jit(
        lambda p: jnp.mean((render(p, cam, px, py, pid, sid, 0) - target) ** 2))
    grad_fn = jax.jit(jax.grad(
        lambda p: jnp.mean((render(p, cam, px, py, pid, sid, 0) - target) ** 2)))

    losses = [float(loss_fn(params))]
    for _ in range(40):
        g = grad_fn(params)
        params["mat_albedo"] = params["mat_albedo"] - 2.0 * g["mat_albedo"]
        losses.append(float(loss_fn(params)))

    assert losses[-1] < losses[0] * 1e-2
    np.testing.assert_allclose(
        np.asarray(params["mat_albedo"][0]),
        np.asarray(target_params["mat_albedo"][0]),
        atol=0.05,
    )


def test_grads_through_bvh_walk_match_scan(tmp_path):
    """loss_and_grad through a mesh that takes the BVH walk (bvh_threshold
    lowered so the walk engages) must match the brute-force scan build for
    EVERY supported PARAM_FIELD, with glossy bounces whose directions depend
    on differentiable parameters.

    The walk stop_gradients its inputs (reverse mode cannot pass its
    while_loop), but PARAM_FIELDS enter only through shading, recomputed at
    the returned hit -- so parameter grads agree up to f32 order of ops."""
    from paths_tpu.scene.stress import generate_mixed_scene

    sd = generate_mixed_scene(str(tmp_path))
    st_w, sc_w, cam = build_scene(sd, bvh_threshold=64)
    st_s, sc_s, _ = build_scene(sd)
    assert st_w.use_bvh and not st_w.bvh_kernel and not st_s.use_bvh
    st_w = dataclasses.replace(st_w, max_bounces=3)
    st_s = dataclasses.replace(st_s, max_bounces=3)

    cam, px, py, pid, sid = _wave_args(cam)
    target = jnp.zeros((px.shape[0], 3))
    loss_w, g_w = jax.jit(partial(G.loss_and_grad, st_w))(
        sc_w, cam, px, py, pid, sid, 0, target)
    loss_s, g_s = jax.jit(partial(G.loss_and_grad, st_s))(
        sc_s, cam, px, py, pid, sid, 0, target)
    np.testing.assert_allclose(float(loss_w), float(loss_s), rtol=1e-4)

    # The walked build BVH-orders its triangles, so tri_vc* (per-triangle)
    # compare as permutation-invariant sums; every other field is per
    # entity or per light.
    for field in G.PARAM_FIELDS:
        a, b = np.asarray(g_w[field]), np.asarray(g_s[field])
        assert np.isfinite(a).all(), field
        if field.startswith("tri_vc"):
            a, b = a.sum(axis=0), b.sum(axis=0)
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-5,
                                   err_msg=f"grad mismatch for {field}")
    for field in G.SKY_PARAM_FIELDS:
        np.testing.assert_allclose(
            np.asarray(g_w["sky"][field]), np.asarray(g_s["sky"][field]),
            rtol=2e-3, atol=1e-5, err_msg=f"sky grad mismatch for {field}",
        )
