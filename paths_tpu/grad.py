"""Differentiable rendering: pixel gradients to scene parameters.

This is the capability the reference does not have (SURVEY.md: autodiff is a
new capability).  The full radiance estimate in
paths_tpu.integrator is a pure function of the SceneArrays pytree, so
gradients w.r.t. the *continuous* scene parameters -- material albedos /
reflectance / metalness / roughness / emission, light colour & intensity,
sky colours & HDRI texels, per-vertex colours -- flow through ``jax.grad``
directly.

Estimator notes:
  - randomness is counter-based and independent of parameters, so autodiff
    computes the pathwise (reparameterised, fixed-decisions) derivative;
    finite differences with common random numbers (same seed) measure the
    same quantity, making FD checks tight rather than statistical;
  - discrete path decisions (gloss lobe choice, RR, light pick) depend on
    parameters only through measure-zero branch boundaries, so the pathwise
    derivative is unbiased for the continuous parameter set above;
  - geometry derivatives (sphere centers/radii, vertices) also flow through
    the explicit intersection formulas, but visibility discontinuities are
    NOT handled (no edge sampling) -- documented limitation.

Cut for geometry derivatives: the BVH walks (bvh/traverse.py and the GPU
kernel ops/bvh_walk.py) ``stop_gradient`` their ray and table inputs --
traversal is a discrete selector whose outputs (t, prim id) carry no
gradients -- so on a walked mesh geometry derivatives through hit-t
vanish, while the brute-force intersectors propagate them.  The supported
PARAM_FIELDS below are unaffected: they enter only through shading, which
is recomputed differentiably from SceneArrays at the returned hit
(tests/test_grad.py test_grads_through_bvh_walk_match_scan).
Differentiating geometry through a walked mesh needs a reparameterised VJP
at the returned index (SURVEY.md section 7).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from paths_tpu.render import render_wave
from paths_tpu.scene.types import SceneArrays

# SceneArrays fields exposed as differentiable parameters.
PARAM_FIELDS = (
    "mat_albedo",
    "mat_emit",
    "mat_r0",
    "mat_metalness",
    "mat_roughness",
    "light_colour",
    "light_intensity",
    "ent_light_emission",
    "tri_vc0",
    "tri_vc1",
    "tri_vc2",
)
SKY_PARAM_FIELDS = ("colour_a", "colour_b", "image")


def get_params(scene: SceneArrays) -> dict:
    """Extract the differentiable parameter pytree."""
    p = {f: getattr(scene, f) for f in PARAM_FIELDS}
    p["sky"] = {f: getattr(scene.sky, f) for f in SKY_PARAM_FIELDS}
    return p


def with_params(scene: SceneArrays, params: dict) -> SceneArrays:
    """Rebuild SceneArrays with the parameter pytree substituted."""
    kw = {f: params[f] for f in PARAM_FIELDS}
    kw["sky"] = scene.sky._replace(**params["sky"])
    return scene._replace(**kw)


def render_with_params(static, scene, params, cam, px, py, pixel_id, sample_id, seed):
    return render_wave(
        static, with_params(scene, params), cam, px, py, pixel_id, sample_id, seed
    )


def l2_loss(static, params, scene, cam, px, py, pixel_id, sample_id, seed, target):
    """Mean squared error between a rendered wave and target radiance."""
    col = render_with_params(static, scene, params, cam, px, py, pixel_id, sample_id, seed)
    return jnp.mean((col - target) ** 2)


def loss_and_grad(static, scene, cam, px, py, pixel_id, sample_id, seed, target):
    """(loss, grads-w.r.t.-params) for one sample wave.  jit-able via
    partial(static)."""
    params = get_params(scene)
    fn = partial(l2_loss, static)
    return jax.value_and_grad(fn)(
        params, scene, cam, px, py, pixel_id, sample_id, seed, target
    )


def pixel_gradient(static, scene, cam, px, py, pixel_id, sample_id, seed, param_field):
    """d(mean pixel luminance)/d(param_field): convenience probe used by the
    FD gradient tests."""
    params = get_params(scene)

    def f(params):
        col = render_with_params(
            static, scene, params, cam, px, py, pixel_id, sample_id, seed
        )
        return jnp.mean(col)

    g = jax.grad(f)(params)
    return g[param_field] if param_field in g else g["sky"][param_field]
