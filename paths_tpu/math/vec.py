"""Vector math over (..., 3) arrays.

The analogue of the reference's scalar ``Vector3``
(reference: src/vector.rs:4-81).  Everything here is shape-polymorphic and
vectorises over arbitrary leading batch dimensions so a "vector" is a lane of
a wavefront, not a struct.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis (vector.rs:23-25)."""
    return jnp.sum(a * b, axis=-1)


def dot_keep(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Cross product (vector.rs:43-49)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def norm_sq(a: jnp.ndarray) -> jnp.ndarray:
    """Squared length.  NB the reference calls this ``magnitude()``
    (vector.rs:27-29) -- it is the *squared* magnitude there too."""
    return dot(a, a)


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(norm_sq(a))


def normalize(a: jnp.ndarray) -> jnp.ndarray:
    """Unit vector (vector.rs:39-41).  0-vectors produce inf/nan exactly like
    the reference; callers guard explicitly."""
    return a / jnp.sqrt(norm_sq(a))[..., None]


def normalize_safe(a: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    return a / jnp.sqrt(jnp.maximum(norm_sq(a), eps))[..., None]


def invert(a: jnp.ndarray) -> jnp.ndarray:
    """Componentwise reciprocal, used for AABB slab tests (vector.rs:63-65)."""
    return 1.0 / a


def max_component(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.max(a, axis=-1)


def min_component(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.min(a, axis=-1)


def form_basis(n: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Orthonormal frame (i, j, k) with j == n (vector.rs:51-61).

    Matches the reference exactly: i = normalize(n x +Y) unless |n.x| == 0, in
    which case i = +X; then k = i x j.  (The |n.x| == 0 test means normals in
    the YZ plane -- including n == +/-Y -- take the axis-aligned branch.)
    """
    j = n
    up = jnp.zeros_like(n).at[..., 1].set(1.0)
    generic = cross(j, up)
    # Degenerate when n.x == 0 *exactly* (reference tests j.x.abs() == 0.0).
    degenerate = jnp.abs(n[..., 0]) == 0.0
    x_axis = jnp.zeros_like(n).at[..., 0].set(1.0)
    i = jnp.where(degenerate[..., None], x_axis, normalize_safe(generic))
    k = cross(i, j)
    return i, j, k


def switch_basis(
    v: jnp.ndarray, i: jnp.ndarray, j: jnp.ndarray, k: jnp.ndarray
) -> jnp.ndarray:
    """Express local vector v in the world frame (geom.rs:26-28)."""
    return (
        i * v[..., 0:1] + j * v[..., 1:2] + k * v[..., 2:3]
    )


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of *outgoing* vector v about normal n, normalised
    (material.rs:246-248: ``(n * 2(n.v) - v).normed()``)."""
    return normalize_safe(n * (2.0 * dot_keep(n, v)) - v)
