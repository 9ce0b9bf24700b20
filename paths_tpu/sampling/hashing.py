"""Counter-based per-lane RNG for shading decisions.

The reference draws all shading randomness (light pick, BSDF lobe choice,
hemisphere samples, Russian roulette) from ``rand::thread_rng`` (trace.rs:106,
material.rs:310, geom.rs:11-13): fast but stateful and unreproducible.

Replacement here: every uniform is a pure hash of
(seed, pixel_id, sample_id, bounce, dimension).  This makes renders
deterministic, independent of device layout or wavefront batching, and --
crucially for the differentiability gates -- lets finite-difference gradient
checks use common random numbers so FD and autodiff see the same paths.

The mixer is murmur3's 32-bit finalizer chained over the key words; ~10 VPU
ops per uniform.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32

# Dimension slots per bounce (keep in sync with integrator.py).
DIM_LIGHT_PICK = 0
DIM_LIGHT_U = 1
DIM_LIGHT_V = 2
DIM_LOBE = 3
DIM_BSDF_U = 4
DIM_BSDF_V = 5
DIM_RR = 6
DIM_ENV_CDF = 7
DIM_ENV_JX = 8
DIM_ENV_JY = 9
DIMS_PER_BOUNCE = 10


def _fmix32(h: jnp.ndarray) -> jnp.ndarray:
    h = h ^ (h >> 16)
    h = h * _U32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * _U32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash_u32(*keys) -> jnp.ndarray:
    """Mix an arbitrary number of u32 keys (scalars or arrays) into one u32."""
    h = _U32(0x9E3779B9)
    for k in keys:
        k = jnp.asarray(k).astype(_U32)
        h = _fmix32((h ^ k) * _U32(0x85EBCA6B) + _U32(0xE6546B64))
    return h


def uniform(*keys, dtype=jnp.float32) -> jnp.ndarray:
    """U[0,1) from hashed keys.  Uses the top 24 bits so the value is exact
    in f32."""
    bits = hash_u32(*keys)
    return (bits >> 8).astype(dtype) * dtype(1.0 / 16777216.0)


def shading_uniform(seed, lane_key, bounce, dim, dtype=jnp.float32):
    """The canonical shading-decision uniform: a pure function of the path
    identity (lane_key = pixel*S + sample), bounce index and dimension slot."""
    ctr = jnp.asarray(bounce).astype(_U32) * _U32(DIMS_PER_BOUNCE) + _U32(dim)
    return uniform(seed, lane_key, ctr, dtype=dtype)
