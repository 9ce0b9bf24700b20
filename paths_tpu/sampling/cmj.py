"""Correlated Multi-Jittered sampling (Kensler / Pixar), vectorised.

Reference: src/sampling.rs:166-265.  The reference ports the hash from the
CMJ paper but its ``permute`` guards the scramble loop with ``while i > l``
(sampling.rs:194) -- and every call site passes ``i < l``, so the scramble
body is dead code and ``permute`` reduces to ``(i + p) % l``.  We reproduce
that reduced behaviour bit-exactly (the jitter hash ``rand_float`` is still
the full Pixar hash), because image parity with the reference is a goal.

Everything is a pure function of (sample index s, pattern dims m x n,
pattern seed p): stateless, vectorised over s and p, and therefore identical
under any device sharding -- this is the wavefront replacement for the
reference's per-worker stateful iterators (sampling.rs:238-265).
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def permute(i: jnp.ndarray, l, p: jnp.ndarray) -> jnp.ndarray:
    """sampling.rs:187-210 with i < l: the while loop never runs, leaving
    ``(i + p) % l``.  (Call sites always satisfy i < l.)"""
    i = i.astype(_U32)
    p = p.astype(_U32)
    l = jnp.asarray(l, _U32)
    return (i + p) % l


def rand_float(i: jnp.ndarray, p: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """Pixar jitter hash, sampling.rs:212-221.  u32-exact; the final scale is
    i * (1/4294967808)."""
    i = i.astype(_U32)
    p = p.astype(_U32)
    i = i ^ p
    i = i ^ (i >> 17)
    i = i ^ (i >> 10)
    i = i * _U32(0xB36534E5)
    i = i ^ (i >> 12)
    i = i ^ (i >> 21)
    i = i * _U32(0x93FC4795)
    i = i ^ _U32(0xDF6E307F)
    i = i ^ (i >> 17)
    i = i * (_U32(1) | (p >> 18))
    return i.astype(dtype) * dtype(1.0 / 4294967808.0)


def cmj(s: jnp.ndarray, m: int, n: int, p: jnp.ndarray, dtype=jnp.float32):
    """The CMJ pattern point for sample s of an m x n pattern with seed p
    (sampling.rs:226-235).  Returns (x, y) in [0,1)^2."""
    s = jnp.asarray(s, _U32)
    p = jnp.asarray(p, _U32)
    mn = _U32(m) * _U32(n)
    ps = permute(s, mn, p * _U32(0xA73BD290))
    sx = permute(ps % _U32(m), m, p * _U32(0xA511E9B3)).astype(dtype)
    sy = permute(ps // _U32(m), n, p * _U32(0x63D83595)).astype(dtype)
    jx = rand_float(s, p * _U32(0xA399D265), dtype)
    jy = rand_float(s, p * _U32(0x711AD6A5), dtype)
    x = ((s % _U32(m)).astype(dtype) + (sy + jx) / dtype(n)) / dtype(m)
    y = ((s // _U32(m)).astype(dtype) + (sx + jy) / dtype(m)) / dtype(n)
    return x, y


def cmj_square(s, m, n, p, dtype=jnp.float32):
    """Square-domain pattern (sampling.rs:238-248)."""
    return cmj(s, m, n, p, dtype)


def cmj_disk(s, m, n, p, dtype=jnp.float32):
    """Disk-domain pattern: square sample polar-mapped to the unit disk
    (sampling.rs:250-265): theta = 2 pi x, r = sqrt(y)."""
    x, y = cmj(s, m, n, p, dtype)
    theta = dtype(2.0 * 3.141592653589793) * x
    r = jnp.sqrt(y)
    return r * jnp.cos(theta), r * jnp.sin(theta)
