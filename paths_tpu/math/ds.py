"""Double-single (two-float) arithmetic.

The reference renderer does all geometry in f64 (vector.rs:4-8).  GPU f64
throughput is a small fraction of f32, but the bundled scenes model
ground planes as spheres of radius 1e6 (scenes/spheres_on_plane.yml), where a
plain f32 quadratic solve loses ~5 decimal digits to cancellation and produces
visible banding/acne.  Instead of paying for f64 everywhere we carry the few
critical scalars of the sphere intersection as unevaluated (hi, lo) f32 pairs
("double-single"), giving ~48 effective mantissa bits at a handful of extra
VPU flops.

Classic error-free transforms (Dekker 1971, Knuth TAOCP vol.2).  No fma is
assumed (XLA does not guarantee one), so products are split Dekker-style.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# A double-single number is a tuple (hi, lo) with |lo| <= ulp(hi)/2 and the
# represented value hi + lo.

_SPLITTER = np.float32(4097.0)  # 2^12+1 Dekker split; numpy (import-time device constants are slow)


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split: a = hi + lo with hi, lo each having <=12 mantissa bits."""
    t = _SPLITTER * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (no fma required)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ds(hi, lo=None):
    hi = jnp.asarray(hi, jnp.float32)
    if lo is None:
        lo = jnp.zeros_like(hi)
    return hi, lo


def add(x, y):
    """(hi,lo) + (hi,lo)."""
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return fast_two_sum(s, e)


def sub(x, y):
    return add(x, (-y[0], -y[1]))


def mul(x, y):
    p, e = two_prod(x[0], y[0])
    e = e + x[0] * y[1] + x[1] * y[0]
    return fast_two_sum(p, e)


def sqr(x):
    return mul(x, x)


def neg(x):
    return (-x[0], -x[1])


def to_f32(x):
    return x[0] + x[1]


def sqrt(x):
    """Double-single sqrt via one Newton step on the f32 estimate."""
    hi, lo = x
    s = jnp.sqrt(hi)
    # residual r = x - s*s computed error-free
    p, e = two_prod(s, s)
    r = (hi - p) - e + lo
    safe_s = jnp.where(s > 0, s, 1.0)
    corr = r / (2.0 * safe_s)
    corr = jnp.where(s > 0, corr, 0.0)
    return fast_two_sum(s, corr)


def dot3(ax, ay, az, bx, by, bz):
    """Double-single dot product of two f32 3-vectors (components given as
    separate arrays).  Inputs are plain f32; the accumulation is exact."""
    px, ex = two_prod(ax, bx)
    py, ey = two_prod(ay, by)
    pz, ez = two_prod(az, bz)
    s, e = two_sum(px, py)
    s, e2 = two_sum(s, pz)
    e = e + e2 + ex + ey + ez
    return fast_two_sum(s, e)
