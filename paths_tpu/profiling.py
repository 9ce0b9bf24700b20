"""Profiling and timing utilities.

The reference's observability is wall-clock prints: per-second elapsed/FPS/
ray-count lines (main.rs:107-112) and BVH build phase timers (bvh.rs:161-203).
Equivalents here (SURVEY.md section 5):

  - ``trace(logdir)``: jax.profiler device traces for xprof/tensorboard;
  - ``time_jitted``: median wall-clock of a jitted function, each call
    waited for by reducing its output to a scalar and fetching it;
  - ``RayCounter``: rays/s accounting with the reference's counting unit
    (one ray == one pixel-sample delivered, renderer.rs:101).
"""

from __future__ import annotations

import contextlib
import statistics
import time

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace viewable in xprof/tensorboard."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_jitted(fn, *args, reps: int = 5, warmup: int = 1, **kwargs) -> float:
    """Median seconds per call of ``fn(*args)``, value-synced.

    ``fn``'s output is reduced to one scalar on device and fetched, so the
    measurement includes the full computation; warmup calls (compilation)
    are not timed."""

    def scalarize(out):
        leaves = jax.tree.leaves(out)
        return sum(jnp.sum(l) for l in leaves if hasattr(l, "dtype"))

    for _ in range(max(warmup, 1)):
        float(scalarize(fn(*args, **kwargs)))
    times = []
    for _ in range(reps):
        t0 = time.time()
        float(scalarize(fn(*args, **kwargs)))
        times.append(time.time() - t0)
    return statistics.median(times)


class RayCounter:
    """Rays/s over a sliding window, printed like main.rs:107-112."""

    def __init__(self):
        self.t0 = time.monotonic()
        self.total = 0
        self._last_print = self.t0
        self._last_total = 0

    def add(self, n: int):
        self.total += n

    def line(self, width: int, height: int) -> str:
        now = time.monotonic()
        dt = max(now - self._last_print, 1e-9)
        rate = (self.total - self._last_total) / dt
        self._last_print = now
        self._last_total = self.total
        elapsed = now - self.t0
        per_pixel = self.total / (width * height)
        return (
            f"[{elapsed:8.2f}] rays: {self.total} ({per_pixel:.1f}/px), "
            f"{rate:.3g} rays/s"
        )
