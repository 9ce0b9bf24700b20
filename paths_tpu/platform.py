"""Where the renderer runs: the one module that reads the JAX backend.

``traversal_backend()`` picks how triangle meshes are walked:

  - ``"gpu"`` -> ``"kernel"``: the compiled BVH walk of ops/bvh_walk.py;
  - ``"cpu"`` -> ``"xla"``: the plain JAX paths (brute-force scan, or the
    gather-driven walk of bvh/traverse.py for large meshes);
  - anything else is an error: no other accelerator has a tested path.

``enable_compile_cache()`` is the one place that configures JAX's
persistent compilation cache.
"""

from __future__ import annotations

import os

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def traversal_backend() -> str:
    backend = jax.default_backend()
    if backend == "gpu":
        return "kernel"
    if backend == "cpu":
        return "xla"
    raise RuntimeError(
        f"no traversal path for JAX backend {backend!r} (supported: gpu, cpu)"
    )


def enable_compile_cache() -> None:
    """Keep compiled executables across processes.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here.  Otherwise the cache lives at a fixed path inside
    the checkout (the path is part of the cache key, so it must not move)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", os.path.join(_REPO, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
