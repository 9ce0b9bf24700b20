"""paths-tpu: a differentiable wavefront path tracer in JAX.

A ground-up reimplementation of the capabilities of the reference renderer
(rynorris/paths, Rust/CPU), run on an NVIDIA GPU (tests run on the CPU):

- SoA scene buffers replicated in device memory, wavefront ray batches
  sharded across devices
- the whole light-transport estimate under one ``jax.jit`` (fixed shapes,
  masked lanes, ``lax.fori_loop`` bounce loop)
- counter-based stateless RNG so every sample is a pure function of
  (pixel, sample index) -- deterministic across shardings and replayable
- differentiable radiance: pixel gradients flow to material / light /
  sky / vertex-colour parameters
- multi-device rendering via ``jax.sharding.Mesh`` + ``shard_map`` with psum
  reductions

Reference layer map: see SURVEY.md (structural analysis of /root/reference).
"""

__version__ = "0.1.0"

from paths_tpu.scene.yaml_loader import load_scene_description
from paths_tpu.render import render_image, Estimator

__all__ = [
    "load_scene_description",
    "render_image",
    "Estimator",
]
