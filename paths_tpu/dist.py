"""Multi-chip / multi-host distribution.

Reference parallelism: a thread pool pulling pixel-column requests off a
crossbeam channel (renderer.rs:36-54).  Replacement here (SURVEY.md
section 2, parallelism table):

  - one mesh axis ``dp`` over all devices; pixel/ray wavefronts are sharded
    along it, scene/BVH buffers and camera are replicated (the renderer
    analogue of "replicated parameters, sharded activations");
  - progressive accumulation is local to each device's pixel shard -- no
    cross-device traffic on the forward path at all;
  - the inverse-rendering training step all-reduces parameter gradients with
    ``psum`` inside ``shard_map``, which XLA hands to NCCL over NVLink on a
    multi-GPU host (the analogue of DP gradient all-reduce).

Multi-host: call ``init_multihost()`` (a thin wrapper over
``jax.distributed.initialize``) before building the mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from paths_tpu import render as R
from paths_tpu.grad import get_params, l2_loss, with_params


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None):
    """Multi-host entry point: join the jax.distributed runtime so
    ``jax.devices()`` spans every host's devices and the dp mesh spans
    hosts.

    With no arguments, relies on whatever cluster environment JAX can
    auto-detect; elsewhere pass the coordinator address, process count and
    process id.  Safe to call once per process, before any device query."""
    kw = {}
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    jax.distributed.initialize(**kw)


def make_mesh(devices=None, axis: str = "dp") -> Mesh:
    if devices is None:
        devices = jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (axis,))


def sharded_render_wave(static, mesh: Mesh, axis: str = "dp"):
    """Jitted render_wave with pixel lanes sharded over the mesh and the
    scene replicated.  Lane count must divide by the mesh size."""
    lane = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    fn = partial(R.render_wave, static)
    return jax.jit(
        fn,
        in_shardings=(repl, repl, lane, lane, lane, lane, repl),
        out_shardings=lane,
    )


def sharded_render_samples(static, mesh: Mesh, n_samples: int, axis: str = "dp"):
    """The production forward (render_samples' regenerating wavefront) as an
    explicit per-device SPMD program: each device runs the full local
    pipeline -- traversal kernels, while-loop regeneration -- over its own
    pixel shard, with zero cross-device traffic on the forward path.
    ``shard_map`` (not jit+in_shardings) so the kernel custom calls never
    meet the SPMD partitioner: they simply execute per device, exactly as
    on one device.  Lane count must divide by the mesh size.

    Returns a jitted fn (scene, cam, px, py, pid, sample_start, seed) ->
    (N, 3) lane-sharded radiance sums."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    def fwd(scene, cam, px, py, pid, sample_start, seed):
        return R.render_samples(
            static, scene, cam, px, py, pid, sample_start, n_samples, seed
        )

    return jax.jit(fwd)


def sharded_train_step(static, mesh: Mesh, axis: str = "dp", lr: float = 0.05):
    """One inverse-rendering SGD step as an explicit-SPMD program:
    per-device local gradients over its pixel shard, psum across devices,
    replicated parameter update.  Returns a jitted fn
    (params, scene, cam, px, py, pid, sid, seed, target) -> (loss, params).
    """

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(),  # params (replicated)
            P(),  # scene
            P(),  # camera
            P(axis),  # px
            P(axis),  # py
            P(axis),  # pixel_id
            P(axis),  # sample_id
            P(),  # seed
            P(axis),  # target
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step(params, scene, cam, px, py, pid, sid, seed, target):
        def local_loss(params):
            # Mean over the local shard; psum of shard-means / n_shards ==
            # global mean because shards are equal-sized.
            return l2_loss(
                static, params, scene, cam, px, py, pid, sid, seed, target
            )

        loss, grads = jax.value_and_grad(local_loss)(params)
        n = jax.lax.psum(jnp.ones(()), axis)
        loss = jax.lax.psum(loss, axis) / n
        grads = jax.tree.map(lambda g: jax.lax.psum(g, axis) / n, grads)
        new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return loss, new_params

    return jax.jit(step)
