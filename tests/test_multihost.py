"""Real multi-process coverage for the multi-host entry point.

Every other multi-device test runs single-process over 8 virtual CPU
devices; ``dist.init_multihost`` (the wrapper over
``jax.distributed.initialize``, the analogue of the reference's worker-pool
spawn + channel wiring, renderer.rs:38-54) was the one distribution path
with no executed coverage.  Here TWO subprocesses join a localhost
coordinator (CPU backend), assert the global device view
(len(jax.devices()) == 2 * len(jax.local_devices())), run ONE
``sharded_train_step`` over the GLOBAL mesh -- so the gradient/loss psum
really crosses the process boundary -- and the psum'd loss is asserted
equal to a single-process run of the same wave.

This verifies the wiring, not the bandwidth; the test stays on the CPU
backend, so it never opens an accelerator.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json
import sys

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

from paths_tpu.platform import enable_compile_cache

enable_compile_cache()

from paths_tpu.dist import init_multihost, make_mesh, sharded_train_step
from paths_tpu.grad import get_params
from paths_tpu.scene.build import build_scene
from paths_tpu.scene.stress import generate_stress_scene
from paths_tpu import camera as C

coord, pid = sys.argv[1], int(sys.argv[2])
init_multihost(coordinator_address=coord, num_processes=2, process_id=pid)

n_local = len(jax.local_devices())
n_global = len(jax.devices())
assert n_global == 2 * n_local, (n_global, n_local)

# Establish the cross-process gloo context NOW, while inter-process skew
# is minimal (both workers were spawned together and have done identical
# work so far): gloo's rendezvous has a hard ~30 s deadline, and the big
# jit compiles below can drift the processes further apart than that on
# a loaded host.  Later collectives reuse the context.
from jax.experimental import multihost_utils

multihost_utils.sync_global_devices("init")

import dataclasses

sd = generate_stress_scene(8, seed=0)
static, scene, cam = build_scene(sd)
static = dataclasses.replace(static, max_bounces=1)
W, H = 16, 4
cam = C.resize(cam, W, H)
n = W * H
pix = np.arange(n, dtype=np.uint32)

from jax.sharding import NamedSharding, PartitionSpec as P

mesh = make_mesh()  # global: both processes' devices
lane = NamedSharding(mesh, P("dp"))
repl = NamedSharding(mesh, P())


def lane_arr(x):
    x = np.asarray(x)
    k = x.shape[0] // n_global
    local = x[pid * n_local * k : (pid + 1) * n_local * k]
    return jax.make_array_from_process_local_data(lane, local, x.shape)


def repl_tree(tree):
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            repl, np.asarray(x), np.shape(x)
        ),
        tree,
    )


px = lane_arr((pix % W).astype(np.int32))
py = lane_arr((pix // W).astype(np.int32))
pidl = lane_arr(pix)
sid = lane_arr(np.zeros(n, np.uint32))
target = lane_arr(np.zeros((n, 3), np.float32))
scene_g = repl_tree(scene)
cam_g = repl_tree(cam)
params_g = repl_tree(get_params(scene))

step = sharded_train_step(static, mesh, lr=0.05)
# AOT-compile (local, no collectives executed), THEN barrier: gloo's
# cross-process context init has a hard ~30 s rendezvous deadline, and
# under a loaded host the two workers' jit compiles can finish further
# apart than that.  After the barrier both processes dispatch the psum
# within milliseconds.
args = (params_g, scene_g, cam_g, px, py, pidl, sid, 0, target)
step_c = step.lower(*args).compile()
multihost_utils.sync_global_devices("compiled")
loss, new_params = step_c(*args)
loss = float(loss)
flat = jax.tree.leaves(new_params)
finite = all(bool(np.isfinite(np.asarray(x)).all()) for x in flat)
print("MULTIHOST_RESULT " + json.dumps(
    {"pid": pid, "n_local": n_local, "n_global": n_global,
     "loss": loss, "params_finite": finite}))
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_init_multihost_train_step():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # no 8-virtual-device split in the workers
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, coord, str(i)],
            env=env, cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            # Generous: under the full xdist suite both cores are
            # oversubscribed ~3x and the workers' compiles +
            # gloo barriers run starved (standalone: ~50 s).
            out, err = p.communicate(timeout=1200)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost worker timed out")

    results = []
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{err[-2000:]}"
        lines = [l for l in out.splitlines() if l.startswith("MULTIHOST_RESULT ")]
        assert lines, f"no result line:\n{out[-500:]}\n{err[-500:]}"
        results.append(json.loads(lines[-1].split(" ", 1)[1]))

    for r in results:
        assert r["n_global"] == 2 * r["n_local"]
        assert r["params_finite"]
    # The psum crossed processes: both report the identical global loss.
    assert results[0]["loss"] == results[1]["loss"]

    # And it equals the single-process loss of the same wave (RNG is a pure
    # function of (pixel, sample): device layout cannot change results).
    import dataclasses

    import numpy as np
    import jax.numpy as jnp

    from paths_tpu import camera as C
    from paths_tpu.grad import loss_and_grad
    from paths_tpu.scene.build import build_scene
    from paths_tpu.scene.stress import generate_stress_scene

    sd = generate_stress_scene(8, seed=0)
    static, scene, cam = build_scene(sd)
    static = dataclasses.replace(static, max_bounces=1)
    W, H = 16, 4
    cam = C.resize(cam, W, H)
    n = W * H
    pix = np.arange(n, dtype=np.uint32)
    px = jnp.asarray((pix % W).astype(np.int32))
    py = jnp.asarray((pix // W).astype(np.int32))
    pid = jnp.asarray(pix)
    sid = jnp.zeros(n, jnp.uint32)
    target = jnp.zeros((n, 3))
    loss_ref, _ = loss_and_grad(
        static, scene, cam, px, py, pid, sid, 0, target
    )
    np.testing.assert_allclose(results[0]["loss"], float(loss_ref), rtol=2e-5)
