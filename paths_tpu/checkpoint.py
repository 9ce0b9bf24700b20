"""Checkpoint / resume for long renders.

The reference has no checkpointing -- its epoch system *discards*
accumulated state on camera change (renderer.rs:143-150).  SURVEY.md
section 5 names the equivalent here: serialize the accumulated
(sum, count) framebuffer plus the sampler sequence counter and RNG seed so a
long render can resume exactly where it stopped.  Because all shading
randomness is a pure function of (seed, pixel, sample_id) (sampling/
hashing.py), a resumed render produces bit-identical results to an
uninterrupted one.

Format: a single .npz with the estimator buffers and a small header.
"""

from __future__ import annotations

import numpy as np

from paths_tpu.render import Estimator

_MAGIC = "paths-tpu-ckpt-v1"


def save_checkpoint(path: str, est: Estimator, next_sample: int, seed: int,
                    extra: dict | None = None):
    """Atomically write the render state (temp file + rename)."""
    import os

    tmp = f"{path}.tmp"
    np.savez_compressed(
        tmp if tmp.endswith(".npz") else tmp,
        magic=np.array(_MAGIC),
        width=np.int64(est.width),
        height=np.int64(est.height),
        sum=est.sum,
        count=est.count,
        next_sample=np.int64(next_sample),
        seed=np.int64(seed),
        **(extra or {}),
    )
    # np.savez appends .npz to names without it.
    written = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(written, path)


def load_checkpoint(path: str):
    """Returns (estimator, next_sample, seed).  Raises ValueError on a
    corrupt or foreign file."""
    with np.load(path, allow_pickle=False) as z:
        if "magic" not in z or str(z["magic"]) != _MAGIC:
            raise ValueError(f"{path}: not a paths-tpu checkpoint")
        est = Estimator(int(z["width"]), int(z["height"]))
        est.sum[:] = z["sum"]
        est.count[:] = z["count"]
        return est, int(z["next_sample"]), int(z["seed"])
