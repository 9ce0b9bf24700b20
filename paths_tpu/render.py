"""Frame rendering: sample waves, progressive estimator, image output.

The replacement for the reference's worker/renderer/pixels trio
(src/worker.rs, src/renderer.rs, src/pixels.rs): instead of a thread pool
pulling pixel-column requests from a channel, a *sample wave* -- one CMJ
sample for every pixel of a tile -- is a single jitted call, and progressive
refinement is repeated waves accumulated into a running-mean estimator
(pixels.rs:6-31).

Sampling structure mirrors worker.rs:68-86: each (pixel, sample) draws a
sensor sample from a CMJ Square pattern and a lens sample from a CMJ Disk
pattern; unlike the reference (which shares one pattern across a column with
a random seed per request, worker.rs:68-71), patterns are seeded per-pixel so
every pixel gets a full stratified m x n pattern -- strictly better
stratification with the same per-sample distribution.
"""

from __future__ import annotations

import struct
import zlib
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from paths_tpu import camera as C
from paths_tpu import integrator as I
from paths_tpu.math.colour import to_bytes_np
from paths_tpu.sampling import cmj
from paths_tpu.sampling import hashing as H

# Per-pixel CMJ pattern dims.  CMJ stratification only covers the domain
# uniformly across a *whole* m x n pattern, so patterns are kept small (the
# reference uses 5x5 per request, worker.rs:68-71 / renderer.rs:174-178) and
# re-seeded per (pixel, batch of PAT_M*PAT_N samples).
PAT_M = 4
PAT_N = 4

_SQUARE_TAG = 0x5153
_DISK_TAG = 0xD15C


def gen_camera_rays(cam: C.Camera, px, py, pixel_id, sample_id, seed):
    """Primary rays for (pixel, sample) lanes: CMJ sensor jitter + CMJ lens
    point -> thin-lens ray (worker.rs:68-77).  Returns (o, d, weight)."""
    s = sample_id % jnp.uint32(PAT_M * PAT_N)
    batch = sample_id // jnp.uint32(PAT_M * PAT_N)
    p_sq = H.hash_u32(seed, pixel_id, batch, _SQUARE_TAG)
    p_dk = H.hash_u32(seed, pixel_id, batch, _DISK_TAG)
    sq = cmj.cmj_square(s, PAT_M, PAT_N, p_sq)
    dk = cmj.cmj_disk(s, PAT_M, PAT_N, p_dk)
    return C.get_rays(cam, px, py, sq, dk)


def render_wave(
    static,
    scene,
    cam: C.Camera,
    px: jnp.ndarray,  # (N,) int32 pixel x
    py: jnp.ndarray,  # (N,) int32 pixel y
    pixel_id: jnp.ndarray,  # (N,) uint32
    sample_id: jnp.ndarray,  # (N,) uint32
    seed,
) -> jnp.ndarray:
    """Radiance estimates for one sample of N pixels: (N, 3)."""
    seed = jnp.asarray(seed).astype(jnp.uint32)
    o, d, w = gen_camera_rays(cam, px, py, pixel_id, sample_id, seed)
    col = I.trace_rays(static, scene, o, d, pixel_id, sample_id, seed)
    return col * w[..., None]  # worker.rs:77: sample = trace * weight


@partial(jax.jit, static_argnums=(0,))
def _render_wave_jit(static, scene, cam, px, py, pixel_id, sample_id, seed):
    return render_wave(static, scene, cam, px, py, pixel_id, sample_id, seed)


def render_samples(
    static, scene, cam, px, py, pixel_id, sample_start, n_samples: int, seed,
):
    """Sum of `n_samples` consecutive radiance samples per pixel lane, as one
    on-device *regenerating wavefront*.

    The naive schedule (fori over samples x fori over 11 bounces, the
    reference's per-ray recursion flattened) runs every bounce iteration for
    the whole wave even though most paths die after 2-3 bounces -- on SPMD
    hardware the dead lanes still cost full time.  Here each lane carries its
    own (sample slot, bounce) and the moment a path terminates the lane
    accumulates the finished sample and immediately starts the next sample's
    camera ray ("path regeneration"), so every while-loop iteration does
    useful intersection/shading work on ~every lane.  Total iterations per
    lane ~= n_samples * mean_path_length + tail, vs n_samples * 11 for the
    fixed schedule.

    RNG identity is (pixel_id, sample_id, bounce, dim) exactly as in
    render_wave, so the result equals the sum of the n_samples individual
    waves (same paths, same decisions) up to float addition order.

    Forward-only: uses lax.while_loop, so not reverse-differentiable.
    Gradients go through render_wave / trace_rays (fixed schedule).
    """
    from jax import lax

    seed = jnp.asarray(seed).astype(jnp.uint32)
    N = px.shape[0]
    max_b = static.max_bounces + 1  # trace.rs:14: 11 segment iterations
    s_start = jnp.asarray(sample_start).astype(jnp.uint32)
    n_total = jnp.uint32(n_samples)

    def u_for(sample_slot, pid):
        sid = s_start + sample_slot

        def u(bounce, dim):
            return H.uniform(
                seed, pid, sid,
                jnp.asarray(bounce).astype(jnp.uint32)
                * jnp.uint32(H.DIMS_PER_BOUNCE) + jnp.uint32(dim),
            )

        return u

    def regen(slot):
        """Camera rays + fresh path state for per-lane sample slot."""
        sid = s_start + slot
        o, d, w = gen_camera_rays(cam, px, py, pixel_id, sid, seed)
        return I.fresh_path_state(o, d), w

    state0, w0 = regen(jnp.zeros(N, jnp.uint32))
    carry0 = (
        jnp.zeros((N, 3)),           # acc: finished-sample sum
        jnp.zeros(N, jnp.uint32),    # per-lane sample slot
        jnp.zeros(N, jnp.uint32),    # per-lane bounce
        w0,                          # per-lane sensor weight
        jnp.zeros(N, bool),          # done: all samples consumed
        state0,
    )

    def cond(carry):
        return ~jnp.all(carry[4])

    def body(carry):
        acc, slot, bounce, w, done, state = carry
        state = I.path_step(static, scene, bounce, state, u_for(slot, pixel_id))
        bounce = bounce + 1
        alive = state[4]
        finished = ~done & (~alive | (bounce >= max_b))

        # Bank the finished sample (worker.rs:77: sample = trace * weight).
        colour = state[3]
        acc = acc + jnp.where(finished[..., None], colour * w[..., None], 0.0)

        # Advance to the next sample slot; regenerate or retire the lane.
        slot = jnp.where(finished, slot + 1, slot)
        done = done | (finished & (slot >= n_total))
        start_new = finished & ~done
        fresh, w_new = regen(slot)
        bounce = jnp.where(start_new, 0, bounce)
        w = jnp.where(start_new, w_new, w)

        def sel(new, old):
            m = start_new
            if new.ndim == old.ndim == 2:
                m = m[..., None]
            return jnp.where(m, new, old)

        state = tuple(sel(n, o) for n, o in zip(fresh, state))
        # Retired lanes must not keep tracing: force dead.
        state = state[:4] + (state[4] & ~done,) + state[5:]
        return (acc, slot, bounce, w, done, state)

    return lax.while_loop(cond, body, carry0)[0]


_render_samples_jit = jax.jit(render_samples, static_argnums=(0, 7))


def tiled_pixel_order(width: int, height: int, tile: int = 32) -> np.ndarray:
    """Pixel ids (y*W+x) in tile-major order.

    Consecutive lanes share a kernel block (and a warp); in row-major order
    a block is a thin strip across the whole image, whose rays (and their
    bounce origins) spread over the entire scene.  Tile-major order makes
    each run of lanes a compact 32x32 pixel tile -- the analogue of the
    reference's pixel-column work units (renderer.rs:166-192), chosen
    square for ray coherence rather than cache lines."""
    pix = np.arange(width * height, dtype=np.uint32)
    x = pix % width
    y = pix // width
    key = (
        (y // tile).astype(np.uint64) * ((width + tile - 1) // tile)
        + (x // tile)
    ) * (tile * tile) + (y % tile) * tile + (x % tile)
    return pix[np.argsort(key, kind="stable")]


class Estimator:
    """Per-pixel running mean via sum + count (pixels.rs:6-31)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.sum = np.zeros((height, width, 3), np.float64)
        self.count = np.zeros((height, width), np.int64)

    def update(self, py, px, colours):
        np.add.at(self.sum, (py, px), np.asarray(colours, np.float64))
        np.add.at(self.count, (py, px), 1)

    def mean(self) -> np.ndarray:
        c = np.maximum(self.count, 1)[..., None]
        return self.sum / c

    def reset(self):
        self.sum[:] = 0
        self.count[:] = 0

    def to_bytes(self) -> np.ndarray:
        return to_bytes_np(self.mean())


def render_image(
    static,
    scene,
    cam: C.Camera,
    width: int,
    height: int,
    spp: int = 16,
    seed: int = 0,
    tile_pixels: int = 65536,
    progress: bool = False,
    est: "Estimator | None" = None,
    start_sample: int = 0,
    on_batch=None,
    sample_batch: int = 8,
    mesh=None,
) -> np.ndarray:
    """Render a full frame at `spp` samples per pixel.  Returns (H, W, 3)
    linear-RGB float64 means.

    Sample-major loop: each pass adds a batch of samples to every pixel, so
    the frame refines progressively and the accumulated state is
    checkpointable between batches (paths_tpu.checkpoint).  Resume by
    passing the loaded `est` and `start_sample`; identical RNG streams make
    the result bit-identical to an uninterrupted render.
    `on_batch(est, next_sample)` fires after each full-frame batch.

    Accumulation is device-resident in BOTH modes; the host only fetches
    when the image, a progress callback, or a checkpoint needs it.

    mesh: a ``jax.sharding.Mesh`` (see paths_tpu.dist.make_mesh) shards each
    wave's pixel lanes over the mesh's devices -- the multi-chip replacement
    for the reference's worker pool (renderer.rs:34-69); the per-tile
    accumulators are then lane-sharded with no cross-chip traffic on the
    forward path.
    """
    if est is None:
        est = Estimator(width, height)
    n_pix = width * height
    pix = tiled_pixel_order(width, height)
    px_all = (pix % width).astype(np.int32)
    py_all = (pix // width).astype(np.int32)

    tile = min(tile_pixels, n_pix)
    if mesh is not None:
        # Lane shards must be equal-sized across devices.
        n_dev = int(mesh.devices.size)
        tile = -(-tile // n_dev) * n_dev
    # Batch samples on-device in groups to bound per-dispatch latency while
    # amortising dispatch overhead.
    sample_batch = min(spp, sample_batch)
    tiles = []
    for start in range(0, n_pix, tile):
        end = min(start + tile, n_pix)
        pad = tile - (end - start)
        sl = slice(start, end)
        tiles.append((
            sl, end - start,
            jnp.asarray(np.pad(px_all[sl], (0, pad))),
            jnp.asarray(np.pad(py_all[sl], (0, pad))),
            jnp.asarray(np.pad(pix[sl], (0, pad))),
        ))

    if mesh is None:
        run = lambda px_j, py_j, pid_j, s, k: _render_samples_jit(
            static, scene, cam, px_j, py_j, pid_j, jnp.uint32(s), k, seed
        )
    else:
        from paths_tpu import dist

        _sharded = {}

        def run(px_j, py_j, pid_j, s, k):
            fn = _sharded.get(k)
            if fn is None:
                fn = _sharded[k] = dist.sharded_render_samples(static, mesh, k)
            return fn(scene, cam, px_j, py_j, pid_j, jnp.uint32(s), seed)

    # DEFERRED accumulation: every wave is dispatched without a host sync
    # (results stay on device), and the estimator is folded only at flush
    # points -- a progress/checkpoint callback, the pending-batch cap, or
    # the final image, so the host never stalls the device between
    # batches; the fold itself stays ONE
    # f64 += f64 per batch IN BATCH ORDER, so the result is bit-identical
    # no matter where the flush points fall -- the invariant
    # checkpoint/resume depends on (tests/test_checkpoint.py).
    pending = [[] for _ in tiles]  # per tile: [(device col, k), ...]
    pending_batches = 0
    # Cap outstanding device arrays (n_pix * 12 bytes each batch).
    max_pending = 8

    def flush():
        nonlocal pending_batches
        for (sl, n, _, _, _), cols in zip(tiles, pending):
            for col, k in cols:
                est.sum[py_all[sl], px_all[sl]] += \
                    np.asarray(col, np.float64)[:n]
                est.count[py_all[sl], px_all[sl]] += k
            cols.clear()
        pending_batches = 0

    s = start_sample
    while s < spp:
        k = min(sample_batch, spp - s)
        for i, (sl, n, px_j, py_j, pid_j) in enumerate(tiles):
            pending[i].append((run(px_j, py_j, pid_j, s, k), k))
        pending_batches += 1
        s += k
        if progress:
            print(f"[render] samples {s}/{spp}")
        if on_batch is not None:
            flush()
            on_batch(est, s)
        elif pending_batches >= max_pending:
            flush()
    flush()
    return est.mean()


def write_png(path: str, linear_rgb: np.ndarray):
    """Gamma-encode and write an 8-bit RGB PNG (colour.rs:30-36 + SDL blit
    equivalent), with the standard library's zlib."""
    rgb = to_bytes_np(linear_rgb)
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    # Filter type 0 (None) in front of every scanline.
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1
    ).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
