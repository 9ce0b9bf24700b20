"""Progressive rendering runtime: epochs, preview pass, fly-cam, FPS governor.

The replacement for the reference's execution runtime
(src/renderer.rs, src/controller.rs, src/timing.rs, src/pixels.rs):

  reference                         | here
  ----------------------------------|-----------------------------------
  4 worker threads pulling column   | one jitted sample wave over every
  requests off a bounded channel    | pixel per pump() (device-parallel)
  epoch stamps dropping stale       | dispatch is synchronous per wave, so
  results (worker.rs:58-66)         | a camera change simply resets the
                                    | estimator -- no staleness exists
  sparse 6x6 preview pass           | same: a 1/36-lane preview wave after
  (renderer.rs:152-164)             | each reset, upsampled on display
  Estimator sum/count + grid fill   | same (pixels.rs:6-31, 53-79)
  Governer 60Hz limiter             | same (timing.rs:5-57)
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import jax.numpy as jnp

from paths_tpu import camera as C
from paths_tpu.math import matrix as mat
from paths_tpu.render import Estimator, _render_samples_jit
from paths_tpu.sampling import hashing as H

PREVIEW_GRID_SIZE = 6  # renderer.rs:13


class ProgressiveRenderer:
    """Accumulates sample waves; camera changes start a new epoch."""

    def __init__(self, static, scene, cam: C.Camera, width: int, height: int,
                 seed: int = 0, samples_per_pump: int = 1):
        self.static = static
        self.scene = scene
        self.cam = cam
        self.width = width
        self.height = height
        self.seed = seed
        self.samples_per_pump = samples_per_pump
        self.epoch = 0
        self.sample_cursor = 0
        self.num_rays_cast = 0
        self.estimator = Estimator(width, height)
        self._full_ids = None
        self._preview_pending = True
        self._pending = None  # one in-flight wave (see pump)

        from paths_tpu.render import tiled_pixel_order

        pix = tiled_pixel_order(width, height)
        self._px = (pix % width).astype(np.int32)
        self._py = (pix // width).astype(np.int32)
        self._pid = pix
        # Preview lanes: every PREVIEW_GRID_SIZE-th pixel in x and y
        # (renderer.rs:152-164).
        mask = (self._px % PREVIEW_GRID_SIZE == 0) & (self._py % PREVIEW_GRID_SIZE == 0)
        self._prev_idx = np.nonzero(mask)[0]

    # -- camera control (renderer.rs:112-128) --
    def set_camera(self, location, rot3x3):
        self.cam = self.cam._replace(
            location=jnp.asarray(location, jnp.float32),
            rot=jnp.asarray(rot3x3, jnp.float32),
        )
        self.reset()

    def reset(self):
        """New epoch: wipe accumulation (renderer.rs:143-150)."""
        self.epoch += 1
        self.sample_cursor = 0
        self.num_rays_cast = 0
        self.estimator.reset()
        self._preview_pending = True

    # -- progressive work (the fill/drain pump) --
    def _dispatch(self):
        """Launch the next wave asynchronously; returns the in-flight
        record (epoch, idx, n_samples, device array)."""
        # Seed folded with epoch: fresh sample sequence per camera pose.
        # Kept as a TYPED np.uint32 scalar: as a plain Python int any value
        # past 2^31 (i.e. every epoch >= 1) overflows jit's weak-int32
        # argument parsing -- a camera move crashed the viewer
        # (caught by tests/test_viewer.py test_pipelined_pump_drops_stale_epoch).
        seed = np.uint32(self.seed) + np.uint32(self.epoch) * np.uint32(0x9E3779B9)
        if self._preview_pending:
            idx = self._prev_idx
            n_samples = 1
            self._preview_pending = False
        else:
            idx = slice(None)
            n_samples = self.samples_per_pump
        px = jnp.asarray(self._px[idx])
        py = jnp.asarray(self._py[idx])
        pid = jnp.asarray(self._pid[idx])
        col = _render_samples_jit(
            self.static, self.scene, self.cam, px, py, pid,
            jnp.uint32(self.sample_cursor), n_samples, seed,
        )
        if isinstance(idx, slice):
            self.sample_cursor += n_samples
        return (self.epoch, idx, n_samples, col)

    def pump(self):
        """Progress the render by one frame's worth of work.

        PIPELINED: the next wave is dispatched BEFORE the previous wave's
        result is fetched, so the host-side fetch + accumulate + draw of
        frame n overlaps the device computing frame n+1 (JAX dispatch is
        async; np.asarray blocks only on the already-running previous
        wave), so the device never waits on the host's draw.  A camera
        change mid-flight bumps the epoch and the stale wave is dropped
        on arrival -- the same staleness rule as the reference's workers
        (worker.rs:58-66), narrowed to the one in-flight wave.
        """
        pending = self._pending
        self._pending = self._dispatch()
        if pending is None:
            return
        epoch, idx, n_samples, col = pending
        if epoch != self.epoch:
            return  # stale epoch: camera moved while in flight
        col = np.asarray(col, np.float64)
        ys = self._py[idx]
        xs = self._px[idx]
        self.estimator.sum[ys, xs] += col
        self.estimator.count[ys, xs] += n_samples
        self.num_rays_cast += len(col) * n_samples

    def frame(self) -> np.ndarray:
        """Current image with preview-grid fill (pixels.rs:53-79)."""
        counts = self.estimator.count
        mean = self.estimator.sum / np.maximum(counts, 1)[..., None]
        if (counts == 0).any():
            gy = (np.arange(self.height) // PREVIEW_GRID_SIZE) * PREVIEW_GRID_SIZE
            gx = (np.arange(self.width) // PREVIEW_GRID_SIZE) * PREVIEW_GRID_SIZE
            anchor = mean[gy][:, gx]
            mean = np.where((counts == 0)[..., None], anchor, mean)
        return mean


class Controller:
    """Fly-cam: accumulate the next pose, apply on change
    (controller.rs:15-71)."""

    def __init__(self, renderer: ProgressiveRenderer, location, orientation3x3):
        self.renderer = renderer
        self.location = np.asarray(location, np.float64)
        self.orientation = np.asarray(orientation3x3, np.float64)
        self.next_location = self.location.copy()
        self.next_orientation = self.orientation.copy()

    def update(self):
        if not (
            np.array_equal(self.location, self.next_location)
            and np.array_equal(self.orientation, self.next_orientation)
        ):
            self.renderer.set_camera(self.next_location, self.next_orientation)
        self.location = self.next_location.copy()
        self.orientation = self.next_orientation.copy()
        self.renderer.pump()

    def move_camera(self, v):
        """Movement in the camera frame (controller.rs:42-49)."""
        v = np.asarray(v, np.float64)
        if not v.any():
            return
        self.next_location = self.next_location + self.orientation @ v

    def rotate(self, yaw, pitch, roll):
        """controller.rs:51-54: post-multiply."""
        self.next_orientation = self.next_orientation @ mat.rotation(yaw, pitch, roll)

    def frame(self):
        return self.renderer.frame()


class Governer:
    """Sliding-window FPS measurement + sleep-to-target (timing.rs:5-57)."""

    def __init__(self, frames_per_second: int):
        self.frames_per_second = frames_per_second
        self.frame_duration = 1.0 / frames_per_second
        self.frame_times = deque([time.monotonic()])
        self.current_fps = 0.0

    def end_frame(self):
        n = len(self.frame_times)
        expected = self.frame_duration * n
        now = time.monotonic()
        actual = now - self.frame_times[-1]
        if actual > 0:
            self.current_fps = n / actual
        self.frame_times.appendleft(now)
        if expected > actual:
            time.sleep(expected - actual)
        while len(self.frame_times) > self.frames_per_second:
            self.frame_times.pop()
