"""Thin-lens camera: vectorised primary-ray generation.

Reference: src/camera.rs:25-94.  One call generates a whole wavefront of rays
as (..., 3) arrays; the camera itself is a pytree of scalars so interactive
pose changes never trigger recompilation.

Numeric contract (camera.rs:47-94, SURVEY.md 3.4):
  x,y flipped:   x' = W-1-x, y' = H-1-y           (lens inversion)
  p = f*v/(v-f)                                    (focal plane distance)
  k = ((x'-W/2+jx)*sw/W, (H/2-y'-jy)*sh/H, -v)     (sensor point)
  l = disk * (f/aperture)                          (lens point)
  dir = -(k*(p/v) + l), normalised
  origin = R@l + loc, direction = R@dir
  weight = dir.z before rotation                   (cosine at sensor)
``distance_from_lens`` v derives from YAML focus_distance d as f*d/(d-f)
(serde.rs:185).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from paths_tpu.math import matrix as mat
from paths_tpu.math import vec


class Camera(NamedTuple):
    """Pytree of dynamic scalars (pose changes don't recompile)."""

    location: jnp.ndarray  # (3,)
    rot: jnp.ndarray  # (3,3) world-from-camera rotation
    focal_length: jnp.ndarray  # scalar
    distance_from_lens: jnp.ndarray  # scalar, v
    aperture: jnp.ndarray  # scalar (f-stop)
    sensor_width: jnp.ndarray  # scalar (metres)
    sensor_height: jnp.ndarray
    width: jnp.ndarray  # image dims as f32 scalars (used arithmetically)
    height: jnp.ndarray


def make_camera(
    width: int,
    height: int,
    location=(0.0, 0.0, 0.0),
    orientation=(0.0, 0.0, 0.0),  # (pitch, yaw, roll) in YAML order
    sensor_width: float = None,
    sensor_height: float = None,
    focal_length: float = 9.86,
    focus_distance: float = None,
    aperture: float = 2.0,
    distance_from_lens: float = None,
    dtype=jnp.float32,
) -> Camera:
    """Build a Camera.  Defaults mirror Camera::new (camera.rs:26-39):
    sensor dims default to the pixel dims, distance_from_lens to 10."""
    pitch, yaw, roll = orientation
    rot = mat.camera_rotation(yaw, pitch, roll)
    if distance_from_lens is None:
        if focus_distance is None:
            distance_from_lens = 10.0
        else:
            # serde.rs:185
            distance_from_lens = (focal_length * focus_distance) / (
                focus_distance - focal_length
            )
    if sensor_width is None:
        sensor_width = float(width)
    if sensor_height is None:
        sensor_height = float(height)
    f = lambda x: jnp.asarray(x, dtype)
    return Camera(
        location=f(np.asarray(location, np.float64)),
        rot=f(rot),
        focal_length=f(focal_length),
        distance_from_lens=f(distance_from_lens),
        aperture=f(aperture),
        sensor_width=f(sensor_width),
        sensor_height=f(sensor_height),
        width=f(float(width)),
        height=f(float(height)),
    )


def resize(cam: Camera, width: int, height: int) -> Camera:
    """Same physical camera at a different pixel resolution (sensor size and
    optics unchanged)."""
    dtype = cam.location.dtype
    return cam._replace(
        width=jnp.asarray(float(width), dtype),
        height=jnp.asarray(float(height), dtype),
    )


def get_rays(
    cam: Camera,
    px: jnp.ndarray,
    py: jnp.ndarray,
    square_xy: tuple[jnp.ndarray, jnp.ndarray],
    disk_xy: tuple[jnp.ndarray, jnp.ndarray],
):
    """Generate rays for integer pixel coords (px, py) with sensor jitter
    ``square_xy`` in [0,1)^2 and lens sample ``disk_xy`` in the unit disk.

    Returns (origin (...,3), direction (...,3), weight (...)).
    camera.rs:47-94 vectorised.
    """
    dtype = cam.location.dtype
    px = jnp.asarray(px).astype(dtype)
    py = jnp.asarray(py).astype(dtype)
    jx, jy = square_xy
    dx, dy = disk_xy

    # Lens image flip (camera.rs:55-57).
    x = cam.width - px - 1.0
    y = cam.height - py - 1.0

    f = cam.focal_length
    v = cam.distance_from_lens
    p = (f * v) / (v - f)  # camera.rs:64-67

    x_scale = cam.sensor_width / cam.width
    y_scale = cam.sensor_height / cam.height
    image_x = x - cam.width / 2.0 + jx
    image_y = cam.height / 2.0 - y - jy
    k = jnp.stack(
        [
            image_x * x_scale,
            image_y * y_scale,
            jnp.broadcast_to(-v, image_x.shape),
        ],
        axis=-1,
    )

    aperture_radius = f / cam.aperture  # camera.rs:41-45
    l = jnp.stack(
        [dx * aperture_radius, dy * aperture_radius, jnp.zeros_like(dx)], axis=-1
    )

    direction_local = -(k * (p / v) + l)  # camera.rs:82-83
    norm_dir = vec.normalize(direction_local)

    # Rotation applied as explicit elementwise math, NOT `@`: XLA may lower
    # the (N,3)x(3,3) matmul onto the matrix units at reduced precision
    # (bf16 / TF32) by default, quantising ray directions -- several-pixel
    # staircase artifacts on silhouettes.  The elementwise form is exact
    # f32 (and faster at this shape).
    def rotate(m, w3):
        return jnp.stack(
            [
                m[0, 0] * w3[..., 0] + m[0, 1] * w3[..., 1] + m[0, 2] * w3[..., 2],
                m[1, 0] * w3[..., 0] + m[1, 1] * w3[..., 1] + m[1, 2] * w3[..., 2],
                m[2, 0] * w3[..., 0] + m[2, 1] * w3[..., 1] + m[2, 2] * w3[..., 2],
            ],
            axis=-1,
        )

    origin = rotate(cam.rot, l) + cam.location  # camera.rs:86-88
    direction = rotate(cam.rot, norm_dir)
    weight = norm_dir[..., 2]  # camera.rs:90-91
    return origin, direction, weight
