"""Scene representation: flattened SoA buffers.

The analogue of the reference's Scene (src/scene.rs:134-170): at build time
every object / mesh / area-light is flattened into world-space primitive
soup -- here as structure-of-arrays buffers that live replicated in device
memory:

  - spheres and triangles in separate SoA arrays (no enum dispatch per prim),
  - one unified entity table (objects then lights) holding material SoA and
    light-emission colours,
  - per-triangle pre-baked world-space shading data (vertex normals already
    rotated per scene.rs:184 / geom.rs:119-121; vertex colours per
    model.rs:158-172) so the hot loop is pure gathers + arithmetic.

``SceneArrays`` is the dynamic (differentiable) pytree; ``SceneStatic`` holds
compile-time facts (counts, sky type) and is hashable for use as a static jit
argument.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax.numpy as jnp

from paths_tpu.sky import Sky


class BvhArrays(NamedTuple):
    """Stackless (skip-link / threaded) BVH over the triangle soup.

    node_min/node_max: (N, 3) AABBs.
    hit_link:  (N,) next node index when the AABB is hit (first child for
               inner nodes, the preorder successor for leaves).
    miss_link: (N,) next node index when the AABB is missed (skips subtree).
               -1 terminates traversal.
    prim_start/prim_count: (N,) leaf primitive ranges into the reordered
               triangle arrays (0 count for inner nodes).
    """

    node_min: jnp.ndarray
    node_max: jnp.ndarray
    hit_link: jnp.ndarray
    miss_link: jnp.ndarray
    prim_start: jnp.ndarray
    prim_count: jnp.ndarray


class SceneArrays(NamedTuple):
    # Spheres (objects' analytic spheres + area-light spheres).
    sph_center: jnp.ndarray  # (S, 3)
    sph_radius: jnp.ndarray  # (S,)
    sph_ent: jnp.ndarray  # (S,) int32 entity index

    # Triangles (world space, baked at build like scene.rs:149 / geom.rs:111-117).
    tri_v0: jnp.ndarray  # (T, 3)
    tri_v1: jnp.ndarray
    tri_v2: jnp.ndarray
    tri_n: jnp.ndarray  # (T, 3) unit geometric normal (world)
    tri_vn0: jnp.ndarray  # (T, 3) shading normals (world; may be non-unit,
    tri_vn1: jnp.ndarray  #   reproducing model.rs:142-156 -- no renorm)
    tri_vn2: jnp.ndarray
    tri_vc0: jnp.ndarray  # (T, 3) vertex colours (ones when absent)
    tri_vc1: jnp.ndarray
    tri_vc2: jnp.ndarray
    tri_ent: jnp.ndarray  # (T,) int32
    tri_smooth: jnp.ndarray  # (T,) bool: smooth normals (no backface flip,
    #   matching scene.rs:178-190 which replaces the flipped geometric normal)

    # Entity table: objects [0, n_objects) then lights [n_objects, E).
    ent_is_light: jnp.ndarray  # (E,) bool
    ent_light_emission: jnp.ndarray  # (E, 3) colour * intensity for lights
    mat_mtype: jnp.ndarray  # (E,) int32
    mat_albedo: jnp.ndarray  # (E, 3)
    mat_albedo_vertex: jnp.ndarray  # (E,) bool: albedo from vertex colours
    mat_emit: jnp.ndarray  # (E, 3)
    mat_r0: jnp.ndarray  # (E,)
    mat_metalness: jnp.ndarray  # (E,)
    mat_roughness: jnp.ndarray  # (E,)

    # FresnelCombination sub-materials (material.rs:373-428).  For rows with
    # mtype FRESNEL, the primary albedo/r0/metalness/roughness columns hold
    # the *diffuse* sub-material (typed by mat_fd_mtype) and the fs_ columns
    # hold the *specular* sub-material; mat_fresnel_r0 is ((1-n)/(1+n))^2
    # from the refractive index (material.rs:381-387).  Gathered into the hot
    # loop only when SceneStatic.has_fresnel.
    mat_fd_mtype: jnp.ndarray  # (E,) int32
    mat_fs_mtype: jnp.ndarray  # (E,) int32
    mat_fs_albedo: jnp.ndarray  # (E, 3)
    mat_fs_r0: jnp.ndarray  # (E,)
    mat_fs_metalness: jnp.ndarray  # (E,)
    mat_fs_roughness: jnp.ndarray  # (E,)
    mat_fresnel_r0: jnp.ndarray  # (E,)

    # Lights.
    light_ltype: jnp.ndarray  # (L,) int32
    light_pos: jnp.ndarray  # (L, 3)
    light_radius: jnp.ndarray  # (L,)
    light_colour: jnp.ndarray  # (L, 3)
    light_intensity: jnp.ndarray  # (L,)
    light_ent: jnp.ndarray  # (L,) int32

    sky: Sky
    bvh: Optional[BvhArrays]
    # Row-packed BVH and triangle tables for the GPU walk kernel
    # (ops/bvh_walk.WalkTables); None unless SceneStatic.bvh_kernel.
    walk: object = None


@dataclass(frozen=True)
class SceneStatic:
    """Hashable compile-time scene facts."""

    n_spheres: int
    n_tris: int
    n_lights: int
    n_entities: int
    sky_type: int
    # Triangles are walked through scene.bvh (bvh/traverse.py) instead of
    # the brute-force scan; with bvh_kernel, through the GPU kernel's
    # tables in scene.walk (ops/bvh_walk.py).  Chosen by scene/build.py.
    use_bvh: bool = False
    bvh_kernel: bool = False
    has_fresnel: bool = False
    # Bounce cap (trace.rs:14 caps `loops > 10` -> 11 iterations).  A
    # compile-time knob: lowering it shrinks the unrolled-scan program for
    # fast-compile paths (previews, dryruns) at the cost of bias.
    max_bounces: int = 10
    # Environment-map NEE (importance-sample the HDRI as a light source;
    # capability extension over the reference's skybox-on-miss).  Off by
    # default to match reference semantics exactly.
    env_nee: bool = False

    @property
    def has_spheres(self) -> bool:
        return self.n_spheres > 0

    @property
    def has_tris(self) -> bool:
        return self.n_tris > 0
