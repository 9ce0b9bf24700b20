"""Scene build: description -> flattened SoA device buffers.

The "compile" step of the renderer (reference: Scene::new, scene.rs:143-170
and SceneDescription::scene, serde.rs:81-155): meshes are expanded to
world-space triangles (rotation @ v * scale + translation, geom.rs:251-261),
area lights contribute their sphere primitive, materials resolve (Auto pulls
the OBJ diffuse else white Lambertian, serde.rs:126-131), and everything
lands in SceneArrays.

All host math in f64, cast to f32 on upload -- mirroring the reference's f64
with golden-test tolerances absorbing the cast.
"""

from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp

from paths_tpu import materials as M
from paths_tpu import lights as LT
from paths_tpu import platform
from paths_tpu import sky as SK
from paths_tpu.camera import Camera, make_camera
from paths_tpu.integrator import _UNROLL_MAX
from paths_tpu.math import matrix as mat
from paths_tpu.scene import desc as D
from paths_tpu.scene.models import ModelLibrary
from paths_tpu.scene.types import SceneArrays, SceneStatic


_NO_SUB = (M.LAMBERTIAN, np.zeros(3), 0.0, 0.0, 0.0)  # (mtype, albedo, r0, metal, rough)
# Off the GPU kernel path, triangle count above which the gather-driven BVH
# walk replaces the brute-force scan.
BVH_THRESHOLD = 32768


def _basic_sub_row(m: D.MaterialD):
    """Map a BasicMaterial description (serde.rs:267-272: Lambertian | Gloss
    | Mirror | CookTorrance) to (mtype, albedo, r0, metalness, roughness)."""
    kind = m.kind
    if kind == "lambertian":
        return (M.LAMBERTIAN, np.array(m.albedo.colour.tolist()), 0.0, 0.0, 0.0)
    if kind == "mirror":
        return (M.MIRROR, np.ones(3), 0.0, 0.0, 0.0)
    if kind == "gloss":
        return (M.GLOSS, np.array(m.albedo.colour.tolist()), m.reflectance,
                m.metalness, 0.0)
    if kind == "cook_torrance":
        return (M.COOK_TORRANCE, np.array(m.albedo.colour.tolist()), 0.0, 0.0,
                m.roughness)
    raise ValueError(f"Material kind {kind} is not a BasicMaterial")


def _material_row(m: D.MaterialD, model_diffuse=None):
    """Map a MaterialD to SoA fields (mtype, albedo, vertex_flag, emit, r0,
    metalness, roughness, fd_mtype, fs_row, fresnel_r0)."""
    kind = m.kind
    if kind == "auto":
        # serde.rs:126-131: OBJ diffuse as Lambertian, else white Lambertian.
        albedo = model_diffuse if model_diffuse is not None else np.ones(3)
        return (M.LAMBERTIAN, np.asarray(albedo, np.float64), False, np.zeros(3),
                0.0, 0.0, 0.0, M.LAMBERTIAN, _NO_SUB, 0.0)
    if kind == "lambertian":
        return (M.LAMBERTIAN, np.array(m.albedo.colour.tolist()), m.albedo.is_vertex,
                np.zeros(3), 0.0, 0.0, 0.0, M.LAMBERTIAN, _NO_SUB, 0.0)
    if kind == "mirror":
        return (M.MIRROR, np.ones(3), False, np.zeros(3), 0.0, 0.0, 0.0,
                M.LAMBERTIAN, _NO_SUB, 0.0)
    if kind == "gloss":
        return (M.GLOSS, np.array(m.albedo.colour.tolist()), m.albedo.is_vertex,
                np.zeros(3), m.reflectance, m.metalness, 0.0,
                M.LAMBERTIAN, _NO_SUB, 0.0)
    if kind == "cook_torrance":
        return (M.COOK_TORRANCE, np.array(m.albedo.colour.tolist()), False,
                np.zeros(3), 0.0, 0.0, m.roughness, M.LAMBERTIAN, _NO_SUB, 0.0)
    if kind == "fresnel":
        # FresnelCombination (material.rs:373-428): arbitrary BasicMaterial
        # diffuse/specular pair blended by the Schlick weight from
        # r0 = ((1-n)/(1+n))^2 (material.rs:381-387).  The diffuse
        # sub-material occupies the primary columns (typed by fd_mtype); the
        # specular one goes to the fs_ columns.
        n2 = m.refractive_index
        fresnel_r0 = ((1.0 - n2) / (1.0 + n2)) ** 2
        diffuse = m.diffuse if m.diffuse is not None else D.MaterialD(kind="lambertian")
        specular = m.specular if m.specular is not None else D.MaterialD(kind="mirror")
        fd_mtype, d_alb, d_r0, d_metal, d_rough = _basic_sub_row(diffuse)
        is_vertex = diffuse.albedo.is_vertex if diffuse.kind != "mirror" else False
        return (M.FRESNEL, d_alb, is_vertex, np.zeros(3), d_r0, d_metal, d_rough,
                fd_mtype, _basic_sub_row(specular), fresnel_r0)
    raise ValueError(f"Unknown material kind {kind}")


def build_scene(sd: D.SceneDescription, search_dirs=None,
                bvh_threshold: int = BVH_THRESHOLD):
    """Returns (static_cfg, scene_arrays, camera).

    bvh_threshold: triangle count above which the skip-link BVH replaces the
    streaming brute-force intersector (see comment at the build site)."""
    if search_dirs is None:
        search_dirs = [".", sd.base_dir]
        # Scene YAMLs reference assets CWD-relative ("./scenes/objects/..");
        # also try the scene dir's parent so `scenes/foo.yml` works from
        # anywhere.  (os is module-level: a conditional local import here
        # would shadow it for the whole function.)
        search_dirs.append(os.path.dirname(sd.base_dir))

    library = ModelLibrary(search_dirs=search_dirs)
    for name, filepath in sd.models.items():
        library.declare(name, filepath)

    sph_center, sph_radius, sph_ent = [], [], []
    tri_chunks = []  # list of dict of arrays per mesh-object

    # Entity/material rows (objects first, lights appended after).
    rows = []

    def add_entity(mrow):
        rows.append(mrow)
        return len(rows) - 1

    for o in sd.objects:
        if o.shape_kind == "sphere":
            ent = add_entity(_material_row(o.material))
            sph_center.append(np.array(o.sphere.center.tolist()))
            sph_radius.append(o.sphere.radius)
            sph_ent.append(ent)
        else:
            mesh = o.mesh
            rot = mat.mesh_rotation(mesh.rotation.pitch, mesh.rotation.yaw, mesh.rotation.roll)
            translation = np.array(mesh.translation.tolist())
            for ix in library.load(mesh.model):
                model = library.get(ix)
                ent = add_entity(_material_row(o.material, model.diffuse))
                if mesh.smooth_normals:
                    model.compute_vertex_normals()

                # World-space bake (geom.rs:251-261): R @ v * scale + t.
                verts_w = model.vertices @ rot.T * mesh.scale + translation
                fn_w = model.face_normals @ rot.T  # geom.rs:259

                # Filter degenerate faces but keep original face indices for
                # attribute gathers (model.rs:174-192).
                ok = ~np.isnan(fn_w).any(axis=1)
                faces = model.faces[ok]
                n_w = fn_w[ok]

                v0 = verts_w[faces[:, 0]]
                v1 = verts_w[faces[:, 1]]
                v2 = verts_w[faces[:, 2]]

                if mesh.smooth_normals and model.vertex_normals is not None:
                    vn_w = model.vertex_normals @ rot.T  # scene.rs:184
                    vn0 = vn_w[faces[:, 0]]
                    vn1 = vn_w[faces[:, 1]]
                    vn2 = vn_w[faces[:, 2]]
                    # Vertices with no valid adjacent face average to NaN;
                    # fall back to the geometric normal there.
                    for arr in (vn0, vn1, vn2):
                        bad = np.isnan(arr).any(axis=1)
                        arr[bad] = n_w[bad]
                else:
                    vn0 = vn1 = vn2 = n_w

                if model.vertex_colours is not None:
                    vc0 = model.vertex_colours[faces[:, 0]]
                    vc1 = model.vertex_colours[faces[:, 1]]
                    vc2 = model.vertex_colours[faces[:, 2]]
                else:
                    vc0 = vc1 = vc2 = np.ones_like(v0)

                smooth = mesh.smooth_normals and model.vertex_normals is not None
                tri_chunks.append(
                    dict(v0=v0, v1=v1, v2=v2, n=n_w, vn0=vn0, vn1=vn1, vn2=vn2,
                         vc0=vc0, vc1=vc1, vc2=vc2,
                         ent=np.full(len(faces), ent, np.int64),
                         smooth=np.full(len(faces), smooth, bool))
                )

    n_objects = len(rows)

    # Lights (scene.rs:155-164: area lights also become primitives).
    l_type, l_pos, l_rad, l_col, l_int, l_ent = [], [], [], [], [], []
    for li, l in enumerate(sd.lights):
        ent = add_entity((M.LAMBERTIAN, np.zeros(3), False, np.zeros(3), 0.0, 0.0, 0.0, M.LAMBERTIAN, _NO_SUB, 0.0))
        l_ent.append(ent)
        l_type.append(LT.POINT if l.kind == "point" else LT.SPHERE)
        l_pos.append(np.array(l.position.tolist()))
        l_rad.append(l.radius)
        l_col.append(np.array(l.colour.tolist()))
        l_int.append(l.intensity)
        if l.kind == "sphere":
            sph_center.append(np.array(l.position.tolist()))
            sph_radius.append(l.radius)
            sph_ent.append(ent)

    n_entities = max(1, len(rows))
    n_lights = len(sd.lights)

    # ---- entity table ----
    while len(rows) < n_entities:
        rows.append((M.LAMBERTIAN, np.zeros(3), False, np.zeros(3), 0.0, 0.0, 0.0, M.LAMBERTIAN, _NO_SUB, 0.0))
    mtype = np.array([r[0] for r in rows], np.int32)
    albedo = np.stack([r[1] for r in rows]).astype(np.float64)
    albedo_vertex = np.array([r[2] for r in rows], bool)
    emit = np.stack([r[3] for r in rows]).astype(np.float64)
    r0 = np.array([r[4] for r in rows], np.float64)
    metalness = np.array([r[5] for r in rows], np.float64)
    roughness = np.array([r[6] for r in rows], np.float64)
    fd_mtype = np.array([r[7] for r in rows], np.int32)
    fs_mtype = np.array([r[8][0] for r in rows], np.int32)
    fs_albedo = np.stack([r[8][1] for r in rows]).astype(np.float64)
    fs_r0 = np.array([r[8][2] for r in rows], np.float64)
    fs_metalness = np.array([r[8][3] for r in rows], np.float64)
    fs_roughness = np.array([r[8][4] for r in rows], np.float64)
    fresnel_r0 = np.array([r[9] for r in rows], np.float64)
    has_fresnel = bool((mtype == M.FRESNEL).any())

    ent_is_light = np.zeros(n_entities, bool)
    ent_light_emission = np.zeros((n_entities, 3), np.float64)
    for li in range(n_lights):
        e = l_ent[li]
        ent_is_light[e] = True
        ent_light_emission[e] = l_col[li] * l_int[li]  # trace.rs:37

    # ---- primitives ----
    n_spheres = len(sph_center)
    if n_spheres:
        sphc = np.stack(sph_center)
        sphr = np.array(sph_radius, np.float64)
        sphe = np.array(sph_ent, np.int64)
    else:
        sphc = np.zeros((1, 3)); sphr = np.zeros(1); sphe = np.zeros(1, np.int64)

    use_bvh = False
    bvh_kernel = False
    bvh_arrays = None
    walk = None
    if tri_chunks:
        cat = {k: np.concatenate([c[k] for c in tri_chunks]) for k in tri_chunks[0]}
        n_cat = len(cat["v0"])
        # Intersector selection: meshes small enough to unroll stay on the
        # streaming tests in the integrator; on the GPU every larger mesh
        # takes the BVH walk kernel; on the CPU the brute-force scan serves
        # up to bvh_threshold and the gather-driven BVH walk above it.
        bvh_kernel = (platform.traversal_backend() == "kernel"
                      and n_cat > _UNROLL_MAX)
        if bvh_kernel or n_cat > bvh_threshold:
            # Build the skip-link BVH and reorder triangles to its layout so
            # leaf primitive ranges are contiguous (scene.rs:166-168's single
            # global BVH, flattened).
            from paths_tpu.bvh.build import build_bvh
            from paths_tpu.scene.types import BvhArrays

            tri_min = np.minimum(np.minimum(cat["v0"], cat["v1"]), cat["v2"])
            tri_max = np.maximum(np.maximum(cat["v0"], cat["v1"]), cat["v2"])
            flat = build_bvh(tri_min, tri_max)
            cat = {k: v[flat.order] for k, v in cat.items()}
            bvh_arrays = BvhArrays(
                node_min=jnp.asarray(flat.node_min),
                node_max=jnp.asarray(flat.node_max),
                hit_link=jnp.asarray(flat.hit_link),
                miss_link=jnp.asarray(flat.miss_link),
                prim_start=jnp.asarray(flat.prim_start),
                prim_count=jnp.asarray(flat.prim_count),
            )
            use_bvh = True
            if bvh_kernel:
                from paths_tpu.ops.bvh_walk import pack_tables

                walk = pack_tables(flat, cat["v0"], cat["v1"], cat["v2"],
                                   cat["n"], cat["ent"])
    else:
        z = np.zeros((1, 3))
        cat = dict(v0=z, v1=z, v2=z, n=z, vn0=z, vn1=z, vn2=z,
                   vc0=z, vc1=z, vc2=z, ent=np.zeros(1, np.int64),
                   smooth=np.zeros(1, bool))
    n_tris = len(cat["v0"]) if tri_chunks else 0

    # ---- lights SoA ----
    if n_lights:
        lt = np.array(l_type, np.int32)
        lp = np.stack(l_pos)
        lr = np.array(l_rad, np.float64)
        lc = np.stack(l_col)
        li_arr = np.array(l_int, np.float64)
        le = np.array(l_ent, np.int64)
    else:
        lt = np.zeros(1, np.int32); lp = np.zeros((1, 3)); lr = np.zeros(1)
        lc = np.zeros((1, 3)); li_arr = np.zeros(1); le = np.zeros(1, np.int64)

    # ---- sky ----
    sb = sd.skybox
    if sb.kind == "flat":
        sky_type, sky_arr = SK.flat(sb.colour.tolist())
    elif sb.kind == "gradient":
        sky_type, sky_arr = SK.gradient(sb.overhead_colour.tolist(), sb.horizon_colour.tolist())
    elif sb.kind == "hdri":
        from paths_tpu.scene.hdr_loader import load_hdr

        path = sb.filename
        if not os.path.exists(path):
            for d in search_dirs:
                cand = os.path.join(d, sb.filename)
                if os.path.exists(cand):
                    path = cand
                    break
        sky_type, sky_arr = SK.hdri(load_hdr(path))
    else:
        raise ValueError(f"Unknown skybox kind {sb.kind}")

    f32 = lambda a: jnp.asarray(a, jnp.float32)
    i32 = lambda a: jnp.asarray(a, jnp.int32)

    arrays = SceneArrays(
        sph_center=f32(sphc), sph_radius=f32(sphr), sph_ent=i32(sphe),
        tri_v0=f32(cat["v0"]), tri_v1=f32(cat["v1"]), tri_v2=f32(cat["v2"]),
        tri_n=f32(cat["n"]),
        tri_vn0=f32(cat["vn0"]), tri_vn1=f32(cat["vn1"]), tri_vn2=f32(cat["vn2"]),
        tri_vc0=f32(cat["vc0"]), tri_vc1=f32(cat["vc1"]), tri_vc2=f32(cat["vc2"]),
        tri_ent=i32(cat["ent"]),
        tri_smooth=jnp.asarray(cat["smooth"]),
        ent_is_light=jnp.asarray(ent_is_light),
        ent_light_emission=f32(ent_light_emission),
        mat_mtype=i32(mtype), mat_albedo=f32(albedo),
        mat_albedo_vertex=jnp.asarray(albedo_vertex),
        mat_emit=f32(emit), mat_r0=f32(r0),
        mat_metalness=f32(metalness), mat_roughness=f32(roughness),
        mat_fd_mtype=i32(fd_mtype), mat_fs_mtype=i32(fs_mtype),
        mat_fs_albedo=f32(fs_albedo), mat_fs_r0=f32(fs_r0),
        mat_fs_metalness=f32(fs_metalness), mat_fs_roughness=f32(fs_roughness),
        mat_fresnel_r0=f32(fresnel_r0),
        light_ltype=i32(lt), light_pos=f32(lp), light_radius=f32(lr),
        light_colour=f32(lc), light_intensity=f32(li_arr), light_ent=i32(le),
        sky=sky_arr,
        bvh=bvh_arrays,
        walk=walk,
    )

    static = SceneStatic(
        n_spheres=n_spheres,
        n_tris=n_tris,
        n_lights=n_lights,
        n_entities=n_entities,
        sky_type=sky_type,
        use_bvh=use_bvh,
        bvh_kernel=bvh_kernel,
        has_fresnel=has_fresnel,
    )

    cam = make_camera(
        width=sd.camera.image_width,
        height=sd.camera.image_height,
        location=sd.camera.location.tolist(),
        orientation=(
            sd.camera.orientation.pitch,
            sd.camera.orientation.yaw,
            sd.camera.orientation.roll,
        ),
        sensor_width=sd.camera.sensor_width,
        sensor_height=sd.camera.sensor_height,
        focal_length=sd.camera.focal_length,
        focus_distance=sd.camera.focus_distance,
        aperture=sd.camera.aperture,
    )
    return static, arrays, cam
