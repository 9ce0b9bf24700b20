"""Native (C++) runtime components, bound via ctypes.

The device compute path is JAX/XLA/Pallas; host-side, latency-critical runtime
work -- BVH construction today, mesh parsing tomorrow -- runs as compiled
C++ (the analogue of the reference's compiled-Rust builder,
/root/reference/src/bvh.rs:143-384).  Every native entry point has a
pure-Python fallback, so the framework degrades gracefully where no
toolchain exists.

The shared library is compiled on first use (``make`` in this directory)
and cached next to the sources.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libpaths_native.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        # Always invoke make: a no-op when the library is current, a
        # rebuild when any .cc is newer than the cached .so.  An exclusive
        # file lock serialises concurrent builders (pytest-xdist workers
        # import this module simultaneously; two g++ links writing the same
        # .so in place can hand one of them a half-written library).
        try:
            # fcntl is POSIX-only; a platform without it must fall through
            # to the graceful no-native path, not raise out of _load().
            import fcntl

            with open(os.path.join(_DIR, ".build.lock"), "w") as lockf:
                fcntl.flock(lockf, fcntl.LOCK_EX)
                try:
                    subprocess.run(
                        ["make", "-s"],
                        cwd=_DIR,
                        check=True,
                        capture_output=True,
                        timeout=300,
                    )
                finally:
                    fcntl.flock(lockf, fcntl.LOCK_UN)
        except (subprocess.SubprocessError, OSError, ImportError):
            if not os.path.exists(_LIB_PATH):
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None

        c = ctypes
        try:
            lib.paths_obj_load.restype = c.c_void_p
            lib.paths_obj_load.argtypes = [c.c_char_p, c.POINTER(c.c_int64)]
            lib.paths_obj_model_info.restype = c.c_int
            lib.paths_obj_model_info.argtypes = [
                c.c_void_p, c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_int64),
                c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            ]
            lib.paths_obj_model_data.restype = c.c_int
            lib.paths_obj_model_data.argtypes = [
                c.c_void_p, c.c_int64, c.POINTER(c.c_double), c.POINTER(c.c_int64),
                c.POINTER(c.c_double), c.POINTER(c.c_double),
            ]
            lib.paths_obj_free.restype = None
            lib.paths_obj_free.argtypes = [c.c_void_p]
            lib.paths_ply_load.restype = c.c_void_p
            lib.paths_ply_load.argtypes = [
                c.c_char_p, c.POINTER(c.c_int64), c.POINTER(c.c_int64),
                c.POINTER(c.c_int32),
            ]
            lib.paths_ply_data.restype = c.c_int
            lib.paths_ply_data.argtypes = [
                c.c_void_p, c.POINTER(c.c_double), c.POINTER(c.c_int64),
                c.POINTER(c.c_double),
            ]
            lib.paths_ply_free.restype = None
            lib.paths_ply_free.argtypes = [c.c_void_p]

            lib.paths_build_bvh.restype = ctypes.c_int
            lib.paths_build_bvh.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # tri_min
                ctypes.POINTER(ctypes.c_float),  # tri_max
                ctypes.c_int64,  # n
                ctypes.c_int32,  # leaf_size
                ctypes.POINTER(ctypes.c_float),  # node_min
                ctypes.POINTER(ctypes.c_float),  # node_max
                ctypes.POINTER(ctypes.c_int32),  # hit_link
                ctypes.POINTER(ctypes.c_int32),  # miss_link
                ctypes.POINTER(ctypes.c_int32),  # prim_start
                ctypes.POINTER(ctypes.c_int32),  # prim_count
                ctypes.POINTER(ctypes.c_int64),  # order
                ctypes.POINTER(ctypes.c_int64),  # n_nodes out
                ctypes.POINTER(ctypes.c_int32),  # depth out
            ]
            dp = c.POINTER(c.c_double)
            ip = c.POINTER(c.c_int32)
            bp = c.POINTER(c.c_uint8)
            fp = c.POINTER(c.c_float)
            lib.paths_cpu_render.restype = c.c_int
            lib.paths_cpu_render.argtypes = [
                c.c_int, c.c_int, c.c_int, c.c_uint64, c.c_int, c.c_int, dp,
                c.c_int, dp, dp, ip,                       # spheres
                c.c_int, dp, dp, dp, dp, dp, dp, ip, bp,   # triangles
                c.c_int, ip, dp, bp, dp, dp, dp, bp, dp,   # entities
                c.c_int, ip, dp, dp, dp, dp, ip,           # lights
                c.c_int, dp, dp, c.c_int, c.c_int, fp,     # sky
                dp,                                        # out
            ]
        except AttributeError:
            # A stale .so from an older build (e.g. make unavailable after
            # a pull that added symbols) is missing entry points: treat as
            # no native support rather than crashing callers that promise
            # graceful degradation.
            _build_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_bvh_native(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int):
    """Binned-SAH build in C++.  Returns the same tuple of arrays as the
    Python builder (node_min, node_max, hit_link, miss_link, prim_start,
    prim_count, order, n_nodes, depth) or None when the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(tri_min)
    tmin = np.ascontiguousarray(tri_min, np.float32)
    tmax = np.ascontiguousarray(tri_max, np.float32)
    cap = 2 * n + 2
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    hit_link = np.empty(cap, np.int32)
    miss_link = np.empty(cap, np.int32)
    prim_start = np.empty(cap, np.int32)
    prim_count = np.empty(cap, np.int32)
    order = np.empty(n, np.int64)
    n_nodes = ctypes.c_int64(0)
    depth = ctypes.c_int32(0)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lp = ctypes.POINTER(ctypes.c_int64)
    rc = lib.paths_build_bvh(
        tmin.ctypes.data_as(fp),
        tmax.ctypes.data_as(fp),
        n,
        leaf_size,
        node_min.ctypes.data_as(fp),
        node_max.ctypes.data_as(fp),
        hit_link.ctypes.data_as(ip),
        miss_link.ctypes.data_as(ip),
        prim_start.ctypes.data_as(ip),
        prim_count.ctypes.data_as(ip),
        order.ctypes.data_as(lp),
        ctypes.byref(n_nodes),
        ctypes.byref(depth),
    )
    if rc != 0:
        return None
    m = n_nodes.value
    return (
        node_min[:m].copy(),
        node_max[:m].copy(),
        hit_link[:m].copy(),
        miss_link[:m].copy(),
        prim_start[:m].copy(),
        prim_count[:m].copy(),
        order,
        m,
        depth.value,
    )


def load_obj_native(path: str):
    """Parse an OBJ via the native loader.  Returns a list of dicts
    (vertices (V,3) f64, faces (F,3) i64, texcoords (V,2) f64 | None,
    diffuse (3,) f64 | None) matching obj_loader.ObjModel field-for-field,
    or None when the library is unavailable or parsing fails."""
    lib = _load()
    if lib is None:
        return None
    n_models = ctypes.c_int64(0)
    h = lib.paths_obj_load(path.encode(), ctypes.byref(n_models))
    if not h:
        return None
    try:
        out = []
        dp = ctypes.POINTER(ctypes.c_double)
        lp = ctypes.POINTER(ctypes.c_int64)
        for i in range(n_models.value):
            nv = ctypes.c_int64(0)
            nf = ctypes.c_int64(0)
            has_uv = ctypes.c_int32(0)
            has_kd = ctypes.c_int32(0)
            if lib.paths_obj_model_info(h, i, ctypes.byref(nv), ctypes.byref(nf),
                                        ctypes.byref(has_uv), ctypes.byref(has_kd)):
                return None
            verts = np.empty((nv.value, 3), np.float64)
            faces = np.empty((nf.value, 3), np.int64)
            uvs = np.empty((nv.value, 2), np.float64) if has_uv.value else None
            kd = np.empty(3, np.float64) if has_kd.value else None
            rc = lib.paths_obj_model_data(
                h, i,
                verts.ctypes.data_as(dp),
                faces.ctypes.data_as(lp),
                uvs.ctypes.data_as(dp) if uvs is not None else None,
                kd.ctypes.data_as(dp) if kd is not None else None,
            )
            if rc:
                return None
            out.append(dict(vertices=verts, faces=faces, texcoords=uvs, diffuse=kd))
        return out
    finally:
        lib.paths_obj_free(h)


def load_ply_native(path: str):
    """Parse a PLY via the native loader.  Returns a dict (vertices (V,3)
    f64, faces (F,3) i64, vertex_colours (V,3) f64 | None) matching
    ply_loader.PlyModel, or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    nv = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    has_col = ctypes.c_int32(0)
    h = lib.paths_ply_load(path.encode(), ctypes.byref(nv), ctypes.byref(nf),
                           ctypes.byref(has_col))
    if not h:
        return None
    try:
        dp = ctypes.POINTER(ctypes.c_double)
        lp = ctypes.POINTER(ctypes.c_int64)
        verts = np.empty((nv.value, 3), np.float64)
        faces = np.empty((nf.value, 3), np.int64)
        cols = np.empty((nv.value, 3), np.float64) if has_col.value else None
        rc = lib.paths_ply_data(
            h,
            verts.ctypes.data_as(dp),
            faces.ctypes.data_as(lp),
            cols.ctypes.data_as(dp) if cols is not None else None,
        )
        if rc:
            return None
        return dict(vertices=verts, faces=faces, vertex_colours=cols)
    finally:
        lib.paths_ply_free(h)

def cpu_render(static, arrays, cam, width: int, height: int, spp: int,
               seed: int = 0, n_threads: int = 4, max_bounces: int = 10):
    """Render via the native CPU tracer (cpu_tracer.cc) -- the measured
    performance anchor and the independent oracle for cross-implementation
    golden tests.  Takes the same (static, arrays, cam) triple build_scene
    returns; converts device arrays to host f64.  Returns an (H, W, 3) f64
    linear-radiance image, or None when the library is unavailable or the
    scene uses materials the reference itself cannot BSDF-sample
    (/root/reference/src/material.rs:81-88)."""
    lib = _load()
    if lib is None:
        return None

    c = ctypes
    dp = c.POINTER(c.c_double)
    ip = c.POINTER(c.c_int32)
    bp = c.POINTER(c.c_uint8)
    fp = c.POINTER(c.c_float)

    def f64(a):
        return np.ascontiguousarray(np.asarray(a), np.float64)

    def i32(a):
        return np.ascontiguousarray(np.asarray(a), np.int32)

    def u8(a):
        return np.ascontiguousarray(np.asarray(a), np.uint8)

    # Camera: 17 doubles [loc3, rot9 row-major, f, v, aperture, sw, sh].
    cam17 = np.concatenate([
        f64(cam.location).ravel(), f64(cam.rot).ravel(),
        [float(cam.focal_length), float(cam.distance_from_lens),
         float(cam.aperture), float(cam.sensor_width),
         float(cam.sensor_height)],
    ]).astype(np.float64)

    n_sph = int(static.n_spheres)
    sph_c = f64(arrays.sph_center)[:n_sph] if n_sph else np.zeros((0, 3))
    sph_r = f64(arrays.sph_radius)[:n_sph] if n_sph else np.zeros(0)
    sph_e = i32(arrays.sph_ent)[:n_sph] if n_sph else np.zeros(0, np.int32)

    n_tri = int(static.n_tris)
    if n_tri:
        v0 = f64(arrays.tri_v0)[:n_tri]
        v1 = f64(arrays.tri_v1)[:n_tri]
        v2 = f64(arrays.tri_v2)[:n_tri]
        fn_ = f64(arrays.tri_n)[:n_tri]
        vn = np.concatenate(
            [f64(arrays.tri_vn0)[:n_tri], f64(arrays.tri_vn1)[:n_tri],
             f64(arrays.tri_vn2)[:n_tri]], axis=1)
        vc = np.concatenate(
            [f64(arrays.tri_vc0)[:n_tri], f64(arrays.tri_vc1)[:n_tri],
             f64(arrays.tri_vc2)[:n_tri]], axis=1)
        te = i32(arrays.tri_ent)[:n_tri]
        ts = u8(arrays.tri_smooth)[:n_tri]
    else:
        v0 = v1 = v2 = fn_ = np.zeros((0, 3))
        vn = vc = np.zeros((0, 9))
        te = np.zeros(0, np.int32)
        ts = np.zeros(0, np.uint8)

    mtype = i32(arrays.mat_mtype)
    n_ent = len(mtype)
    albedo = f64(arrays.mat_albedo)
    alb_v = u8(arrays.mat_albedo_vertex)
    emit = f64(arrays.mat_emit)
    r0 = f64(arrays.mat_r0)
    metal = f64(arrays.mat_metalness)
    is_light = u8(arrays.ent_is_light)
    emission = f64(arrays.ent_light_emission)

    n_lights = int(static.n_lights)
    ltype = i32(arrays.light_ltype)[:n_lights]
    lpos = f64(arrays.light_pos)[:n_lights]
    lrad = f64(arrays.light_radius)[:n_lights]
    lcol = f64(arrays.light_colour)[:n_lights]
    lint = f64(arrays.light_intensity)[:n_lights]
    lent = i32(arrays.light_ent)[:n_lights]

    sky_type = int(static.sky_type)
    sky_a = f64(arrays.sky.colour_a).ravel()
    sky_b = f64(arrays.sky.colour_b).ravel()
    sky_a = np.resize(sky_a, 3)
    sky_b = np.resize(sky_b, 3)
    img = np.ascontiguousarray(np.asarray(arrays.sky.image), np.float32)
    sky_h, sky_w = img.shape[0], img.shape[1]

    out = np.zeros((height, width, 3), np.float64)
    rc = lib.paths_cpu_render(
        width, height, spp, seed, n_threads, max_bounces,
        cam17.ctypes.data_as(dp),
        n_sph, sph_c.ctypes.data_as(dp), sph_r.ctypes.data_as(dp),
        sph_e.ctypes.data_as(ip),
        n_tri, v0.ctypes.data_as(dp), v1.ctypes.data_as(dp),
        v2.ctypes.data_as(dp), fn_.ctypes.data_as(dp),
        vn.ctypes.data_as(dp), vc.ctypes.data_as(dp),
        te.ctypes.data_as(ip), ts.ctypes.data_as(bp),
        n_ent, mtype.ctypes.data_as(ip), albedo.ctypes.data_as(dp),
        alb_v.ctypes.data_as(bp), emit.ctypes.data_as(dp),
        r0.ctypes.data_as(dp), metal.ctypes.data_as(dp),
        is_light.ctypes.data_as(bp), emission.ctypes.data_as(dp),
        n_lights, ltype.ctypes.data_as(ip), lpos.ctypes.data_as(dp),
        lrad.ctypes.data_as(dp), lcol.ctypes.data_as(dp),
        lint.ctypes.data_as(dp), lent.ctypes.data_as(ip),
        sky_type, sky_a.ctypes.data_as(dp), sky_b.ctypes.data_as(dp),
        sky_w, sky_h, img.ctypes.data_as(fp),
        out.ctypes.data_as(dp),
    )
    if rc != 0:
        return None
    return out
