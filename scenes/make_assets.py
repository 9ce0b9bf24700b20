"""Generate the procedural assets used by the bundled demo scenes.

The reference's environment.yml points at HDRIs/meshes it does not bundle
(/root/reference/scenes/environment.yml:13-14), so the demo scenes here use
reproducible procedural stand-ins.

NB the renderer evaluates the skybox at the *negated* ray direction
(trace.rs:21: ambient_light(ray.direction * -1)), so a map authored
"physically" (ground in the low-latitude rows) must be flipped vertically
and the sun azimuth shifted by half the width to appear where intended.
This generator bakes that flip in.

Usage: python scenes/make_assets.py
"""

import os

import numpy as np


def make_sunrise(h=128, w=256):
    lat = np.pi * (1.0 - (np.arange(h)[:, None] + 0.5) / h)
    cos_up = np.cos(lat)  # -1 at row 0 .. +1 at row h-1 (map convention)
    sky_t = np.clip((cos_up + 1) / 2, 0, 1)
    horizon = np.array([1.0, 0.45, 0.2])
    zenith = np.array([0.15, 0.35, 0.8])
    ground = np.array([0.08, 0.07, 0.06])
    img = np.where(
        cos_up[..., None] > 0,
        horizon * (1 - sky_t[..., None]) * 2 + zenith * sky_t[..., None],
        ground * (0.3 + 0.7 * (1 + cos_up[..., None])),
    )
    img = np.broadcast_to(img, (h, w, 3)).copy()
    # Flip so rays pointing up (looked up at -d) see the sky half, and place
    # the sun where a camera looking +z sees it slightly right of centre.
    img = img[::-1].copy()
    sun_y, sun_x = int(h * 0.42), int(w * 0.30)
    yy, xx = np.mgrid[0:h, 0:w]
    d2 = ((yy - sun_y) / 2.0) ** 2 + ((xx - sun_x) / 2.0) ** 2
    img[d2 < 4] = [800.0, 700.0, 500.0]
    img[(d2 >= 4) & (d2 < 16)] += np.array([20.0, 12.0, 5.0])
    return img.astype(np.float32)


def write_ply_binary(path, vertices, faces, colours=None):
    """Binary little-endian PLY with optional uchar vertex colours (the
    format the reference's unbundled dragon/doom assets use, ply.rs:59-71)."""
    V = np.asarray(vertices, np.float32)
    F = np.asarray(faces, np.int32)
    lines = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {len(V)}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if colours is not None:
        lines += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    lines += [
        f"element face {len(F)}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    if colours is not None:
        vdt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
        vrec = np.empty(len(V), vdt)
        vrec["xyz"] = V
        vrec["rgb"] = np.clip(np.asarray(colours) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    else:
        vdt = np.dtype([("xyz", "<f4", 3)])
        vrec = np.empty(len(V), vdt)
        vrec["xyz"] = V
    fdt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
    frec = np.empty(len(F), fdt)
    frec["n"] = 3
    frec["idx"] = F
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        f.write(vrec.tobytes())
        f.write(frec.tobytes())


def _grid_faces(n_u, n_v, wrap_u=False, wrap_v=False):
    """Triangulate an (n_u, n_v) vertex grid; returns (F, 3) int32."""
    iu = np.arange(n_u if wrap_u else n_u - 1)
    iv = np.arange(n_v if wrap_v else n_v - 1)
    U, Vv = np.meshgrid(iu, iv, indexing="ij")
    u1 = (U + 1) % n_u if wrap_u else U + 1
    v1 = (Vv + 1) % n_v if wrap_v else Vv + 1
    a = U * n_v + Vv
    b = u1 * n_v + Vv
    c = U * n_v + v1
    d = u1 * n_v + v1
    f1 = np.stack([a.ravel(), b.ravel(), c.ravel()], -1)
    f2 = np.stack([c.ravel(), b.ravel(), d.ravel()], -1)
    return np.concatenate([f1, f2]).astype(np.int32)


def make_dragon_standin(n_t=500, n_s=200, seed=0):
    """Dragon stand-in: a displaced trefoil-knot tube, ~200k triangles.

    The reference's dragon.yml points at the (unbundled) Stanford dragon
    (/root/reference/scenes/dragon.yml); this is a reproducible procedural
    mesh of comparable size/locality for exercising the HBM-scale traversal
    path."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, n_t, endpoint=False)
    # Trefoil centreline.
    cx = np.sin(t) + 2 * np.sin(2 * t)
    cy = np.cos(t) - 2 * np.cos(2 * t)
    cz = -np.sin(3 * t)
    C = np.stack([cx, cy, cz], -1)
    # Tangent + stable normal/binormal frame.
    T = np.roll(C, -1, 0) - np.roll(C, 1, 0)
    T /= np.linalg.norm(T, axis=1, keepdims=True)
    ref = np.array([0.31, 0.52, 0.8])
    Nf = np.cross(T, ref)
    Nf /= np.linalg.norm(Nf, axis=1, keepdims=True)
    B = np.cross(T, Nf)
    s = np.linspace(0, 2 * np.pi, n_s, endpoint=False)
    # Bumpy, tapering tube radius (scale-like displacement).
    base = 0.55 + 0.18 * np.sin(7 * t)[:, None]
    bump = (
        0.08 * np.sin(11 * s)[None, :] * np.cos(17 * t)[:, None]
        + 0.05 * np.sin(23 * s[None, :] + 13 * t[:, None])
    )
    r = base + bump
    P = (
        C[:, None, :]
        + r[..., None] * (np.cos(s)[None, :, None] * Nf[:, None, :]
                          + np.sin(s)[None, :, None] * B[:, None, :])
    )
    V = P.reshape(-1, 3)
    F = _grid_faces(n_t, n_s, wrap_u=True, wrap_v=True)
    return V.astype(np.float32), F


def make_doom_standin(n=220, seed=3):
    """Doom stand-in: a vertex-coloured terrain arena, ~96k triangles.

    The reference's doom.yml uses an unbundled vertex-coloured PLY scan
    (albedo {type: Vertex}, /root/reference/scenes/doom.yml:39); this
    procedural ruin exercises the same vertex-colour shading path at scale."""
    rng = np.random.default_rng(seed)
    # Multi-octave value noise heightfield.
    h = np.zeros((n, n))
    for octave in range(1, 6):
        k = 2 ** octave + 1
        g = rng.normal(size=(k, k))
        yi = np.linspace(0, k - 1, n)
        xi = np.linspace(0, k - 1, n)
        y0 = np.clip(yi.astype(int), 0, k - 2)
        x0 = np.clip(xi.astype(int), 0, k - 2)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        h += (
            g[y0][:, x0] * (1 - fy) * (1 - fx)
            + g[y0 + 1][:, x0] * fy * (1 - fx)
            + g[y0][:, x0 + 1] * (1 - fy) * fx
            + g[y0 + 1][:, x0 + 1] * fy * fx
        ) * (90.0 / 2 ** octave)
    # Central crater arena.
    yy, xx = np.mgrid[0:n, 0:n] / (n - 1) * 2 - 1
    rr = np.sqrt(xx ** 2 + yy ** 2)
    h = h * np.clip(rr * 1.5, 0.3, 1.0) - 120 * np.exp(-(rr * 2.2) ** 2)
    X = xx * 600.0
    Z = yy * 600.0
    V = np.stack([X.ravel(), h.ravel(), Z.ravel()], -1)
    # Height/slope-based colours: lava in the crater, rock, ash highlands.
    gy, gx = np.gradient(h)
    slope = np.sqrt(gx ** 2 + gy ** 2)
    hn = (h - h.min()) / (h.max() - h.min())
    lava = np.array([0.9, 0.25, 0.05])
    rock = np.array([0.45, 0.38, 0.33])
    ash = np.array([0.65, 0.62, 0.6])
    c = np.where(
        (hn < 0.18)[..., None], lava,
        np.where((slope > 6.0)[..., None], rock, ash),
    )
    c = c * (0.7 + 0.3 * hn[..., None])
    F = _grid_faces(n, n)
    return V.astype(np.float32), F, c.reshape(-1, 3)


def make_teapot_standin(n_u=80, n_v=41):
    """Teapot stand-in: a closed-ish bulging lathe body, ~6.4k triangles.

    The reference's teapot (environment.yml, teapot.yml) is an unbundled
    ~6.3k-face OBJ; this surface of revolution has the same face count
    class, smooth curvature and size (about 3 units across)."""
    t = np.linspace(0.03, 0.97, n_v)
    y = 1.6 * t
    r = 1.5 * np.sin(np.pi * t) ** 0.8 * (1.0 + 0.08 * np.cos(3 * np.pi * t))
    a = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    P = np.stack([
        r[None, :] * np.cos(a)[:, None],
        np.broadcast_to(y[None, :], (n_u, n_v)),
        r[None, :] * np.sin(a)[:, None],
    ], -1)
    V = P.reshape(-1, 3)
    F = _grid_faces(n_u, n_v, wrap_u=True)
    return V.astype(np.float32), F


def main():
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    from paths_tpu.scene.hdr_loader import write_hdr
    assets = os.path.join(here, "assets")
    os.makedirs(assets, exist_ok=True)

    out = os.path.join(assets, "sunrise.hdr")
    write_hdr(out, make_sunrise())
    print(f"wrote {out}")

    V, F = make_dragon_standin()
    out = os.path.join(assets, "dragon_standin.ply")
    write_ply_binary(out, V, F)
    print(f"wrote {out}: {len(V)} verts, {len(F)} tris")

    V, F = make_teapot_standin()
    out = os.path.join(assets, "teapot_standin.ply")
    write_ply_binary(out, V, F)
    print(f"wrote {out}: {len(V)} verts, {len(F)} tris")

    V, F, C = make_doom_standin()
    out = os.path.join(assets, "doom_standin.ply")
    write_ply_binary(out, V, F, colours=C)
    print(f"wrote {out}: {len(V)} verts, {len(F)} tris, vertex colours")


if __name__ == "__main__":
    main()
