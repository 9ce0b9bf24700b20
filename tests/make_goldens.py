"""Generate the committed golden renders for tests/test_golden.py.

Run from the repo root on the CPU backend (the platform the test suite
uses):

    python tests/make_goldens.py [name ...]

Goldens are small (72x48) low-spp renders with a reduced bounce budget --
enough to cover camera, traversal, materials, NEE, sky and RR end-to-end
while keeping test wall-clock sane.  They are self-consistent regression
anchors: a change to any part of the forward path that alters images will
move the MSE far beyond f32 reorder noise.  (Cross-renderer parity vs the
reference is visual, as the reference itself validates vs Mitsuba,
README.md:39 -- the Rust toolchain isn't available in this image to make
true reference goldens.)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses

import numpy as np

GOLDENS = {
    # name -> (scene path, spp, max_bounces, opts)
    # opts: env_nee=True  -> enable HDRI importance sampling
    #       mixed=True -> procedural mixed sphere+mesh+area-light scene
    "spheres_on_plane": ("/root/reference/scenes/spheres_on_plane.yml", 4, 5, {}),
    "bokeh_demo": ("/root/reference/scenes/bokeh_demo.yml", 4, 5, {}),
    "teapot": ("/root/reference/scenes/teapot.yml", 2, 4, {}),
    "bunny": ("/root/reference/scenes/bunny.yml", 2, 4, {}),
    "env_demo": ("scenes/env_demo.yml", 2, 4, {}),
    # CookTorrance + Fresnel coverage (material.rs:373-524): the two
    # NEE/eval-only reference materials previously appeared in no golden.
    "ct_demo": ("scenes/ct_demo.yml", 2, 4, {}),
    # environment.yml composition: triangles + HDRI, with and without env
    # importance sampling.
    "env_mesh_demo": ("scenes/env_mesh_demo.yml", 2, 4, {}),
    "env_mesh_demo_nee": ("scenes/env_mesh_demo.yml", 2, 4, {"env_nee": True}),
    # Spheres over every material class, a 128-triangle mesh and a sphere
    # light in one image.
    "mixed": (None, 2, 3, {"mixed": True}),
    # NB no stress-scene golden: the unrolled-sphere integrator takes XLA
    # ~15 min to compile on CPU at 64 spheres; the stress path is covered by
    # test_render_equiv / test_dist / chip_smoke.py instead.
}
SIZE = (72, 48)
SEED = 0


def render_golden(name, seed=SEED):
    from paths_tpu import camera as C
    from paths_tpu.render import render_image
    from paths_tpu.scene.build import build_scene
    from paths_tpu.scene.yaml_loader import load_scene_description
    from paths_tpu.scene.stress import generate_mixed_scene

    path, spp, max_bounces, opts = GOLDENS[name]
    here = os.path.dirname(os.path.abspath(__file__))
    if opts.get("mixed"):
        asset_dir = os.path.join(here, "goldens", "assets")
        os.makedirs(asset_dir, exist_ok=True)
        sd = generate_mixed_scene(asset_dir)
    else:
        if not os.path.isabs(path):
            path = os.path.join(os.path.dirname(here), path)
        sd = load_scene_description(path)

    static, scene, cam = build_scene(sd)
    static = dataclasses.replace(
        static, max_bounces=max_bounces, env_nee=bool(opts.get("env_nee"))
    )
    W, H = SIZE
    cam = C.resize(cam, W, H)
    img = render_image(static, scene, cam, W, H, spp=spp, seed=seed)
    return np.asarray(img, np.float32)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
    os.makedirs(out_dir, exist_ok=True)
    for name in sys.argv[1:] or GOLDENS:
        img = render_golden(name)
        assert np.isfinite(img).all(), name
        np.savez_compressed(os.path.join(out_dir, f"{name}.npz"), img=img)
        print(f"wrote {name}.npz  mean={img.mean():.5f} max={img.max():.3f}")


if __name__ == "__main__":
    main()
