"""Command-line renderer.

The batch-mode equivalent of the reference's app shell (src/main.rs:39-186):
arg 1 = YAML scene (or the built-in stress scene when omitted, main.rs:43-50),
renders progressively and writes a PNG instead of blitting to SDL.

Usage:
  python -m paths_tpu.cli [scene.yml] [-o out.png] [--spp N] [--size WxH]
                          [--seed N] [--tile N] [--stress N]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="paths-tpu renderer")
    ap.add_argument("scene", nargs="?", default=None, help="YAML scene file")
    ap.add_argument("-o", "--output", default="out.png")
    ap.add_argument("--spp", type=int, default=16, help="samples per pixel")
    ap.add_argument("--size", default=None, help="override WxH (e.g. 360x240)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tile", type=int, default=65536, help="pixels per wave")
    ap.add_argument("--stress", type=int, default=500,
                    help="stress-scene sphere count when no scene given")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU backend")
    ap.add_argument("--native-cpu", action="store_true",
                    help="render with the native C++ CPU tracer "
                         "(multithreaded, reference-equivalent algorithm; "
                         "no JAX in the hot path)")
    ap.add_argument("--threads", type=int, default=4,
                    help="worker threads for --native-cpu")
    ap.add_argument("--dp", default=None, metavar="N|all",
                    help="shard pixel lanes over N devices (or every visible "
                         "device with 'all'); scene stays replicated, "
                         "accumulation stays device-resident per chip")
    ap.add_argument("--multihost", action="store_true",
                    help="join the jax.distributed runtime first (multi-host "
                         "clusters JAX can auto-detect)")
    ap.add_argument("--env-nee", action="store_true",
                    help="importance-sample the HDRI skybox as a light "
                         "(lower variance for sun-like environments)")
    ap.add_argument("--max-bounces", type=int, default=10)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file; resumed from if it exists, "
                         "written every --checkpoint-every samples")
    ap.add_argument("--checkpoint-every", type=int, default=32,
                    help="samples between checkpoint writes")
    ap.add_argument("--check", action="store_true",
                    help="validate the rendered radiance (NaN/inf/negative "
                         "energy, the Colour::check() analogue) and fail on "
                         "violations")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="capture a jax.profiler device trace to LOGDIR")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from paths_tpu.platform import enable_compile_cache

    enable_compile_cache()

    if args.multihost:
        from paths_tpu.dist import init_multihost

        init_multihost()

    # After init_multihost: querying the backend initialises it.
    if not (args.cpu or args.native_cpu) and jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU found (JAX backend {jax.default_backend()!r}); "
                         "pass --cpu to render on the CPU")

    mesh = None
    if args.dp:
        from paths_tpu.dist import make_mesh

        devs = jax.devices()
        if args.dp != "all":
            n = int(args.dp)
            if n > len(devs):
                raise SystemExit(f"--dp {n}: only {len(devs)} devices visible")
            devs = devs[:n]
        mesh = make_mesh(devs)
        print(f"dp mesh over {len(devs)} device(s): "
              f"{[str(d) for d in mesh.devices.flat]}")

    from paths_tpu.scene.build import build_scene
    from paths_tpu.scene.yaml_loader import load_scene_description
    from paths_tpu.render import render_image, write_png
    from paths_tpu import camera as C

    t0 = time.time()
    if args.scene:
        sd = load_scene_description(args.scene)
    else:
        from paths_tpu.scene.stress import generate_stress_scene

        print(f"No scene given; using {args.stress}-sphere stress scene")
        sd = generate_stress_scene(args.stress)

    static, scene, cam = build_scene(sd)
    if args.env_nee or args.max_bounces != 10:
        import dataclasses

        static = dataclasses.replace(
            static, env_nee=args.env_nee, max_bounces=args.max_bounces
        )
    width, height = sd.camera.image_width, sd.camera.image_height
    if args.size:
        width, height = (int(v) for v in args.size.lower().split("x"))
        cam = C.resize(cam, width, height)
    print(
        f"[{time.time()-t0:6.2f}s] scene built: {static.n_spheres} spheres, "
        f"{static.n_tris} tris, {static.n_lights} lights"
    )

    est = None
    start_sample = 0
    on_batch = None
    if args.checkpoint:
        import os

        from paths_tpu.checkpoint import load_checkpoint, save_checkpoint

        if os.path.exists(args.checkpoint):
            est, start_sample, ck_seed = load_checkpoint(args.checkpoint)
            if ck_seed != args.seed or est.width != width or est.height != height:
                raise SystemExit(
                    f"checkpoint {args.checkpoint} was taken with different "
                    f"render settings (seed {ck_seed}, {est.width}x{est.height})"
                )
            print(f"resumed {args.checkpoint} at sample {start_sample}")

        last_saved = [start_sample]

        def on_batch(e, next_sample):
            if next_sample - last_saved[0] >= args.checkpoint_every or next_sample >= args.spp:
                save_checkpoint(args.checkpoint, e, next_sample, args.seed)
                last_saved[0] = next_sample
                print(f"[ckpt] saved at sample {next_sample}")

    if args.native_cpu:
        from paths_tpu import native

        if args.env_nee:
            raise SystemExit("--env-nee is JAX-path only (not in --native-cpu)")
        # The native tracer renders from scratch in one shot: flags that
        # configure the JAX pipeline would be silently ignored -- refuse
        # rather than lie (e.g. printing 'resumed' then starting over).
        for flag, name in ((args.checkpoint, "--checkpoint"),
                           (args.profile, "--profile"),
                           (args.dp, "--dp"),
                           (args.check, "--check")):
            if flag:
                raise SystemExit(f"{name} is not supported with --native-cpu")
        img = native.cpu_render(
            static, scene, cam, width, height, args.spp, seed=args.seed,
            n_threads=args.threads, max_bounces=args.max_bounces,
        )
        if img is None:
            raise SystemExit(
                "--native-cpu unavailable (library failed to build, or the "
                "scene uses materials the reference cannot BSDF-sample)"
            )
        elapsed = time.time() - t0
        rays = width * height * args.spp
        print(f"[{elapsed:6.2f}s] native-cpu rendered {width}x{height} @ "
              f"{args.spp}spp ({rays/elapsed/1e6:.2f} M pixel-samples/s)")
        write_png(args.output, img)
        print(f"wrote {args.output}")
        return

    import contextlib

    prof = contextlib.nullcontext()
    if args.profile:
        from paths_tpu.profiling import trace

        prof = trace(args.profile)
    with prof:
        img = render_image(
            static, scene, cam, width, height,
            spp=args.spp, seed=args.seed, tile_pixels=args.tile, progress=True,
            est=est, start_sample=start_sample, on_batch=on_batch,
            mesh=mesh,
        )
    elapsed = time.time() - t0
    rays = width * height * args.spp
    print(
        f"[{elapsed:6.2f}s] rendered {width}x{height} @ {args.spp}spp "
        f"({rays/elapsed/1e6:.2f} Mprimary-rays/s incl. compile)"
    )
    write_png(args.output, img)
    print(f"wrote {args.output}")
    if args.check:
        from paths_tpu.debug import validate_radiance

        rep = validate_radiance(img.reshape(-1, 3), strict=False)
        print(f"[check] {rep}")
        if not rep.ok:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
