"""Triangle traversal on the GPU: the BVH walk kernel against plain XLA.

Two comparisons, both on the card, both paths in one process:

  kernel only   ops/bvh_walk.py (at several block sizes) against what XLA
                makes of the plain version -- bvh/traverse.closest_hit_bvh,
                with occlusion derived from the closest hit -- on the
                dragon's full 720x480 camera wave, one bounce wave, and the
                shadow wave toward its light;
  end to end    render_image at 720x480 on dragon_standin (200k triangles),
                doom_standin (96k), env_mesh_demo (6.4k; plain XLA scans it
                brute force below bvh_threshold) and the 500-sphere stress
                scene (no triangles: both paths are the same program).

Timings are medians of alternating repetitions (kernel, XLA, XLA, kernel,
...) after one warm-up call that compiles; compile time is reported apart.
Prints one line per measurement and writes everything, with the card's
name and power limit, to chiprun_out/bench_traverse.json.

Usage: python benchmarks/bench_traverse.py [--reps N] [--quick]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
W, H = 720, 480


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def timed_pair(fns, reps):
    """fns: {name: zero-arg callable that blocks}.  One warm-up each (the
    compile), then reps rounds alternating the order.  Returns
    {name: {"compile_s", "median_s", "min_s", "max_s", "runs"}}."""
    out = {}
    for name, fn in fns.items():
        t0 = time.perf_counter()
        fn()
        out[name] = {"compile_s": time.perf_counter() - t0, "runs": []}
    names = list(fns)
    for r in range(reps):
        for name in names if r % 2 == 0 else names[::-1]:
            t0 = time.perf_counter()
            fns[name]()
            out[name]["runs"].append(time.perf_counter() - t0)
    for rec in out.values():
        rec.update(median_s=statistics.median(rec["runs"]),
                   min_s=min(rec["runs"]), max_s=max(rec["runs"]))
    return out


def xla_static(static):
    """The plain-XLA choice build_scene makes on the CPU."""
    from paths_tpu.scene.build import BVH_THRESHOLD

    return dataclasses.replace(static, bvh_kernel=False,
                               use_bvh=static.n_tris > BVH_THRESHOLD)


def kernel_only(reps, blocks):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from paths_tpu import camera as C
    from paths_tpu import integrator as I
    from paths_tpu.bvh.check import _reference_walk
    from paths_tpu.ops import bvh_walk
    from paths_tpu.render import gen_camera_rays, tiled_pixel_order
    from paths_tpu.sampling import hashing as HS
    from paths_tpu.scene.build import build_scene
    from paths_tpu.scene.yaml_loader import load_scene_description

    static, scene, cam = build_scene(load_scene_description(
        os.path.join(REPO, "scenes", "dragon_standin.yml")))
    cam = C.resize(cam, W, H)
    pix = tiled_pixel_order(W, H)
    px = jnp.asarray((pix % W).astype(np.int32))
    py = jnp.asarray((pix // W).astype(np.int32))
    pid = jnp.asarray(pix)
    sid = jnp.zeros(len(pix), jnp.uint32)
    n = len(pix)
    o, d, _ = gen_camera_rays(cam, px, py, pid, sid, jnp.uint32(0))

    @jax.jit
    def next_waves(o, d):
        u = lambda b, dim: HS.uniform(jnp.uint32(0), pid, sid,
                                      jnp.uint32(b * HS.DIMS_PER_BOUNCE + dim))
        hit = I.intersect_full(static, scene, o, d,
                               jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32))
        st = I.path_step(static, scene, 0, I.fresh_path_state(o, d), u)
        excl = jnp.where(st[6] == I.KIND_TRI, st[7], -1)
        bounce = (jnp.where(st[4][:, None], st[0], 1e30), st[1], excl)
        # Shadow rays from the camera hits toward the sphere light.
        light = scene.light_pos[0]
        p = hit["location"] + hit["normal"] * I.SHADOW_EPS
        to_l = light - p
        dist = jnp.linalg.norm(to_l, axis=-1)
        s_o = jnp.where(hit["found"][:, None], p, 1e30)
        s_excl = jnp.where(hit["kind"] == I.KIND_TRI, hit["idx"], -1)
        shadow = (s_o, to_l / dist[:, None], s_excl,
                  dist - scene.light_radius[0])
        return bounce, shadow

    (bo, bd, bexcl), (so, sd, sexcl, smax) = next_waves(o, d)
    big = jnp.full(n, I.BIG)
    none = jnp.full(n, -1, jnp.int32)
    tris = (scene.bvh, scene.tri_v0, scene.tri_v1, scene.tri_v2, scene.tri_n)

    def block(x):
        jax.block_until_ready(x)

    results = {}
    waves = {"camera": (o, d, none, big), "bounce": (bo, bd, bexcl, big)}
    for wave, (wo, wd, we, wt) in waves.items():
        kind = jnp.where(we >= 0, 2, 0)
        fns = {f"kernel_b{b}": (lambda b=b: block(bvh_walk.closest_hit(
            scene.walk, wo, wd, we, wt, block=b))) for b in blocks}
        fns["xla"] = lambda: block(_reference_walk(*tris, wo, wd, kind, we, wt))
        results[f"closest_{wave}"] = timed_pair(fns, reps)
    kind = jnp.where(sexcl >= 0, 2, 0)

    @jax.jit
    def xla_occluded(so, sd, kind, sexcl, smax):
        t, i = _reference_walk(*tris, so, sd, kind, sexcl, smax)
        return t < I.BIG

    fns = {f"kernel_b{b}": (lambda b=b: block(bvh_walk.occluded(
        scene.walk, so, sd, sexcl, none, smax, block=b))) for b in blocks}
    fns["xla"] = lambda: block(xla_occluded(so, sd, kind, sexcl, smax))
    results["anyhit_shadow"] = timed_pair(fns, reps)
    occ_k = np.asarray(bvh_walk.occluded(scene.walk, so, sd, sexcl, none, smax))
    occ_x = np.asarray(xla_occluded(so, sd, kind, sexcl, smax))
    results["anyhit_shadow_agree"] = float((occ_k == occ_x).mean())
    results["live_lanes"] = {
        "camera": n, "bounce": int((np.abs(np.asarray(bo)).max(1) < 1e29).sum()),
        "shadow": int((np.abs(np.asarray(so)).max(1) < 1e29).sum())}
    return results


def end_to_end(reps, quick):
    from paths_tpu import camera as C
    from paths_tpu.render import render_image
    from paths_tpu.scene.build import build_scene
    from paths_tpu.scene.stress import generate_stress_scene
    from paths_tpu.scene.yaml_loader import load_scene_description

    cells = [("dragon_standin", 4), ("doom_standin", 4), ("env_mesh_demo", 4),
             ("stress500", 8)]
    if quick:
        cells = cells[:1]
    results = {}
    for name, spp in cells:
        if name == "stress500":
            sd = generate_stress_scene(500, seed=0)
        else:
            sd = load_scene_description(os.path.join(REPO, "scenes", f"{name}.yml"))
        static, scene, cam = build_scene(sd)
        cam = C.resize(cam, W, H)
        variants = {"kernel": static, "xla": xla_static(static)}
        fns = {k: (lambda st=st: render_image(st, scene, cam, W, H, spp=spp))
               for k, st in variants.items()}
        rec = timed_pair(fns, reps)
        for v in rec.values():
            v["pixel_samples_per_s"] = W * H * spp / v["median_s"]
        results[f"{name}_{spp}spp"] = rec
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--quick", action="store_true",
                    help="dragon only, for a first compile-and-check call")
    ap.add_argument("--blocks", default="32,64,128")
    args = ap.parse_args()

    import jax

    from paths_tpu.platform import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_traverse measures the GPU; found {dev.platform}")
    enable_compile_cache()
    blocks = [int(b) for b in args.blocks.split(",")]
    rec = {"card": card_line(), "device_kind": dev.device_kind,
           "jax": jax.__version__}
    print(rec, flush=True)
    rec["kernel_only"] = kernel_only(args.reps * 2, blocks)
    for k, v in rec["kernel_only"].items():
        if isinstance(v, dict) and "xla" in v:
            print(k, {n: f"{r['median_s'] * 1e3:.3f} ms (compile {r['compile_s']:.1f}s)"
                      for n, r in v.items()}, flush=True)
        else:
            print(k, v, flush=True)
    rec["end_to_end"] = end_to_end(args.reps, args.quick)
    for k, v in rec["end_to_end"].items():
        print(k, {n: f"{r['median_s']:.3f} s [{r['min_s']:.3f}, {r['max_s']:.3f}] "
                     f"{r['pixel_samples_per_s']:.4g} px-samples/s "
                     f"(compile+first {r['compile_s']:.1f}s)"
                  for n, r in v.items()}, flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "bench_traverse.json"), "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
