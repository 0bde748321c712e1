"""Animated geometry with a per-frame BVH refit (BASELINE config 5), the
counterpart of the repository's ``examples/animated_refit.py``.

A red sphere orbits a mirror ball over the ground; each frame the `bvh`
engine's ``animate`` hook moves it and the engine refits the same tree
bottom-up (accel/refit.py) instead of rebuilding it.  Writes
animated_refit_f{N}.png into --out-dir.

Run:  python -m parallelraytracing_tpu_torch.examples.animated_refit --device cuda
      python -m parallelraytracing_tpu_torch.examples.animated_refit --device cpu --quick
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time

import numpy as np


def orbit(scene, frame: int):
    """Sphere 0 on a circle of radius 6 around the mirror ball, a twelfth
    of a turn a frame (a new SceneData; the other spheres unmoved)."""
    ang = frame * (2.0 * math.pi / 12.0)
    c = scene.sph_center.clone()
    c[0, 0] = 6.0 * math.cos(ang)
    c[0, 2] = -3.0 + 6.0 * math.sin(ang)
    return dataclasses.replace(scene, sph_center=c)


def build_scene():
    from parallelraytracing_tpu_torch import Scene
    scene = Scene(preset=None)
    red = scene.add_lambertian((0.9, 0.15, 0.1))
    scene.add_sphere(1.5, red, ((1, 1, 1), (0, 0, 0), (6, 1.5, 0)))
    mirror = scene.add_metal((0.9, 0.9, 0.9), 0.02)
    scene.add_sphere(2.0, mirror, ((1, 1, 1), (0, 0, 0), (0, 2, -3)))
    ground = scene.add_lambertian((0.55, 0.55, 0.55))
    scene.add_quad(60, 60, ground, None)
    light = scene.add_emissive((14, 14, 14))
    scene.add_sphere(1.5, light, ((1, 1, 1), (0, 0, 0), (-6, 10, 6)))
    return scene


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--quick", action="store_true",
                   help="64x40, 2 frames of 2 samples (a smoke test)")
    p.add_argument("--frames", type=int, default=6)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=200)
    p.add_argument("--out-dir", default="build/examples")
    args = p.parse_args(argv)
    if args.quick:
        args.width, args.height, args.frames, args.spp = 64, 40, 2, 2

    from parallelraytracing_tpu_torch import (Camera, Film, RenderConfig,
                                              create_renderer)
    cfg = RenderConfig(width=args.width, height=args.height, max_depth=6,
                       seed=0)
    eye = np.array([0.0, 8.0, 14.0])
    cam = Camera(eye, np.array([0.0, 1.5, -2.0]) - eye, float(args.width),
                 float(args.height), 100.0)
    os.makedirs(args.out_dir, exist_ok=True)
    scene = build_scene()
    r = create_renderer("bvh", args.device)
    r.animate = orbit
    for f in range(args.frames):
        film = Film(args.width, args.height, args.device)
        t0 = time.perf_counter()
        r.init(film, scene, cam, cfg)
        for _ in range(args.spp):  # accumulate spp samples at this pose
            r._frame_index = f
            r.progressive_render()
        img = film.hdr_average()
        if not bool(img.isfinite().all()) or float(img.max()) <= 0.0:
            raise RuntimeError(f"frame {f}: not finite or all black")
        path = os.path.join(args.out_dir, f"animated_refit_f{f}.png")
        film.save_png(path)
        print(f"frame {f}: sphere at angle {30 * f} deg, tree refit, "
              f"{args.spp} spp in {time.perf_counter() - t0:.2f} s -> {path}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
