"""Command-line renderer of the port.

Renders N progressive frames of a preset scene, or of a PLY mesh in the
JAX package's showcase scene, and writes a PNG (plus optional linear PFM
and film checkpoint).  ``--engine auto`` picks wavefront_fused for a scene
of more than 512 triangles and fused otherwise, as the JAX CLI does on a
TPU.

Usage:
    python -m parallelraytracing_tpu_torch.cli --scene random_balls_large \
        --width 1920 --height 1080 --frames 16 --out balls.png
    python -m parallelraytracing_tpu_torch.cli --ply mesh.ply --frames 16
    python -m parallelraytracing_tpu_torch.cli --scene cornell --nee \
        --rr-depth 3 --frames 16 --out cornell.png
    python -m parallelraytracing_tpu_torch.cli --scene texture_demo \
        --lens-radius 0.1 --focus-distance 10 --qmc --frames 16
    python -m parallelraytracing_tpu_torch.cli --device cpu --scene cornell \
        --width 64 --height 64 --frames 4
"""

from __future__ import annotations

import argparse
import sys
import time

#: engines of this port; "auto" picks by the scene's triangle count
ENGINE_CHOICES = ("auto", "fused", "wavefront_fused", "tlas")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parallelraytracing_tpu_torch",
        description="progressive Monte Carlo path tracer (PyTorch/CUDA port)")
    p.add_argument("--scene", default="random_balls_large",
                   help="preset name (default, light_test, material_test, "
                        "cornell, random_balls_{small,medium,large}, or the "
                        "extension demos: texture_demo (checker floor, "
                        "image-textured quad and sphere; pairs well with "
                        "--lens-radius), sky_demo (gradient + sun sky))")
    p.add_argument("--ply", default=None,
                   help="render a PLY mesh (the showcase scene) instead of "
                        "a preset")
    p.add_argument("--engine", default="auto",
                   help="auto (wavefront_fused above 512 triangles, else "
                        "fused, as the JAX CLI picks) | fused | "
                        "wavefront_fused | tlas (the fused engine, named "
                        "for instanced scenes).  On an H100 wavefront_fused is "
                        "the slower engine on meshes: its default schedule "
                        "is the TPU's, not yet re-tuned for the GPU")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernel path) or cpu (the "
                        "plain PyTorch version, slow)")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--frames", type=int, default=16,
                   help="progressive frames (1 spp each by default)")
    p.add_argument("--spp", type=int, default=1,
                   help="samples per pixel per frame")
    p.add_argument("--depth", type=int, default=20, help="max path depth")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-jitter", action="store_true",
                   help="sample pixel centers (reference CPU/CUDA behavior)")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation: sample emissive lights "
                        "directly at diffuse hits (in-kernel in fused and "
                        "wavefront_fused; much lower variance on "
                        "emissive-lit scenes)")
    p.add_argument("--lens-radius", type=float, default=0.0,
                   help="thin-lens aperture radius in world units (0 = "
                        "pinhole, the reference's camera): defocus blur")
    p.add_argument("--focus-distance", type=float, default=10.0,
                   help="focal-plane distance along the view direction "
                        "(with --lens-radius > 0)")
    p.add_argument("--qmc", action="store_true",
                   help="QMC camera sampling: jitter and aperture draws "
                        "rotate a shared Halton point per pixel instead of "
                        "independent uniforms")
    p.add_argument("--rr-depth", type=int, default=0, metavar="D",
                   help="Russian roulette: stochastically terminate "
                        "low-throughput paths after D bounces, unbiased "
                        "(0 = off, the reference's fixed depth budget; "
                        "listed as future work in its wavefront.md)")
    p.add_argument("--clamp", type=float, default=0.0, metavar="C",
                   help="firefly clamp: cap per-sample radiance at C "
                        "before accumulation (0 = off; biased but kills "
                        "outlier speckle — reference wavefront.md future "
                        "work)")
    p.add_argument("--eye", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--look-at", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=2.2)
    p.add_argument("--out", default="render.png")
    p.add_argument("--hdr-out", default=None, metavar="PATH.pfm",
                   help="also write the linear HDR average as a PFM")
    p.add_argument("--checkpoint", default=None,
                   help="save film state here after rendering")
    p.add_argument("--resume", default=None,
                   help="load film state and continue accumulating")
    p.add_argument("--stats", action="store_true",
                   help="print the time of each frame")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.engine not in ENGINE_CHOICES:
        raise ValueError(f"engine {args.engine!r} is not in this port; "
                         f"it has: {', '.join(ENGINE_CHOICES)}")

    import numpy as np
    import torch

    from parallelraytracing_tpu_torch import (Camera, Film, RenderConfig, Scene,
                                              ScenePreset, create_renderer)
    from parallelraytracing_tpu_torch.engines.wavefront_fused import (
        TRI_HEAVY, scene_triangles)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but CUDA is not available "
                           "(use --device cpu for the plain PyTorch path)")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, samples_per_frame=args.spp,
                       jitter=not args.no_jitter, seed=args.seed,
                       nee=args.nee, lens_radius=args.lens_radius,
                       focus_distance=args.focus_distance, qmc=args.qmc,
                       russian_roulette_depth=args.rr_depth,
                       firefly_clamp=args.clamp)
    if args.ply:
        from parallelraytracing_tpu_torch.core.scene import ply_showcase_scene
        scene, default_eye, default_look = ply_showcase_scene(args.ply)
    else:
        scene = Scene(ScenePreset(args.scene))
        default_eye = (5.0, 5.0, 8.0)  # the reference's startup camera
        default_look = (0.0, 0.0, 0.0)
    engine = args.engine
    if engine == "auto":
        engine = ("wavefront_fused" if scene_triangles(scene) > TRI_HEAVY
                  else "fused")
    eye = np.asarray(args.eye if args.eye is not None else default_eye,
                     np.float64)
    look = np.asarray(args.look_at if args.look_at is not None
                      else default_look, np.float64)
    cam = Camera(eye, look - eye, float(args.width), float(args.height), 100.0)

    if args.resume:
        film, start_frame = Film.load_checkpoint(args.resume, device)
        if (film.width, film.height) != (args.width, args.height):
            raise ValueError("checkpoint resolution mismatch")
        print(f"resumed from {args.resume} at frame {start_frame} "
              f"({film.sample_count} samples)")
    else:
        film = Film(args.width, args.height, device)
        start_frame = 0

    renderer = create_renderer(engine, device)
    renderer.init(film, scene, cam, cfg)
    renderer._frame_index = start_frame
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"scene={args.ply or args.scene} engine={engine} "
          f"{args.width}x{args.height} depth={cfg.max_depth} "
          f"nee={renderer._tables.nee} rr_depth={cfg.russian_roulette_depth} "
          f"prims={scene.num_primitives} "
          f"device={device} ({name})")

    t_all = time.perf_counter()
    for i in range(args.frames):
        t0 = time.perf_counter()
        renderer.progressive_render()
        sync()
        if args.stats:
            dt = time.perf_counter() - t0
            print(f"frame {start_frame + i:4d}  render {dt * 1e3:8.1f} ms")
    total = time.perf_counter() - t_all
    print(f"{args.frames} frames in {total:.2f}s "
          f"({args.frames / total:.2f} fps, "
          f"{film.sample_count} samples accumulated)")

    film.save_png(args.out, args.exposure, args.gamma)
    print(f"wrote {args.out}")
    if args.hdr_out:
        film.save_pfm(args.hdr_out)
        print(f"wrote linear HDR {args.hdr_out}")
    if args.checkpoint:
        film.save_checkpoint(args.checkpoint,
                             frame_index=start_frame + args.frames)
        print(f"checkpointed film to {args.checkpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
