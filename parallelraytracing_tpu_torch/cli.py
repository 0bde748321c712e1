"""Command-line renderer of the port.

Renders N progressive frames of a preset scene with the fused engine and
writes a PNG (plus optional linear PFM and film checkpoint).

Usage:
    python -m parallelraytracing_tpu_torch.cli --scene random_balls_large \
        --width 1920 --height 1080 --frames 16 --out balls.png
    python -m parallelraytracing_tpu_torch.cli --device cpu --scene cornell \
        --width 64 --height 64 --frames 4
"""

from __future__ import annotations

import argparse
import sys
import time

#: engines of this port; "auto" picks fused
ENGINE_CHOICES = ("auto", "fused")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parallelraytracing_tpu_torch",
        description="progressive Monte Carlo path tracer (PyTorch/CUDA port)")
    p.add_argument("--scene", default="random_balls_large",
                   help="preset name (default, light_test, material_test, "
                        "cornell, random_balls_{small,medium,large})")
    p.add_argument("--engine", default="auto",
                   help="auto | fused (the engines this port has)")
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
    engine = "fused"

    import numpy as np
    import torch

    from parallelraytracing_tpu_torch import (Camera, Film, RenderConfig, Scene,
                                              ScenePreset, create_renderer)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but CUDA is not available "
                           "(use --device cpu for the plain PyTorch path)")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, samples_per_frame=args.spp,
                       jitter=not args.no_jitter, seed=args.seed)
    scene = Scene(ScenePreset(args.scene))
    eye = np.asarray(args.eye if args.eye is not None else (5.0, 5.0, 8.0),
                     np.float64)  # the reference's startup camera
    look = np.asarray(args.look_at if args.look_at is not None
                      else (0.0, 0.0, 0.0), np.float64)
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
    print(f"scene={args.scene} engine={engine} {args.width}x{args.height} "
          f"depth={cfg.max_depth} prims={scene.num_primitives} "
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
