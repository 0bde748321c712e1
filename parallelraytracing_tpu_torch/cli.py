"""Command-line renderer of the port.

Renders N progressive frames of a preset scene, or of a PLY mesh in the
JAX package's showcase scene, and writes a PNG (plus optional linear PFM
and film checkpoint).  ``--engine auto`` picks wavefront_fused for a scene
of more than 512 triangles and fused otherwise, as the JAX CLI does on a
TPU.  A mesh of more than 24,576 triangles renders through the stream
route (ops/pack.py); the header line then names its chunk, and
``--stats`` prints its tables' counters (triangles, chunks, slots,
top-tree nodes, mini-tree columns, bytes).  ``megakernel``
is the reference engine (plain PyTorch, brute force: slow, for small
frames and as the oracle); ``bvh``, ``wavefront``, ``wavefront_bvh`` and
``tlas_ref`` are its plain PyTorch siblings over the LBVH walk, a
compacted bounce queue, both, and the two-level instance walk;
``adaptive`` is the fused engine with variance-guided pixel budgets, and
``--denoise N`` applies N levels of the à-trous filter
(postfx/denoise.py) before the PNG is written.  ``sharded`` splits the
frame over the ranks of a ``torchrun`` launch (one card a rank, NCCL; gloo
with ``--device cpu``): each traces its block, the film is gathered once
and rank 0 writes the outputs; without ``torchrun`` it renders the 1x1
mesh on the one device.

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
    python -m parallelraytracing_tpu_torch.cli --engine adaptive --denoise 4 \
        --frames 16 --out adaptive.png
    python -m parallelraytracing_tpu_torch.cli --device cpu --engine megakernel \
        --scene material_test --width 64 --height 48 --depth 8 --frames 4
    python -m parallelraytracing_tpu_torch.cli --engine bvh --frames 4
    torchrun --nproc-per-node 4 -m parallelraytracing_tpu_torch.cli \
        --engine sharded --width 1920 --height 1080 --frames 16
    python -m parallelraytracing_tpu_torch.cli --doctor
    python -m parallelraytracing_tpu_torch.cli --device cpu --doctor
"""

from __future__ import annotations

import argparse
import os
import sys
import time

#: the spans of a renderer's set-up that ``--stats`` prints in seconds
SETUP_SPANS = ("prt.build_tables", "prt.pack_stream")
#: engines of this port; "auto" picks by the scene's triangle count
ENGINE_CHOICES = ("auto", "fused", "wavefront_fused", "tlas", "megakernel",
                  "adaptive", "bvh", "wavefront", "wavefront_bvh", "tlas_ref",
                  "sharded")


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
                        "for instanced scenes) | megakernel (the reference "
                        "engine: plain PyTorch, brute force) | adaptive "
                        "(fused + variance-guided per-pixel sample "
                        "budgets) | bvh (the megakernel's loop over the "
                        "LBVH walk) | wavefront (staged bounces over a "
                        "compacted queue, brute force) | wavefront_bvh "
                        "(the same over the LBVH walk) | tlas_ref (the "
                        "LBVH walk and the two-level instance walk); the "
                        "last four are plain PyTorch | sharded (fused, or "
                        "wavefront_fused above 512 triangles, over the ranks "
                        "of a torchrun launch; 1x1 without one).  On an H100 "
                        "wavefront_fused is "
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
    p.add_argument("--denoise", type=int, default=0, metavar="N",
                   help="apply N levels of the edge-aware a-trous denoiser "
                        "before the PNG encode (guides from one pass of "
                        "pixel-center rays; postfx/denoise.py)")
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
                   help="print each frame's host and device time and, at "
                        "the end, host and device ms of every span of the "
                        "frame (prt.seeds, prt.raygen, prt.trace, "
                        "prt.film_add, ...; utils/timing.py) and which "
                        "raygen ran: kernel launches and plain-chain calls, "
                        "and the seed table's frames served and blocks "
                        "filled; "
                        "before the frames, the set-up's spans "
                        "(prt.build_tables, prt.pack_stream) in seconds "
                        "and, on the stream route, its tables' counters")
    p.add_argument("--doctor", action="store_true",
                   help="probe torch, the card, nvcc, triton, the kernel "
                        "builds, the native helpers and every engine on "
                        "--device, and exit (0 only when every row is ok)")
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
    from parallelraytracing_tpu_torch.engines.tables import stream_counters
    from parallelraytracing_tpu_torch.engines.wavefront_fused import (
        TRI_HEAVY, scene_triangles)
    from parallelraytracing_tpu_torch.ops.rays import generate_camera_rays_ids
    from parallelraytracing_tpu_torch.utils.profiling import record_into
    from parallelraytracing_tpu_torch.utils.timing import FrameTimer

    device = torch.device(args.device)
    if args.doctor:
        from parallelraytracing_tpu_torch.utils.diagnostics import run_diagnostics
        results = run_diagnostics(device)
        return 0 if all(v["ok"] for v in results.values()) else 1
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but CUDA is not available "
                           "(use --device cpu for the plain PyTorch path)")
    # under torchrun (WORLD_SIZE set) the sharded engine's mesh spans the
    # launch's ranks, one card a rank; rank 0 writes the outputs
    launched = args.engine == "sharded" and "WORLD_SIZE" in os.environ
    own_group = False
    if launched:
        import torch.distributed as dist
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        if not dist.is_initialized():
            dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
            own_group = True
    writer = not launched or dist.get_rank() == 0

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

    timer = FrameTimer(device)
    if args.stats:  # every span of the program a stage of the timer
        record_into(timer)
    renderer = create_renderer(engine, device)
    try:
        renderer.init(film, scene, cam, cfg)
    except BaseException:
        record_into(None)
        raise
    renderer._frame_index = start_frame
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    # the kernels' engines hold packed tables; the megakernel its lights
    tables = getattr(renderer, "_tables", None)
    if tables is not None:
        nee, stream = tables.nee, tables.stream
    else:
        nee, stream = renderer._lights is not None, None
    print(f"scene={args.ply or args.scene} engine={engine} "
          f"{args.width}x{args.height} depth={cfg.max_depth} "
          f"nee={nee} rr_depth={cfg.russian_roulette_depth} "
          f"prims={scene.num_primitives} "
          + (f"stream_chunk={stream.chunk} " if stream is not None else "")
          + f"device={device} ({name})")

    if args.stats:
        setup = timer.take()
        print("set-up: " + "  ".join(
            f"{name} {setup[name][0]:.3f} s" for name in SETUP_SPANS
            if name in setup))
        counters = None if tables is None else stream_counters(tables)
        if counters is not None:
            print("stream: " + " ".join(f"{k}={v}"
                                        for k, v in counters.items()))
    raygen_before = (generate_camera_rays_ids.launches,
                     generate_camera_rays_ids.plain)
    try:
        t_all = time.perf_counter()
        for i in range(args.frames):
            with timer.stage("render"):
                renderer.progressive_render()
                sync()
            if args.stats:
                dev_ms = timer.device_last("render")
                print(f"frame {start_frame + i:4d}  render "
                      f"{timer.last('render') * 1e3:8.1f} ms"
                      + ("" if dev_ms is None
                         else f"  device {dev_ms * 1e3:8.3f} ms"))
        total = time.perf_counter() - t_all
        print(f"{args.frames} frames in {total:.2f}s "
              f"({args.frames / total:.2f} fps, "
              f"{film.sample_count} samples accumulated)")

        renderer.gather_film()  # every rank: a collective under torchrun
        if not writer:
            if own_group:
                dist.destroy_process_group()
            return 0
        with timer.stage("tonemap"):
            if args.denoise > 0:
                from parallelraytracing_tpu_torch.postfx.denoise import \
                    save_denoised_png
                save_denoised_png(args.out, film, scene.build(device),
                                  renderer._cam_params, cfg,
                                  iterations=args.denoise,
                                  exposure=args.exposure, gamma=args.gamma)
            else:
                film.save_png(args.out, args.exposure, args.gamma)
        print(f"wrote {args.out}"
              + (f" (denoised x{args.denoise})" if args.denoise else ""))
        if args.hdr_out:
            film.save_pfm(args.hdr_out)
            print(f"wrote linear HDR {args.hdr_out}")
        if args.checkpoint:
            film.save_checkpoint(args.checkpoint,
                                 frame_index=start_frame + args.frames)
            print(f"checkpointed film to {args.checkpoint}")
        if args.stats:
            print(timer.summary())
            print(f"raygen: {generate_camera_rays_ids.launches - raygen_before[0]}"
                  f" kernel launches, "
                  f"{generate_camera_rays_ids.plain - raygen_before[1]} plain")
            print(f"seeds: {renderer.seed_frames} frames served, "
                  f"{renderer.seed_fills} blocks filled")
            if hasattr(renderer, "resort_stats"):
                n, moved, slots = renderer.resort_stats()
                print(f"resort: {n} boundaries, {moved} slots moved, "
                      f"{100.0 * moved / max(slots, 1):.2f}% of {slots} "
                      f"queue slots")
        if own_group:
            dist.destroy_process_group()
        return 0
    finally:
        if args.stats:
            record_into(None)


if __name__ == "__main__":
    sys.exit(main())
