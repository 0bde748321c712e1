"""A scripted interactive session through the viewer's own frame loop
(viewer/app.ViewerState._step), the counterpart of the repository's
``examples/interactive_session.py``.

Each session orbits the camera for a number of frames (the preview twin
renders them), lets it settle (full-size progressive refinement on the
chosen engine, the denoised display on) and prints the sustained fps of
both parts and the viewer's per-stage ring means; it writes the preview
and the settled PNGs into --out-dir.  Frame counts, not wall time, bound
each part, so a session does the same work on any host.  The bunny
session orbits the level-5 icosphere (the reference's bunny PLY is not in
the repository) on the CLI's showcase scene.

Run:  python -m parallelraytracing_tpu_torch.examples.interactive_session --device cuda
      python -m parallelraytracing_tpu_torch.examples.interactive_session --device cpu --quick
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def run_session(tag, scene, camera, cfg, engine, device, preview_scale,
                out_dir, orbit_frames, settle_frames, spin=10.0) -> dict:
    from parallelraytracing_tpu_torch.viewer.app import ViewerState
    state = ViewerState(scene, camera, cfg, engine, device,
                        preview_scale=preview_scale, display_interval_ms=150.0)
    try:
        state.denoise = True
        state._step(0.016)                      # warm: the first frame

        frames0 = state.frame
        t0 = time.perf_counter()
        preview_png = None
        for _ in range(orbit_frames):           # the orbit: preview twin
            state.control({"kind": "rotate", "dx": spin, "dy": 0.0})
            state._step(1.0 / 60.0)
            if preview_png is None and state.previewing and state.png_cache:
                preview_png = state.png_cache
        orbit_s = time.perf_counter() - t0
        was_previewing = state.previewing

        frames1 = state.frame
        t1 = time.perf_counter()
        for _ in range(settle_frames):          # at rest: refinement
            state._step(1.0 / 60.0)
        settle_s = time.perf_counter() - t1
        if state.film.sample_count != settle_frames:
            raise RuntimeError(f"{tag}: {state.film.sample_count} samples "
                               f"after {settle_frames} frames at rest")
        stage = {k: round(float(np.mean(list(v)[-20:])), 2)
                 for k, v in state.history.items() if v}
    finally:
        state.close()
    os.makedirs(out_dir, exist_ok=True)
    for name, png in (("preview", preview_png), ("settled", state.png_cache)):
        if png:
            with open(os.path.join(out_dir, f"interactive_{tag}_{name}.png"),
                      "wb") as f:
                f.write(png)
    orbit_fps = (frames1 - frames0) / orbit_s
    settle_fps = (state.frame - frames1) / settle_s
    print(f"[{tag}] {cfg.width}x{cfg.height} engine={engine} "
          f"preview=1/{preview_scale} device={device}")
    print(f"[{tag}] orbit: {frames1 - frames0} frames in {orbit_s:.2f} s = "
          f"{orbit_fps:.1f} fps (previewing={was_previewing})")
    print(f"[{tag}] settled: {settle_fps:.1f} fps refinement, "
          f"{state.film.sample_count} spp, denoised display")
    print(f"[{tag}] per-stage ms (last 20 frames): {stage}", flush=True)
    return dict(orbit_fps=orbit_fps, settle_fps=settle_fps, stage=stage)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--quick", action="store_true",
                   help="64x48, 3 orbit and 3 settled frames, the level-2 "
                        "icosphere (a smoke test)")
    p.add_argument("--out-dir", default="build/examples")
    args = p.parse_args(argv)

    from parallelraytracing_tpu_torch import (Camera, RenderConfig, Scene,
                                              ScenePreset)
    from parallelraytracing_tpu_torch.core.mesh import icosphere, write_ply
    from parallelraytracing_tpu_torch.core.scene import ply_showcase_scene

    orbit, settle = (3, 3) if args.quick else (60, 60)
    sizes = ([(64, 48)] * 2 if args.quick
             else [(512, 384), (1280, 720)])
    os.makedirs(args.out_dir, exist_ok=True)

    ply = os.path.join(args.out_dir, "bunny_icosphere.ply")
    write_ply(ply, icosphere(2 if args.quick else 5))
    scene, _, _ = ply_showcase_scene(ply)
    (w, h), (w2, h2) = sizes
    cfg = RenderConfig(width=w, height=h, max_depth=8, seed=0,
                       russian_roulette_depth=2)
    cam = Camera(np.array([0.0, 12.0, 26.0]), np.array([0.0, -6.0, -26.0]),
                 float(w), float(h), 100.0)
    run_session("bunny", scene, cam, cfg, "wavefront_fused", args.device, 3,
                args.out_dir, orbit, settle)

    cfg = RenderConfig(width=w2, height=h2, max_depth=8, seed=0,
                       russian_roulette_depth=2)
    cam = Camera(np.array([0.0, 5.0, 14.0]), np.array([0.0, -4.0, -14.0]),
                 float(w2), float(h2), 100.0)
    run_session("texture_demo", Scene(ScenePreset.TEXTURE_DEMO), cam, cfg,
                "adaptive", args.device, 3, args.out_dir, orbit, settle)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
