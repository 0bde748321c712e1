#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main path through the entry points a user calls: the
fused engine on RANDOM_BALLS_LARGE (808 spheres + one ground quad) at
1920x1080, depth 20, 1 spp per frame, jitter on.  Phases, one line each
(any failure raises and exits non-zero):

1. probe: the card, its power limit, the torch and CUDA versions;
2. build: the trace kernel from csrc/ with nvcc (sm_90a), timed;
3. kernel vs plain PyTorch version on the card: at 320x180 on
   RANDOM_BALLS_LARGE and MATERIAL_TEST, depth 1 without jitter (winning
   radiance per ray within 1e-5 on >= 99.9% of rays) and depth 20 with
   jitter over 16 frames (HDR RMSE of the two films < 1e-3); then one
   main-path frame at 1920x1080, timed both ways;
4. main path: FusedRenderer from create_renderer("fused"), 2 warm-up
   frames, then >= 8 frames timed with CUDA events; the kernel's launch
   count over those frames, a finite film that is neither black nor
   sky, and a PNG.

The second-to-last lines are the card's `nvidia-smi` name and power limit
and a JSON record of each kernel; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SOURCE = "parallelraytracing_tpu_torch/csrc/trace.cu"
REPLACES = "parallelraytracing_tpu/ops/pallas_trace.py:3214"
#: depth-1 agreement: per-ray tolerance, and the share of rays within it
RAY_ATOL, RAY_SHARE = 1e-5, 0.999
#: depth-20 agreement: HDR RMSE bound between kernel and plain films
FILM_RMSE = 1e-3
MAIN_W, MAIN_H, MAIN_DEPTH = 1920, 1080, 20
WARMUP, TIMED = 2, 8


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def frame_inputs(renderer, frame_index: int):
    """The main path's trace inputs for one frame of `renderer`: the
    Morton-ordered pixel ids, the frame's rays and its path seed."""
    from parallelraytracing_tpu_torch.engines.fused import raygen_ids
    from parallelraytracing_tpu_torch.ops.rays import (frame_stream_seeds,
                                                       sample_key)
    cfg = renderer.config
    jseed, seed = frame_stream_seeds(sample_key(cfg.seed, frame_index, 0))
    o, d = raygen_ids(renderer._cam_params, renderer._ids, jseed, cfg.width,
                      cfg.height, cfg.jitter)
    return o, d, renderer._ids, seed


def both_traces(tables, cfg, o, d, pix, seed):
    """(kernel radiance, plain radiance) for the same inputs."""
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    args = (o, d, pix, seed, tables.sph, tables.quad, tables.tri,
            tables.sph_cl, tables.quad_cl, tables.tri_cl, tables.mats)
    kw = dict(max_depth=cfg.max_depth, t_min=cfg.t_min, t_max=cfg.t_max,
              sky=tables.sky, tri_live=tables.tri_live)
    return trace(*args, **kw), trace_reference(*args, **kw)


def make_renderer(preset: str, width: int, height: int, **cfg_kw):
    from parallelraytracing_tpu_torch import (Film, RenderConfig, Scene,
                                              ScenePreset, create_renderer,
                                              default_camera)
    cfg = RenderConfig(width=width, height=height, **cfg_kw)
    film = Film(width, height, "cuda")
    r = create_renderer("fused", "cuda")
    r.init(film, Scene(ScenePreset(preset)), default_camera(width, height), cfg)
    return r, film


def compare_kernel_plain(preset: str, width: int, height: int):
    """Phase 3 on one scene: (share of depth-1 rays within RAY_ATOL,
    depth-20 film RMSE over 16 frames)."""
    import torch
    r1, _ = make_renderer(preset, width, height, max_depth=1, jitter=False)
    k, p = both_traces(r1._tables, r1.config, *frame_inputs(r1, 0))
    torch.cuda.synchronize()
    if not (torch.isfinite(k).all() and torch.isfinite(p).all()):
        raise AssertionError(f"{preset}: non-finite depth-1 radiance")
    share = float(((k - p).abs().amax(1) <= RAY_ATOL).float().mean())

    r20, _ = make_renderer(preset, width, height, max_depth=20, jitter=True)
    acc_k = torch.zeros_like(k)
    acc_p = torch.zeros_like(k)
    for f in range(16):
        k, p = both_traces(r20._tables, r20.config, *frame_inputs(r20, f))
        acc_k += k
        acc_p += p
    torch.cuda.synchronize()
    rmse = float(((acc_k - acc_p) / 16).pow(2).mean().sqrt())
    return share, rmse


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from parallelraytracing_tpu_torch.ops import _build
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference

    # 1. probe
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    phase("probe", f"{name}; torch {torch.__version__}, CUDA "
                   f"{torch.version.cuda}; nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    _build.load("trace")
    build_s = time.perf_counter() - t0
    log = _build.library_path("trace").with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    phase("build", f"trace.cu in {build_s:.2f} s; ptxas: {' | '.join(ptxas)}")

    # 3. kernel vs plain
    for preset in ("random_balls_large", "material_test"):
        share, rmse = compare_kernel_plain(preset, 320, 180)
        phase("kernel-vs-plain", f"{preset} 320x180: depth 1 no jitter "
              f"{share:.6f} of rays within {RAY_ATOL}; depth 20 x16 frames "
              f"HDR RMSE {rmse:.3e}")
        if share < RAY_SHARE or not rmse < FILM_RMSE:
            raise AssertionError(f"{preset}: kernel disagrees with plain "
                                 f"({share} < {RAY_SHARE} or {rmse} >= {FILM_RMSE})")

    main_r, main_film = make_renderer("random_balls_large", MAIN_W, MAIN_H,
                                      max_depth=MAIN_DEPTH, jitter=True)
    o, d, pix, seed = frame_inputs(main_r, 0)
    k, p = both_traces(main_r._tables, main_r.config, o, d, pix, seed)
    torch.cuda.synchronize()
    err = (k - p).abs().amax(1)
    max_abs_err = float(err.max())
    share_main = float((err <= RAY_ATOL).float().mean())
    args = (o, d, pix, seed, main_r._tables.sph, main_r._tables.quad,
            main_r._tables.tri, main_r._tables.sph_cl, main_r._tables.quad_cl,
            main_r._tables.tri_cl, main_r._tables.mats)
    kw = dict(max_depth=MAIN_DEPTH, t_min=main_r.config.t_min,
              t_max=main_r.config.t_max, sky=main_r._tables.sky,
              tri_live=False)
    kernel_ms = cuda_ms(lambda: trace(*args, **kw), 5)
    plain_ms = cuda_ms(lambda: trace_reference(*args, **kw), 1)
    phase("kernel-vs-plain", f"main frame {MAIN_W}x{MAIN_H} depth "
          f"{MAIN_DEPTH}: {share_main:.6f} of rays within {RAY_ATOL}, max "
          f"abs err {max_abs_err:.3e}; trace kernel {kernel_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    if share_main < RAY_SHARE:
        raise AssertionError(f"main frame: {share_main} < {RAY_SHARE}")

    # 4. main path through the engine, as the CLI drives it
    for _ in range(WARMUP):
        main_r.progressive_render()
    torch.cuda.synchronize()
    trace.launches = 0
    frame_ms = cuda_ms(main_r.progressive_render, TIMED)
    launches = trace.launches
    samples = MAIN_W * MAIN_H * main_r.config.samples_per_frame
    phase("main-path", f"fused {MAIN_W}x{MAIN_H} depth {MAIN_DEPTH}: "
          f"{frame_ms:.3f} ms/frame, {samples / frame_ms / 1e3:.3f} "
          f"Msamples/s over {TIMED} frames; trace launches {launches}")
    if launches < TIMED:
        raise AssertionError(f"{launches} trace launches in {TIMED} frames")

    hdr = main_film.hdr_average()
    if hdr.shape != (MAIN_H, MAIN_W, 3) or not torch.isfinite(hdr).all():
        raise AssertionError("main-path film is not a finite (H, W, 3) image")
    disp = main_film.to_display()[..., :3].float()
    from parallelraytracing_tpu_torch import Film
    sky_film = Film(1, 1, "cuda")
    sky_film.add_sample_buffer(torch.tensor([main_r._tables.sky], device="cuda"))
    sky_disp = sky_film.to_display()[0, 0, :3].float()
    sky_share = float((disp == sky_disp).all(-1).float().mean())
    mean = float(disp.mean())
    if not (5.0 < mean < 250.0) or sky_share > 0.5:
        raise AssertionError(f"main-path image is blank or all sky "
                             f"(mean {mean}, sky share {sky_share})")
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "random_balls_large.png"
        main_film.save_png(str(png))
        phase("main-path", f"film finite, mean display value {mean:.2f}, "
              f"sky-only pixels {sky_share:.4f}; PNG {png.stat().st_size} bytes")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "trace", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
