#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --png-dir renders   # also keep the PNGs

Drives the port's two main paths through the entry points a user calls,
at 1920x1080, depth 20, 1 spp per frame, jitter on: the fused engine on
RANDOM_BALLS_LARGE (808 spheres + one ground quad), and the
wavefront_fused engine on the mesh showcase scene (ply_showcase_scene)
of an icosahedron subdivided to level 5 (20,480 triangles, smooth vertex
normals), written as a PLY and loaded through the port's reader.  Phases,
one line each (any failure raises and exits non-zero):

1. probe: the card, its power limit, the torch and CUDA versions;
2. build: the trace and segment kernels from csrc/ with nvcc (sm_90a),
   one nvcc each, started together; ptxas registers and spills of each
   instantiation (with and without the triangle fold);
3. kernel vs plain PyTorch version on the card: at 320x180 on
   RANDOM_BALLS_LARGE and MATERIAL_TEST, depth 1 without jitter (winning
   radiance per ray within 1e-5 on >= 99.9% of rays) and depth 20 with
   jitter over 16 frames (HDR RMSE of the two films < 1e-3); then one
   main-path frame at 1920x1080, timed both ways;
4. main path: FusedRenderer from create_renderer("fused"), 2 warm-up
   frames, then >= 8 frames timed with CUDA events; the kernel's launch
   count over those frames, a finite film that is neither black nor
   sky, and a PNG;
5. mesh, kernels vs plain at 320x180: the trace kernel (depth 1 without
   jitter, and depth 20 with jitter over 4 frames, with the bounds of
   phase 3); the segment kernel (the 13 planes after one 2-bounce
   segment from the camera rays within 1e-5 on >= 99.9% of slots, and
   segmented_trace over the default schedule, depth 20 over 4 frames,
   HDR RMSE < 1e-3);
6. mesh, engines agree on the card: the films of wavefront_fused and
   fused at 320x180, depth 20, over 16 frames (HDR RMSE < 1e-3; the max
   abs difference is printed, 0 expected);
7. mesh main path: WavefrontFusedRenderer from
   create_renderer("wavefront_fused") at 1920x1080, depth 20: first each
   segment of frame 0 against the plain version at its real queue (the
   13 planes of the live slots within 1e-5 on >= 99.9% of them); then 2
   warm-up frames and >= 8 timed with CUDA events; ms/frame,
   Msamples/s, Mrays/s over count_frame_rays, segment launches per
   frame, a finite film that is neither black nor sky, and a PNG; then
   the fused engine: frame 0's trace kernel against the plain version
   (per ray within 1e-5 on >= 99.9% of rays), and the same frames timed
   the same way.

The second-to-last lines are the card's `nvidia-smi` name and power limit
and a JSON record of each kernel (its launches counted over its main
path's timed frames); the last line is {"ok": true, "device": {...}}.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SOURCE = "parallelraytracing_tpu_torch/csrc/trace.cu"
REPLACES = "parallelraytracing_tpu/ops/pallas_trace.py:3214"
SEG_SOURCE = "parallelraytracing_tpu_torch/csrc/segment.cu"
SEG_REPLACES = "parallelraytracing_tpu/ops/pallas_trace.py:3476"
#: depth-1 agreement: per-ray tolerance, and the share of rays within it
RAY_ATOL, RAY_SHARE = 1e-5, 0.999
#: depth-20 agreement: HDR RMSE bound between kernel and plain films
FILM_RMSE = 1e-3
MAIN_W, MAIN_H, MAIN_DEPTH = 1920, 1080, 20
WARMUP, TIMED = 2, 8
#: the mesh: an icosahedron subdivided this often (4 ** 5 * 20 triangles)
MESH_LEVEL = 5
#: size and frame counts of the mesh comparisons with the plain versions
CMP_W, CMP_H, CMP_FRAMES, AGREE_FRAMES = 320, 180, 4, 16

#: the regular icosahedron: 12 closed-form vertices (0, +-1, +-phi) and
#: cyclic permutations, 20 faces wound counter-clockwise seen from outside
PHI = (1.0 + 5.0 ** 0.5) / 2.0
ICO_V = ((-1, PHI, 0), (1, PHI, 0), (-1, -PHI, 0), (1, -PHI, 0),
         (0, -1, PHI), (0, 1, PHI), (0, -1, -PHI), (0, 1, -PHI),
         (PHI, 0, -1), (PHI, 0, 1), (-PHI, 0, -1), (-PHI, 0, 1))
ICO_F = ((0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1))


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def frame_inputs(renderer, frame_index: int, jitter=None):
    """The main path's trace inputs for one frame of `renderer`: the
    frame's rays (jittered as its config says, unless `jitter` is given),
    the Morton-ordered pixel ids and the frame's path seed."""
    from parallelraytracing_tpu_torch.engines.fused import raygen_ids
    from parallelraytracing_tpu_torch.ops.rays import (frame_stream_seeds,
                                                       sample_key)
    cfg = renderer.config
    jseed, seed = frame_stream_seeds(sample_key(cfg.seed, frame_index, 0))
    o, d = raygen_ids(renderer._cam_params, renderer._ids, jseed, cfg.width,
                      cfg.height, cfg.jitter if jitter is None else jitter)
    return o, d, renderer._ids, seed


def both_traces(tables, cfg, o, d, pix, seed):
    """(kernel radiance, plain radiance) for the same inputs."""
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    args = (o, d, pix, seed, tables.sph, tables.quad, tables.tri,
            tables.sph_cl, tables.quad_cl, tables.tri_cl, tables.mats)
    kw = dict(max_depth=cfg.max_depth, t_min=cfg.t_min, t_max=cfg.t_max,
              sky=tables.sky, tri_live=tables.tri_live)
    return trace(*args, **kw), trace_reference(*args, **kw)


def traced_on(r, fn):
    """fn (trace or trace_reference) on renderer r's tables and config,
    called as fn(o, d, pix, seed)."""
    t, cfg = r._tables, r.config
    return lambda o, d, pix, seed: fn(
        o, d, pix, seed, t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl, t.tri_cl,
        t.mats, max_depth=cfg.max_depth, t_min=cfg.t_min, t_max=cfg.t_max,
        sky=t.sky, tri_live=t.tri_live)


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


def write_ply(path: str, level: int = MESH_LEVEL) -> int:
    """Write the icosahedron (vertices on the unit sphere) subdivided
    `level` times as a binary PLY of positions and faces; the reader
    computes the smooth vertex normals.  Returns the triangle count."""
    from parallelraytracing_tpu_torch.core.mesh import Mesh, subdivide
    v = np.asarray(ICO_V, np.float64)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    mesh = subdivide(Mesh(v.astype(np.float32),
                          np.asarray(ICO_F, np.uint32).reshape(-1)), level)
    faces = np.zeros(mesh.num_triangles, [("n", "u1"), ("i", "<i4", (3,))])
    faces["n"] = 3
    faces["i"] = mesh.indices.reshape(-1, 3)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {mesh.num_vertices}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {mesh.num_triangles}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(mesh.vertices.astype("<f4").tobytes())
        f.write(faces.tobytes())
    return mesh.num_triangles


def mesh_renderer(engine: str, ply: str, width: int, height: int, **cfg_kw):
    """A renderer of `engine` on the showcase scene of the PLY mesh, with
    the showcase camera, as the CLI's --ply builds it."""
    from parallelraytracing_tpu_torch import (Camera, Film, RenderConfig,
                                              create_renderer)
    from parallelraytracing_tpu_torch.core.scene import ply_showcase_scene
    scene, eye, look = ply_showcase_scene(ply)
    eye, look = np.asarray(eye, np.float64), np.asarray(look, np.float64)
    cfg = RenderConfig(width=width, height=height, **cfg_kw)
    film = Film(width, height, "cuda")
    r = create_renderer(engine, "cuda")
    r.init(film, scene, Camera(eye, look - eye, float(width), float(height),
                               100.0), cfg)
    return r, film


def ray_share(k, p) -> float:
    """Share of rays (rows) whose values all agree within RAY_ATOL."""
    return float(((k - p).abs().amax(1) <= RAY_ATOL).float().mean())


def segment_both(r, n_bounces: int = 2):
    """(kernel state, plain state, kernel ms, plain ms) of one segment of
    `n_bounces` bounces from frame 0's camera rays of renderer `r`."""
    import torch
    from parallelraytracing_tpu_torch.engines.wavefront_fused import (
        _initial_state, _run_segment, _scalars)
    from parallelraytracing_tpu_torch.ops.segment import segment, segment_reference
    o, d, pix, seed = frame_inputs(r, 0)
    state = _initial_state(o, d)
    count = torch.full((1,), o.shape[0], dtype=torch.int32, device="cuda")

    def run(fn):
        return _run_segment(r._tables, pix, state, _scalars(seed, 0, count),
                            n_bounces, r.config, fn)
    k, p = run(segment), run(segment_reference)
    return k, p, cuda_ms(lambda: run(segment), 5), cuda_ms(
        lambda: run(segment_reference), 1)


def film_rmse(r, frames: int, fn_k, fn_p) -> float:
    """HDR RMSE between the mean of `frames` frames of fn_k and fn_p, each
    called as fn(o, d, pix, seed) on renderer r's frame inputs."""
    import torch
    acc_k = acc_p = 0.0
    for f in range(frames):
        inputs = frame_inputs(r, f)
        acc_k = acc_k + fn_k(*inputs)
        acc_p = acc_p + fn_p(*inputs)
    torch.cuda.synchronize()
    return float(((acc_k - acc_p) / frames).pow(2).mean().sqrt())


def check_film(film, sky, tag: str, png_dir) -> str:
    """Raise unless `film` is a finite (H, W, 3) image that is neither
    blank nor all sky; write its PNG; return a one-line summary."""
    import torch
    from parallelraytracing_tpu_torch import Film
    hdr = film.hdr_average()
    if hdr.shape != (film.height, film.width, 3) or not torch.isfinite(hdr).all():
        raise AssertionError(f"{tag}: film is not a finite (H, W, 3) image")
    disp = film.to_display()[..., :3].float()
    sky_film = Film(1, 1, "cuda")
    sky_film.add_sample_buffer(torch.tensor([sky], device="cuda"))
    sky_disp = sky_film.to_display()[0, 0, :3].float()
    sky_share = float((disp == sky_disp).all(-1).float().mean())
    mean = float(disp.mean())
    if not (5.0 < mean < 250.0) or sky_share > 0.5:
        raise AssertionError(f"{tag}: image is blank or all sky "
                             f"(mean {mean}, sky share {sky_share})")
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / f"{tag}.png"
        film.save_png(str(png))
        size = png.stat().st_size
        if png_dir is not None:
            Path(png_dir).mkdir(parents=True, exist_ok=True)
            shutil.copy(png, Path(png_dir) / png.name)
    return (f"film finite, mean display value {mean:.2f}, sky-only pixels "
            f"{sky_share:.4f}; PNG {size} bytes")


def ptxas_summary(lib: str, log: Path) -> str:
    """The registers and spills of each kernel instantiation in an nvcc
    build log (-Xptxas -v): "tri" with the triangle fold, "sq" without."""
    if not log.exists():  # built by an earlier run, whose log is gone
        return ""
    out, tag = [], lib
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            tag = f"{lib}[{'tri' if 'ILb1E' in ln else 'sq'}]"
        elif "registers" in ln or "spill" in ln:
            out.append(f"{tag}: {ln.replace('ptxas info    :', '').strip()}")
    return " | ".join(out)


def timed_ms(fn):
    """(fn(), milliseconds between CUDA events around the one call)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--png-dir", default=None,
                    help="also copy the main paths' PNGs into this directory")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import dataclasses
    from parallelraytracing_tpu_torch.engines.wavefront_fused import (
        count_frame_rays, segmented_trace)
    from parallelraytracing_tpu_torch.ops import _build
    from parallelraytracing_tpu_torch.ops.segment import segment, segment_reference
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference

    # 1. probe
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    phase("probe", f"{name}; torch {torch.__version__}, CUDA "
                   f"{torch.version.cuda}; nvidia-smi: {smi}")

    # 2. build: one nvcc per library, all started together
    t0 = time.perf_counter()
    _build.build_all(["trace", "segment"])
    _build.load("trace")
    _build.load("segment")
    build_s = time.perf_counter() - t0
    ptxas = [ptxas_summary(lib, _build.library_path(lib).with_suffix(".log"))
             for lib in ("trace", "segment")]
    phase("build", f"trace.cu + segment.cu in {build_s:.2f} s; ptxas: "
                   f"{' | '.join(x for x in ptxas if x)}")

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
    args_t = (o, d, pix, seed, main_r._tables.sph, main_r._tables.quad,
              main_r._tables.tri, main_r._tables.sph_cl,
              main_r._tables.quad_cl, main_r._tables.tri_cl,
              main_r._tables.mats)
    kw = dict(max_depth=MAIN_DEPTH, t_min=main_r.config.t_min,
              t_max=main_r.config.t_max, sky=main_r._tables.sky,
              tri_live=main_r._tables.tri_live)
    kernel_ms = cuda_ms(lambda: trace(*args_t, **kw), 5)
    plain_ms = cuda_ms(lambda: trace_reference(*args_t, **kw), 1)
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
    segment.launches = 0
    frame_ms = cuda_ms(main_r.progressive_render, TIMED)
    launches = trace.launches
    samples = MAIN_W * MAIN_H * main_r.config.samples_per_frame
    phase("main-path", f"fused {MAIN_W}x{MAIN_H} depth {MAIN_DEPTH}: "
          f"{frame_ms:.3f} ms/frame, {samples / frame_ms / 1e3:.3f} "
          f"Msamples/s over {TIMED} frames; trace launches {launches}")
    if launches < TIMED or segment.launches:
        raise AssertionError(f"{launches} trace launches in {TIMED} frames, "
                             f"{segment.launches} segment launches")
    phase("main-path", check_film(main_film, main_r._tables.sky,
                                  "random_balls_large", args.png_dir))
    del main_r, main_film, k, p, err, args_t

    with tempfile.TemporaryDirectory() as tmp:
        ply = str(Path(tmp) / f"icosphere{MESH_LEVEL}.ply")
        n_tri = write_ply(ply)
        t0 = time.perf_counter()
        cmp_r, cmp_film = mesh_renderer("fused", ply, CMP_W, CMP_H,
                                        max_depth=MAIN_DEPTH, jitter=True)
        t = cmp_r._tables
        phase("mesh", f"icosahedron level {MESH_LEVEL}: {n_tri} triangles; "
              f"showcase scene loaded and packed in "
              f"{time.perf_counter() - t0:.2f} s; tri {tuple(t.tri.shape)}, "
              f"tri_cl {tuple(t.tri_cl.shape)}, tri_live {t.tri_live}")
        wf_r, wf_film = mesh_renderer("wavefront_fused", ply, CMP_W, CMP_H,
                                      max_depth=MAIN_DEPTH, jitter=True)
        sched = tuple(wf_r.segment_lengths())
        size = f"{CMP_W}x{CMP_H}"

        # 5. mesh: kernels vs plain
        cfg1 = dataclasses.replace(cmp_r.config, max_depth=1)
        share1 = ray_share(*both_traces(t, cfg1, *frame_inputs(cmp_r, 0,
                                                                jitter=False)))

        rmse = film_rmse(cmp_r, CMP_FRAMES, traced_on(cmp_r, trace),
                         traced_on(cmp_r, trace_reference))
        inputs = frame_inputs(cmp_r, 0)
        mesh_ms = cuda_ms(lambda: traced_on(cmp_r, trace)(*inputs), 5)
        mesh_plain_ms = cuda_ms(
            lambda: traced_on(cmp_r, trace_reference)(*inputs), 1)
        phase("mesh-trace-vs-plain", f"{size}: depth 1 no jitter {share1:.6f} "
              f"of rays within {RAY_ATOL}; depth {MAIN_DEPTH} x{CMP_FRAMES} "
              f"frames HDR RMSE {rmse:.3e}; trace kernel {mesh_ms:.3f} ms, "
              f"plain {mesh_plain_ms:.3f} ms (depth {MAIN_DEPTH}, one frame)")
        if share1 < RAY_SHARE or not rmse < FILM_RMSE:
            raise AssertionError("mesh: trace kernel disagrees with plain")

        k, p, seg_ms, seg_plain_ms = segment_both(wf_r)
        seg_share = ray_share(k.t(), p.t())
        seg_err = float((k - p).abs().max())

        def segmented(fn):
            return lambda o, d, pix, seed: segmented_trace(
                wf_r._tables, o, d, pix, seed, wf_r.config, schedule=sched,
                seg_fn=fn)
        seg_rmse = film_rmse(wf_r, CMP_FRAMES, segmented(segment),
                             segmented(segment_reference))
        phase("mesh-segment-vs-plain", f"{size}: one 2-bounce segment "
              f"{seg_share:.6f} of slots within {RAY_ATOL} on all 13 planes, "
              f"max abs err {seg_err:.3e}, segment kernel {seg_ms:.3f} ms, "
              f"plain {seg_plain_ms:.3f} ms; segmented_trace {sched} "
              f"x{CMP_FRAMES} frames HDR RMSE {seg_rmse:.3e}")
        if seg_share < RAY_SHARE or not seg_rmse < FILM_RMSE:
            raise AssertionError("mesh: segment kernel disagrees with plain")
        del k, p

        # 6. mesh: the two engines' films on the card
        for _ in range(AGREE_FRAMES):
            wf_r.progressive_render()
            cmp_r.progressive_render()
        diff = wf_film.hdr_average() - cmp_film.hdr_average()
        agree_rmse = float(diff.pow(2).mean().sqrt())
        agree_max = float(diff.abs().max())
        phase("mesh-engines-agree", f"{size} depth {MAIN_DEPTH} x{AGREE_FRAMES} "
              f"frames: wavefront_fused vs fused HDR RMSE {agree_rmse:.3e}, "
              f"max abs diff {agree_max!r}")
        if not agree_rmse < FILM_RMSE:
            raise AssertionError("mesh: wavefront_fused and fused disagree")
        del cmp_r, cmp_film, wf_r, wf_film

        # 7. mesh main path through the engine, as the CLI's --ply drives it
        mw_r, mw_film = mesh_renderer("wavefront_fused", ply, MAIN_W, MAIN_H,
                                      max_depth=MAIN_DEPTH, jitter=True)
        rays = count_frame_rays(mw_r._tables, *frame_inputs(mw_r, 0),
                                mw_r.config)
        per_frame = len(mw_r.segment_lengths())
        # Each segment of frame 0 at its real queue: the kernel and the
        # plain version on the same input, the kernel's state carried on.
        segs = []

        def checked(pix, state, scalars, *tabs, **kw):
            k = segment(pix, state, scalars, *tabs, **kw)
            p, p_ms = timed_ms(lambda: segment_reference(pix, state, scalars,
                                                         *tabs, **kw))
            live = int(scalars[2])
            segs.append(dict(
                bounces=kw["n_bounces"], live=live,
                share=ray_share(k[:, :live].t(), p[:, :live].t()) if live
                else 1.0,
                max_abs_err=float((k - p).abs().max()),
                ms=cuda_ms(lambda: segment(pix, state, scalars, *tabs, **kw),
                           5), plain_ms=p_ms))
            return k
        segmented_trace(mw_r._tables, *frame_inputs(mw_r, 0), mw_r.config,
                        sort_rays=mw_r.sort_rays,
                        schedule=tuple(mw_r.segment_lengths()), seg_fn=checked)
        for sg in segs:
            phase("mesh-segment-vs-plain", f"{MAIN_W}x{MAIN_H} frame 0, "
                  f"segment of {sg['bounces']} bounces over {sg['live']} live "
                  f"slots: {sg['share']:.6f} within {RAY_ATOL} on all 13 "
                  f"planes, max abs err {sg['max_abs_err']:.3e}; segment "
                  f"kernel {sg['ms']:.3f} ms, plain {sg['plain_ms']:.3f} ms")
            if sg["share"] < RAY_SHARE:
                raise AssertionError("mesh main path: segment kernel "
                                     "disagrees with plain")
        if len(segs) != per_frame:
            raise AssertionError(f"{len(segs)} segments checked, want {per_frame}")
        for _ in range(WARMUP):
            mw_r.progressive_render()
        torch.cuda.synchronize()
        trace.launches = 0
        segment.launches = 0
        wf_ms = cuda_ms(mw_r.progressive_render, TIMED)
        seg_launches = segment.launches
        phase("mesh-main-path", f"wavefront_fused {MAIN_W}x{MAIN_H} depth "
              f"{MAIN_DEPTH}, schedule {tuple(mw_r.segment_lengths())}: "
              f"{wf_ms:.3f} ms/frame, {samples / wf_ms / 1e3:.3f} Msamples/s, "
              f"{rays / wf_ms / 1e3:.3f} Mrays/s ({rays} rays in frame 0) over "
              f"{TIMED} frames; segment launches {seg_launches} "
              f"({seg_launches / TIMED:g} per frame), trace launches "
              f"{trace.launches}")
        if seg_launches != per_frame * TIMED or trace.launches:
            raise AssertionError(f"{seg_launches} segment launches in {TIMED} "
                                 f"frames of {per_frame} segments, "
                                 f"{trace.launches} trace launches")
        phase("mesh-main-path", check_film(mw_film, mw_r._tables.sky,
                                           "mesh_wavefront_fused",
                                           args.png_dir))
        del mw_r, mw_film

        mf_r, mf_film = mesh_renderer("fused", ply, MAIN_W, MAIN_H,
                                      max_depth=MAIN_DEPTH, jitter=True)
        inputs = frame_inputs(mf_r, 0)
        k = traced_on(mf_r, trace)(*inputs)
        p, mesh_main_plain_ms = timed_ms(
            lambda: traced_on(mf_r, trace_reference)(*inputs))
        mesh_main_err = float((k - p).abs().max())
        mesh_main_share = ray_share(k, p)
        mesh_main_ms = cuda_ms(lambda: traced_on(mf_r, trace)(*inputs), 5)
        phase("mesh-trace-vs-plain", f"{MAIN_W}x{MAIN_H} depth {MAIN_DEPTH} "
              f"frame 0: {mesh_main_share:.6f} of rays within {RAY_ATOL}, max "
              f"abs err {mesh_main_err:.3e}; trace kernel {mesh_main_ms:.3f} "
              f"ms, plain {mesh_main_plain_ms:.3f} ms")
        if mesh_main_share < RAY_SHARE:
            raise AssertionError("mesh main frame: trace kernel disagrees "
                                 "with plain")
        del k, p, inputs
        for _ in range(WARMUP):
            mf_r.progressive_render()
        torch.cuda.synchronize()
        trace.launches = 0
        segment.launches = 0
        f_ms = cuda_ms(mf_r.progressive_render, TIMED)
        f_launches = trace.launches
        phase("mesh-main-path", f"fused {MAIN_W}x{MAIN_H} depth {MAIN_DEPTH}: "
              f"{f_ms:.3f} ms/frame, {samples / f_ms / 1e3:.3f} Msamples/s, "
              f"{rays / f_ms / 1e3:.3f} Mrays/s over {TIMED} frames; trace "
              f"launches {trace.launches} (wavefront_fused {wf_ms:.3f} "
              f"ms/frame)")
        if trace.launches < TIMED or segment.launches:
            raise AssertionError(f"{trace.launches} trace launches in {TIMED} "
                                 f"frames, {segment.launches} segment launches")
        phase("mesh-main-path", check_film(mf_film, mf_r._tables.sky,
                                           "mesh_fused", args.png_dir))

    print(smi)
    seg0 = segs[0]
    print(json.dumps({"kernels": [
        {"name": "trace", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": launches,
         "max_abs_err": max(max_abs_err, mesh_main_err), "ms": kernel_ms,
         "plain_ms": plain_ms,
         "size": f"ms, plain_ms: random_balls_large {MAIN_W}x{MAIN_H} depth "
                 f"{MAIN_DEPTH}, one frame; max_abs_err over that frame and "
                 f"the {n_tri}-triangle mesh's",
         "mesh": {"launches": f_launches, "max_abs_err": mesh_main_err,
                  "ms": mesh_main_ms, "plain_ms": mesh_main_plain_ms,
                  "size": f"{n_tri}-triangle mesh {MAIN_W}x{MAIN_H} depth "
                          f"{MAIN_DEPTH}, one frame"}},
        {"name": "segment", "route": "cuda", "source": SEG_SOURCE,
         "replaces": SEG_REPLACES, "launches": seg_launches,
         "max_abs_err": max([seg_err] + [sg["max_abs_err"] for sg in segs]),
         "ms": seg0["ms"], "plain_ms": seg0["plain_ms"],
         "size": f"ms, plain_ms: {n_tri}-triangle mesh {MAIN_W}x{MAIN_H}, "
                 f"frame 0's first segment ({seg0['bounces']} bounces over "
                 f"{seg0['live']} slots); max_abs_err over every segment of "
                 f"that frame and the {size} checks",
         "segments": segs}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
