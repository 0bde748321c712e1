#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --png-dir renders   # also keep the PNGs

    python3 chip_smoke.py --big-level 8       # add phase 22 (1.3M triangles)

    python3 chip_smoke.py --stream-sweep      # and the stream chunk sweep

Drives the port's main paths through the entry points a user calls, at
1920x1080, depth 20, 1 spp per frame, jitter on: the fused engine on
RANDOM_BALLS_LARGE (808 spheres + one ground quad), and the
wavefront_fused engine on the mesh showcase scene (ply_showcase_scene)
of an icosahedron subdivided to level 5 (20,480 triangles, smooth vertex
normals), written as a PLY and loaded through the port's reader; then the
next-event estimation (NEE) and Russian roulette paths: A fused CORNELL
--nee (one quad light; the shadow test's equal-t, lowest-ordinal tie
rule decides its visibility), B fused RANDOM_BALLS_LARGE --nee (8 sphere lights),
C wavefront_fused CORNELL --nee --rr-depth 3 (the no-emit mark and
roulette across segments), D wavefront_fused mesh --nee (shadow walks
through the triangle tree); then the instanced path: bench.py's
multimesh scene (7 instances of 2 unique meshes through the kernels'
instance block) at 1920x1080, depth 8; then the scene extensions
(checker and image textures, the gradient and sun sky, thin lens and
QMC): T1 texture_demo and T2 sky_demo at the CLI's preset camera, depth
20, and T3 the multimesh scene with its two icospheres in texture_demo's
globe image, depth 8; then a big mesh on the stream route: bench.py's
big-mesh scene with icospheres of 81,920, 327,680 and (with --big-level
8) 1,310,720 triangles for its subdivided dragon scan, at 960x540, depth
8.  Phases, one or more lines each,
each line tagged with its seconds (any failure raises and exits
non-zero):

1. probe: the card, its power limit, the torch and CUDA versions;
2. build: the trace, segment, probe, micro and raygen kernels from
   csrc/ with nvcc (sm_90a), one nvcc each, started together; ptxas registers,
   stack frame, spill stores and shared memory of each of the 48
   instantiations of the first three (without triangles, with the dense
   triangle fold or the stream route's walk, with and without NEE,
   roulette, instances, the scene extensions) and of the micro's two
   mixes; then each trace and segment instantiation's persistent launch
   (its grid, block, resident blocks per SM, registers and local memory
   as the runtime reports them);
3. kernel vs plain PyTorch version on the card: at 320x180 on
   RANDOM_BALLS_LARGE and MATERIAL_TEST, depth 1 without jitter (winning
   radiance per ray within 1e-5 on >= 99.9% of rays) and depth 20 with
   jitter over 16 frames (HDR RMSE of the two films < 1e-3); then one
   main-path frame at 1920x1080, timed both ways;
4. main path: FusedRenderer from create_renderer("fused"), 2 warm-up
   frames, then >= 8 frames timed with CUDA events; the kernel's launch
   count over those frames, the raygen kernel's (exactly one a frame,
   no plain chain), a finite film that is neither black nor sky, and a
   PNG;
5. mesh, kernels vs plain at 320x180: the trace kernel (depth 1 without
   jitter, and depth 20 with jitter over 4 frames, with the bounds of
   phase 3); the segment kernel (one 2-bounce segment from the camera
   rays, its slots matched to the plain version's by pixel id: each live
   slot's outcome, a survivor's 13 planes or an ended path's radiance,
   within 1e-5 on >= 99.9% of them, the same survivors with the alive
   plane equal, the sort keys those of the survivors' planes exactly;
   and segmented_trace over the default schedule, depth 20 over 4
   frames, HDR RMSE < 1e-3);
6. mesh, engines agree on the card: the films of wavefront_fused and
   fused at 320x180, depth 20, over 16 frames (HDR RMSE < 1e-3; the max
   abs difference is printed, 0 expected);
7. mesh main path: WavefrontFusedRenderer from
   create_renderer("wavefront_fused") at 1920x1080, depth 20: first each
   segment of frame 0 against the plain version at its real queue (phase
   5's bounds), each segment's bound; then 2
   warm-up frames and >= 8 timed with CUDA events; ms/frame,
   Msamples/s, Mrays/s over count_frame_rays, segment launches per
   frame, a finite film that is neither black nor sky, and a PNG; then
   the fused engine: frame 0's trace kernel against the plain version
   (per ray within 1e-5 on >= 99.9% of rays), and the same frames timed
   the same way;
8. paths A and B at 1920x1080: the trace kernel with NEE against the
   plain version (whose shadow test is the closest-hit formulation):
   depth 1 without jitter and frame 0 at depth 20, per ray within 1e-5 on
   >= 99.9% of rays, and the films of 4 frames (HDR RMSE < 1e-3); then
   each path timed like phase 4 (ms/frame, Msamples/s, Mrays/s over
   count_frame_rays, which leaves NEE's shadow rays out), its launch
   count, film and PNG;
9. Russian roulette: RANDOM_BALLS_LARGE with rr_depth 3, NEE off, at
   1920x1080, with phase 8's bounds;
10. path C at 1920x1080: every segment of frame 0 of the (3,)-bounce
    default schedule against the plain segment at its real queue (phase
    5's bounds, the alive plane's 1 and 2 exactly equal on the same
    survivors); the wavefront_fused and fused films over 16
    frames (HDR RMSE < 1e-3, max abs difference printed, 0 expected);
    then timed;
11. path D: at 320x180 (a 1080p plain mesh frame with NEE would take
    ~45 s) the trace kernel with phase 8's checks and one 2-bounce
    segment (13 planes, alive equal); then timed at 1920x1080;
12. instances: bench.py's multimesh scene (its multimesh_scene recipe,
    camera and depth 8) built through Scene.add_mesh_instances, with the
    level-5 icosphere (20,480 triangles) in place of the bunny and the
    20-triangle icosahedron in place of icosahedron.ply (neither PLY is
    in the repo): 7 instances, 20,500 unique local triangles; the bytes
    of the instance tables against those the baked flat tables would
    need, and torch.cuda.max_memory_allocated();
13. instances, kernels vs plain at 320x180, with and without NEE: the
    trace kernel (depth 1 without jitter and frame 0 at depth 4 per ray
    within 1e-5 on >= 99.9% of rays; films of 4 frames, HDR RMSE < 1e-3)
    and one 2-bounce segment (phase 5's bounds); depth 4, lowered from 8
    to make room for phases 29-32 (INST_CMP_DEPTH);
14. instances, the engines agree: wavefront_fused and fused films over 16
    frames at 320x180, depth 4 (HDR RMSE < 1e-3, max abs difference
    printed, 0 expected); and instanced against baked: bench's tlas_blas scene (4
    icosahedron instances over a ground quad, 64x48, depth 10, 32 spp x
    8 frames) through the kernel, instanced and baked with add_mesh, HDR
    RMSE < 1e-3;
15. the instanced path timed at 1920x1080, depth 8: wavefront_fused
    (its schedule printed) and fused, each with and without NEE: the
    kernels' times on frame 0, then the engine as in phase 8 (ms/frame,
    Msamples/s, Mrays/s, bench's spp64_wall_s = 64 x ms/frame, launches,
    film, PNG);
16. NEE is unbiased on the card: CORNELL at 320x180, depth 20, 8 NEE
    frames against a truth of 1024 frames without NEE, with
    tests/test_nee.py's bounds (mean within 6%; RMSE to the truth < 0.6 x
    that of 8 frames without NEE);
17. the scene extensions, kernels vs plain at 320x180 (the kernels'
    kExt instantiations): T1 with and without NEE and with QMC + thin
    lens, T2, T3 (at depth 4, as phase 13); the trace kernel as in phase
    13 and one 2-bounce segment (phase 5's bounds);
18. the engines agree on T1 and T3: wavefront_fused and fused films over
    16 frames at 320x180 (HDR RMSE < 1e-3, 0 expected);
19. T1-T3 timed at 1920x1080: T1 fused, wavefront_fused, fused with the
    thin lens (radius 0.1, focus 10), with QMC + the lens, with NEE; T2
    and T3 fused and wavefront_fused: the kernels' times on frame 0 and
    their bounds (the texture fetches, checker and sky of the camera
    rays' hits added, counted by one probe launch), then the engine as in
    phase 8 (ms/frame, Msamples/s, Mrays/s, launches, film, PNG);
20. the stream route at level 6 (81,920 triangles, above the default
    threshold of 24,576): the stream instantiations of both kernels
    against their plain versions on 4,096 random camera rays, with and
    without NEE (the trace at depth 1 without jitter and at depth 8,
    within 1e-5 on >= 99.9% of rays; one 2-bounce segment with phase 5's
    bounds), then on every camera ray of a frame
    (the trace at depth 1 without jitter, one 2-bounce segment over the
    full queue, the same bounds); the films of 4 frames at 960x540, depth
    8, at chunk 64 against dense and against chunk 128 on both engines,
    bit for bit; the fused trace kernel's time, streamed and dense; with
    --stream-sweep also the same frames one bounce at a time through the
    segment kernel, dense against chunks 64, 128 and 256: every pixel
    whose outcome differs equals the plain version in one of the two
    layouts (a tree
    culled a hit grazing a vertex on a box face), on at most 1e-5 of the
    segments;
21. level 7 (327,680 triangles, past the dense layout's 2^18 cap): the
    scene's build and pack seconds and table bytes, phase 20's
    kernel-vs-plain checks, the two engines' films (HDR RMSE < 1e-3, 0
    expected), wavefront_fused and fused with and without NEE timed as
    in phase 15 (kernel times and bounds on frame 0, ms/frame, Mrays/s),
    torch.cuda.max_memory_allocated(); with --stream-sweep then the
    chunks 64, 128 and 256: pack seconds, the fused trace kernel, its
    frame and the segments;
22. with --big-level 8, phase 21 without the chunks at level 8
    (1,310,720 triangles).  The renderers of one scene share its packed
    tables (``shared_tables``);
23. the probes (depth_out, collect_stats: the probe kernel), run on
    renderers that earlier phases made: the headline at 1920x1080 depth
    20 (phase 4) and with NEE (path B), the level-5 mesh (phase 7's fused
    renderer, and path D's at 320x180 with NEE), the instanced scene
    (phase 15's fused renderers, with and without NEE) and the level-7
    stream scene (phase 21's): on frame 0 the probe radiance equals the
    trace kernel's bit for bit, the depths sum to count_frame_rays, and
    on 256 sampled rays depths and counters equal the plain version's
    (ops/walk_stats.py's replay); the probe and trace kernels timed; the
    counters summarised per ray and per warp (trace_stats); each fused
    launch whose bound is taken gets a probe launch of its own, for the
    counted-visit bound;
24. depth_sort: the fused engine on the headline with depth_sort 0, 1
    and 13 (every launch count set to 0 first: one probe launch each for
    1 and 13), the films of 4 frames bit-equal, then each timed as in
    phase 4 with its trace kernel and its probe frame;
25. the float32 peak micro (benchmarks/micro.py) against its plain
    version at its timed shape (relative error < 1e-6), twice the loops
    taking twice the time (1.8-2.2x), its two mixes timed (T ops/s,
    TFLOP/s), the read rate of a 4 GiB tensor, the SASS instruction
    counts; then every counted-visit trace bound and every segment bound
    of the run at these measured peaks, beside the data sheet's;
26. (run after phase 23's headline probes) the persistent trace kernel's
    path regeneration: on the headline and CORNELL --nee at 1920x1080,
    depth 1 and 20, for 0, 1, 31, 33, 4101 rays and the persistent
    grid's threads + 1, the trace kernel's radiance equals the probe
    kernel's (one thread per ray, the loop the trace kernel had) bit for
    bit, and two launches give the same bits; the headline's trace
    kernel timed on frames 0 and 7, and the records' pack alone
    (ops/pack.scene_records, made once with the table set);
27. (run inside phases 7, 10, 14, 18 and 21) the sort modes: on the
    mesh, path C, the instanced scene and T1 at 1920x1080 and level 7 at
    960x540, wavefront_fused under sort_rays "octant", "origin" and ""
    renders the fused engine's sample buffers bit for bit (frames 0 and
    1), each segment boundary timed in the frame (CUDA events between the
    segment launches) and its argsort and two gathers alone, and each
    mode's frame timed beside the fused engine's;
28. (after phase 11) the segment kernel's queue at its edges: on the
    mesh and CORNELL --nee --rr-depth 3 at 1920x1080, the first segment
    over 0, 1, 31, 33, 4101 live slots and the persistent grid's threads
    + 1 equals the plain version bit for bit (survivors' planes, pixel
    ids and keys, ended paths' radiance) and a second launch; a whole
    frame into a NaN-filled radiance buffer leaves no NaN and ends one
    path per pixel;
29. bench.py's converged-spp gates (bench.py:455-602) against the port's
    megakernel engine (plain PyTorch, brute force, threefry streams: an
    oracle written apart from the kernels): 64x48, depth 10, 32 samples
    a frame, HDR RMSE of the mean < 1e-3 for fused and wavefront_fused
    on MATERIAL_TEST at 4096 spp, wavefront_fused on bench's bunny scene
    and camera with the level-3 icosphere (1,280 triangles) for the
    bunny (the brute-force oracle's time grows with the triangles: 31 s
    on these 1,280), wavefront_fused on the instanced
    tlas_blas scene at 8192 spp (the oracle on the same transforms
    baked), fused on bench's textured-image scene; one line a row with
    its RMSE, spp and the kernels' launches; then the plain PyTorch
    engines' rows at 32 spp: bench's equal-streams row (bvh against
    megakernel, a sample a frame, ~0), wavefront against megakernel (0:
    the frame is one ray tile), wavefront_bvh against bvh, and tlas_ref on
    the instanced tlas_blas scene against megakernel on it baked, each
    with its RMSE, max abs difference and seconds;
30. one megakernel frame of the headline at 1920x1080, depth 20, timed
    with CUDA events beside the fused engine's ms/frame;
31. the adaptive engine on the headline at 1920x1080, depth 20: 4
    warm-up films bit-equal to fused's; on the first adaptive frame the
    trace kernel on the selected ids against the plain version (within
    1e-5 on >= 99.9% of rays), the budget in ids, the kernel on the
    subset, the selection and the slot add timed, the kernel's
    counted-visit bound on the subset (the probe kernel's counters of the
    same launch, at phase 25's measured peaks); 4 adaptive frames with
    one trace launch each, ms/frame;
32. the à-trous denoiser: the guide pass and 4 levels at 1920x1080
    timed; at 128x96 on CORNELL the denoised 8-frame image nearer (MSE)
    a 256-frame fused truth than the raw one; the CLI's ``--engine
    adaptive --denoise 4`` and ``--engine megakernel`` write their PNGs
    (kept with --png-dir);
33. lbvh-engines, the plain PyTorch LBVH engines at full size: the
    headline (RANDOM_BALLS_LARGE at 1920x1080, depth 20, 1 spp, jitter,
    seed 0) through bvh, wavefront_bvh and wavefront, one warm-up frame
    then one timed by CUDA events: ms/frame, Msamples/s, Mrays/s over
    the ray segments the engine's bounce loop counts, build_bvh's seconds
    and nodes, the walk's box-test steps and rounds a bounce, the peak
    device memory, a finite film that is neither black nor sky; BASELINE
    config 5: bvh with an animate hook orbiting one sphere, 4 frames at
    1920x1080, depth 20, each refit timed alone, and on the card every
    internal box holding its children's, every leaf box its moved
    primitive's leaf_aabbs box, frame 0's boxes the build's bit for bit;
    tlas_ref on bench's multimesh scene (phase 12's) at 1920x1080, depth
    8, one frame timed.  No kernel launches in any of them;
34. app, the interactive viewer (viewer/app.py) on the main path:
    ViewerState on RANDOM_BALLS_LARGE at 1920x1080, depth 20, engine
    fused, preview scale 3, display every 250 ms, served by make_handler
    on 127.0.0.1 (port 0) in a thread: (a) 32 frames at rest, the film
    bit-equal to a separate fused renderer's after the same 32 frames,
    trace launches exactly 32; (b) 20 rotate messages posted to
    /control, one a frame: the preview twin (640x360, /stats "preview")
    renders them, and when the motion stops the film is cleared and the
    refinement restarts at frame 0; (c) an engine switch to
    wavefront_fused posted, 8 frames: the film bit-equal to a separate
    fused renderer's under the new camera, one segment launch a
    segment; (d) the denoiser toggled and one display taken; (e)
    /frame.png read back through utils/png at 1920x1080, neither black
    nor all sky; sustained fps at rest and orbiting, the rings' means;
35. host-stages, where the headline frame's host time goes: 8 fused
    frames after 2 warm-up frames through progressive_render, a
    utils/timing.FrameTimer attached to the program's spans (host and
    device ms a frame of prt.frame, prt.seeds, prt.raygen, prt.trace and
    prt.film_add), one trace launch a frame; then 8 more frames under
    utils/profiling.trace: the device's busy and idle share of the
    window, CUDA launches a frame, the three longest idle gaps and the
    span each falls in, each span's idle and launched device ms a frame;
    the film bit-equal to one rendered with the spans off;
36. doctor: ``python -m parallelraytracing_tpu_torch.cli --doctor`` in a
    subprocess, every row ok and the exit code 0;
37. native: the native helpers (native.py) built with g++ on the card's
    host (a failed build prints the log's error and fails), each held
    to its Python twin: the LBVH arrays of the headline scene and the
    level-5 icosphere exactly, load_ply of the level-5 and level-7
    icosphere PLYs exactly (both readers' seconds), the PNG encoder's
    round trip of a 1080p display (ms a call, beside the Python
    encoder's);
38. sharded, the multi-device engine (engines/sharded.py) on
    RANDOM_BALLS_LARGE and the level-5 mesh at 1920x1080, depth 20,
    jitter on: (a) at 1x1 without a process group, 4 frames whose film
    is bit-equal to the fused engine's with one trace launch a frame,
    then 8 frames of each timed in turns; (b) the mesh through the
    segmented route, 2 frames bit-equal to wavefront_fused's (the same
    schedule and sort mode), its segment launches, 8 frames timed in
    turns; (c) two ranks spawned on cuda:0 and joined over gloo (NCCL
    refuses two ranks on one device: its message is printed): the 2x1
    headline film after the gather bit-equal to (a)'s fused film, the 2x1
    mesh film to (b)'s wavefront_fused film, the 1x2 frame bit-equal to
    the mean of sample streams 0 and 1 traced one by one on the 1x1
    path; each rank's ms a frame, the film gather's and the spp
    all-reduce's ms.  Two ranks on one card measure gloo's staging
    through the host, not scaling;
39. raygen: the raygen kernel (csrc/raygen.cu, what
    ops/rays.generate_camera_rays_ids launches on CUDA tensors) against
    its plain chain on the card, o and d held equal with torch.equal:
    the headline's 1080p Morton ids with jitter, 360p after a yaw, no
    jitter, QMC, the thin lens (with QMC, and its center), and the last
    px block of the sharded engine's slots at 7 blocks (ids past H*W);
    then on the headline's ids the kernel's device time a launch (the
    profiler), its wrapper's and the chain's time a call, and the
    kernel's bound, 28 bytes a ray at the measured read rate.

The second-to-last lines are the card's `nvidia-smi` name and power limit
and a JSON record of each kernel (its launches counted over its main
path's timed frames, its bound on the card for the measured launch at
the measured peaks (the trace kernel's from counted visits; every
segment's of the segment kernel's frame), its
NEE, roulette and instanced comparisons, and the timed paths A-D and
the instanced ones), of each kernel's scene-extension
instantiations ("trace[ext]", "segment[ext]": T1-T3) and of its stream
instantiations ("trace[stream]", "segment[stream]": phases 20-22), of
the probe kernel ("trace[probe]": phases 23-24) and of the micro
("fp32_peak": phase 25) and of the raygen kernel ("raygen": phase 39's
times and cases, its launches over phase 4's and each timed path's
frames); each trace entry names the launch of its
scene's instantiation ("launch": grid, block, registers, local and
shared memory, whether tables were staged in shared memory; likewise
each segment entry), the trace and segment entries list all 48
("instantiations"), the trace entry phase 26's cases ("regeneration"),
the segment entry phase 27's sort modes ("sort_modes") and phase 28's
cases ("queue_edges"), the trace entry phases 29-32 ("gates",
"megakernel_frame", "adaptive": the kernel's launches and times on the
adaptive path and its bound there, "denoise").  The line before the
kernels line is phase 38's record ({"sharded": ...}), before it phases
34-37's ({"app": ...}) and phase 33's ({"lbvh_engines": ...}); the
trace and segment entries carry the viewer's launches ("app") and the
sharded engine's ("sharded"); the last line is
{"ok": true, "device": {...}}.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from parallelraytracing_tpu_torch.benchmarks.roofline import (
    CHECKER_OPS, SKY_OPS, SPH_UV_OPS, TEX_OPS, TRACE_RAY_BYTES, bound_from,
    counted_bound, kernel_bound, segment_io_bytes, sum_counts, table_bytes)

SOURCE = "parallelraytracing_tpu_torch/csrc/trace.cu"
REPLACES = "parallelraytracing_tpu/ops/pallas_trace.py:3214"
SEG_SOURCE = "parallelraytracing_tpu_torch/csrc/segment.cu"
SEG_REPLACES = "parallelraytracing_tpu/ops/pallas_trace.py:3476"
PROBE_SOURCE = "parallelraytracing_tpu_torch/csrc/probe.cu"
MICRO_SOURCE = "parallelraytracing_tpu_torch/csrc/micro.cu"
MICRO_REPLACES = "benchmarks/micro.py:30"
RAYGEN_SOURCE = "parallelraytracing_tpu_torch/csrc/raygen.cu"
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
#: Russian roulette's start depth on the slice's paths (the CLI's
#: --rr-depth 3), and the frames of each NEE / roulette film comparison
RR_DEPTH, NEE_FILM_FRAMES = 3, 4
#: NEE is unbiased (tests/test_nee.py's bounds, CORNELL at CMP_W x CMP_H):
#: the mean of NEE_FRAMES NEE frames within MEAN_REL of a truth of
#: TRUTH_FRAMES frames without NEE, and their RMSE to the truth under
#: RMSE_RATIO x that of NEE_FRAMES frames without NEE
TRUTH_FRAMES, NEE_FRAMES, MEAN_REL, RMSE_RATIO = 1024, 8, 0.06, 0.6
#: the instanced path: bench.py's multimesh rows (depth min(8, 20)) and
#: its camera; the tlas_blas gate's scene, size, depth and samples
INST_DEPTH = 8
#: the depth of the instanced and T3 scenes' kernel-vs-plain comparisons
#: at CMP_W x CMP_H (phases 13, 14 and 17; the plain version's brute
#: force over every instance's triangles took 9-13 s a frame at depth 8,
#: and the gates of phase 29 needed the run's time: lowered from 8)
INST_CMP_DEPTH = 4
INST_EYE, INST_DIR = (0.0, 12.0, 30.0), (0.0, -7.0, -30.0)
TLAS_W, TLAS_H, TLAS_DEPTH, TLAS_SPP, TLAS_FRAMES = 64, 48, 10, 32, 8
#: the stream route's workloads: bench's big-mesh scene (big_mesh_scene)
#: at 960x540, depth 8, its camera, the rays of each kernel-vs-plain
#: comparison, the frames of each film comparison, and the chunks timed
BIG_W, BIG_H, BIG_DEPTH = 960, 540, 8
BIG_EYE, BIG_DIR = (0.0, 14.0, 28.0), (0.0, -7.0, -28.0)
BIG_RAYS, BIG_FRAMES = 4096, 4
#: the second chunk whose level-6 films must equal the default chunk's,
#: and the chunks of --stream-sweep
ALT_CHUNK, CHUNK_SWEEP = 128, (64, 128, 256)
#: --stream-sweep's layout check: the largest share of ray segments whose
#: state may differ between the dense layout and a chunk's (measured: 0
#: or 1 of 3,590,072)
LAYOUT_SHARE = 1e-5
#: the scene extensions' workloads: T1 texture_demo, T2 sky_demo (depth
#: MAIN_DEPTH) at the CLI's preset camera, T3 the instanced multimesh
#: scene with its two icospheres in texture_demo's globe image (depth
#: INST_DEPTH); the lens of T1's thin-lens paths
PRESET_EYE, PRESET_LOOK = (5.0, 5.0, 8.0), (0.0, 0.0, 0.0)
LENS_RADIUS, FOCUS_DISTANCE = 0.1, 10.0

_LAST = [time.perf_counter()]


def phase(name: str, msg: str) -> None:
    """One result line, tagged with the seconds since the previous line
    (the seconds of that step of the phase)."""
    now = time.perf_counter()
    print(f"[{name} {now - _LAST[0]:.1f} s] {msg}", flush=True)
    _LAST[0] = now


def frame_inputs(renderer, frame_index: int, jitter=None):
    """The main path's trace inputs for one frame of `renderer`: the
    frame's rays (jittered as its config says, unless `jitter` is given),
    the Morton-ordered pixel ids and the frame's path seed."""
    from parallelraytracing_tpu_torch.engines.fused import raygen_ids
    from parallelraytracing_tpu_torch.ops.rays import (frame_stream_seeds,
                                                       sample_key)
    cfg = renderer.config
    jseed, seed = frame_stream_seeds(sample_key(cfg.seed, frame_index, 0))
    o, d = raygen_ids(renderer._cam_params, renderer._ids,
                      renderer._pixel_seed(jseed), cfg.width, cfg.height,
                      cfg.jitter if jitter is None else jitter, cfg.lens,
                      renderer._qpt(frame_index, 0))
    return o, d, renderer._ids, seed


def both_traces(tables, cfg, o, d, pix, seed):
    """(kernel radiance, plain radiance) for the same inputs (NEE, Russian
    roulette, instances and the scene extensions as the table set and the
    config have them)."""
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    return (trace(o, d, pix, seed, tables, cfg),
            trace_reference(o, d, pix, seed, tables, cfg))


def traced_on(r, fn):
    """fn (trace or trace_reference) on renderer r's tables and config,
    called as fn(o, d, pix, seed)."""
    return lambda o, d, pix, seed: fn(o, d, pix, seed, r._tables, r.config)


def make_renderer(preset: str, width: int, height: int, engine="fused",
                  attrs=None, **cfg_kw):
    """A renderer of `engine` on a preset at its default camera, the
    engine's attributes `attrs` set before init."""
    from parallelraytracing_tpu_torch import (Film, RenderConfig, Scene,
                                              ScenePreset, create_renderer,
                                              default_camera)
    cfg = RenderConfig(width=width, height=height, **cfg_kw)
    film = Film(width, height, "cuda")
    r = create_renderer(engine, "cuda")
    for k, v in (attrs or {}).items():
        setattr(r, k, v)
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
    from parallelraytracing_tpu_torch.core import mesh
    return mesh.write_ply(path, mesh.icosphere(level))


def mesh_renderer(engine: str, ply: str, width: int, height: int,
                  attrs=None, **cfg_kw):
    """A renderer of `engine` on the showcase scene of the PLY mesh, with
    the showcase camera, as the CLI's --ply builds it (the engine's
    attributes `attrs` set before init)."""
    from parallelraytracing_tpu_torch.core.scene import ply_showcase_scene
    scene, eye, look = ply_showcase_scene(ply)
    eye, look = np.asarray(eye, np.float64), np.asarray(look, np.float64)
    return scene_renderer(engine, scene, eye, look - eye, width, height,
                          attrs=attrs, **cfg_kw)


def ray_share(k, p) -> float:
    """Share of rays (rows) whose values all agree within RAY_ATOL."""
    return float(((k - p).abs().amax(1) <= RAY_ATOL).float().mean())


def segment_outcomes(res, rad):
    """Each pixel's outcome of a segment launch, (P, 16): a survivor's 13
    planes (NaN for a pixel that did not survive) and the radiance its
    path wrote to `rad` (NaN where none was written: `rad` is filled with
    NaN before the launch).  `res` is the launch's (state, pix, key,
    count)."""
    import torch
    state, pix, _, count = res
    c = int(count)
    planes = torch.full((rad.shape[0], 13), float("nan"), device=rad.device)
    planes[pix[:c].long()] = state[:, :c].t()
    return torch.cat([planes, rad], 1)


def compare_outcomes(k, p, live) -> dict:
    """Kernel outcomes `k` against plain ones `p` (segment_outcomes) on
    the pixels `live` of the live input slots: the share whose outcome
    agrees (the same end, survivor or ended, each value within RAY_ATOL),
    whether the alive plane is equal on every pixel (the same survivors,
    with the same NEE mark), the max abs error where both hold a value,
    and whether the two are equal bit for bit."""
    import torch
    k, p = k[live], p[live]
    both = torch.isnan(k) & torch.isnan(p)
    diff = (k - p).abs()
    close = (diff <= RAY_ATOL) | both
    held = ~torch.isnan(diff)
    return dict(share=float(close.all(1).float().mean()) if len(live) else 1.0,
                alive_equal=bool(((k[:, 12] == p[:, 12]) | both[:, 12]).all()),
                max_abs_err=float(diff[held].max()) if held.any() else 0.0,
                bit_equal=bool(torch.equal(k.view(torch.int32),
                                           p.view(torch.int32))))


def key_exact(res, bb, mode: str) -> bool:
    """The kernel's sort keys are the plain sort_key of its own survivors'
    planes, bit for bit, and DEAD_KEY past them (True without a key)."""
    import torch
    from parallelraytracing_tpu_torch.ops.segment import DEAD_KEY, sort_key
    state, _, key, count = res
    if key is None:
        return True
    c = int(count)
    return bool(torch.equal(key[:c], sort_key(state[:, :c], bb, mode))
                and (key[c:] == DEAD_KEY).all())


def queue_vs_plain(r, pix, state, count, seed: int, depth0: int,
                   n_bounces: int, sort_rays: str, reps: int = 5,
                   out=None) -> tuple:
    """One segment of wavefront_fused renderer r over the queue (pix,
    state) with `count` live, through the kernel and its plain version,
    each writing to its own NaN-filled radiance: the comparison of their
    outcomes (compare_outcomes, key_exact), the survivor counts, the
    kernel's ms (mean of `reps` launches on the same input, 0 for none)
    and the plain version's.  Returns (record, the kernel's result, its
    radiance): a timed launch leaves the same survivors and radiance."""
    import torch
    from parallelraytracing_tpu_torch.ops.segment import segment, segment_reference
    t, cfg = r._tables, r.config
    rads = [torch.full((cfg.width * cfg.height, 3), float("nan"),
                       device="cuda") for _ in range(2)]

    def run(fn, rad, queue_out=None):
        return fn(pix, state, count, rad, t, cfg, seed=seed, depth0=depth0,
                  n_bounces=n_bounces, sort_rays=sort_rays, out=queue_out)
    p, plain_ms = timed_ms(lambda: run(segment_reference, rads[1]))
    k = run(segment, rads[0], out)
    live = pix[:int(count)].long()
    rec = compare_outcomes(segment_outcomes(k, rads[0]),
                           segment_outcomes(p, rads[1]), live)
    rec.update(key_exact=key_exact(k, t.bb, sort_rays), live=int(count),
               survivors=int(k[3]), plain_survivors=int(p[3]),
               bounces=n_bounces, plain_ms=plain_ms,
               ms=cuda_ms(lambda: run(segment, rads[0], out), reps)
               if reps else 0.0)
    return rec, k, rads[0]


def segment_both(r, n_bounces: int = 2) -> dict:
    """queue_vs_plain's record of one segment of `n_bounces` bounces from
    frame 0's camera rays of renderer `r`, every slot live."""
    import torch
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        _initial_state
    o, d, pix, seed = frame_inputs(r, 0)
    count = torch.full((1,), o.shape[0], dtype=torch.int32, device="cuda")
    return queue_vs_plain(r, pix, _initial_state(o, d), count, seed, 0,
                          n_bounces, r.sort_rays)[0]


def segment_agrees(rec: dict) -> bool:
    """A segment comparison holds: RAY_SHARE of the live pixels' outcomes
    within RAY_ATOL, the alive plane equal, the keys exact."""
    return (rec["share"] >= RAY_SHARE and rec["alive_equal"]
            and rec["key_exact"])


def segment_line(rec: dict) -> str:
    """queue_vs_plain's record as the end of a phase line."""
    return (f"{rec['share']:.6f} of the {rec['live']} live slots' outcomes "
            f"(a survivor's 13 planes, an ended path's radiance) within "
            f"{RAY_ATOL}, alive plane equal {rec['alive_equal']}, keys exact "
            f"{rec['key_exact']}, bit-equal {rec['bit_equal']}, survivors "
            f"{rec['survivors']} (plain {rec['plain_survivors']}), max abs "
            f"err {rec['max_abs_err']:.3e}; segment kernel {rec['ms']:.3f} "
            f"ms, plain {rec['plain_ms']:.3f} ms")


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


def ptxas_table(lib: str, log: Path) -> list:
    """Each kernel instantiation of an nvcc build log (-Xptxas -v): its
    tag ("tri" with the dense triangle fold, "tri-stream" with the stream
    route's two-level walk, "sq" without triangles, "+nee" with the NEE
    block, "+rr" with Russian roulette, "+inst" with the instance block,
    "+ext" with the scene extensions), its kernel_variant index (None for
    the micro), registers, stack frame, spill stores and static shared
    memory (bytes)."""
    if not log.exists():  # built by an earlier run, whose log is gone
        return []
    out, cur, props = [], None, None
    for ln in log.read_text().splitlines():
        m = re.search(r"ILi([012])ELb([01])ELb([01])ELb([01])ELb([01])E", ln)
        mix = re.search(r"fp32_peak_kernelILi([01])E", ln)
        entry = re.search(r"Compiling entry function '([^']+)'", ln)
        if "Function properties for" in ln:
            props = ln.split("Function properties for")[1].strip()
        elif entry and (m or mix):
            cur = dict(name=entry.group(1))
            if mix:
                cur.update(tag=f"{lib}[{('fma', 'slab')[int(mix.group(1))]}]",
                           variant=None)
            else:
                tri, nee, rr, inst, ext = (int(g) for g in m.groups())
                cur.update(
                    tag=(f"{lib}[{('sq', 'tri', 'tri-stream')[tri]}"
                         f"{'+nee' if nee else ''}{'+rr' if rr else ''}"
                         f"{'+inst' if inst else ''}"
                         f"{'+ext' if ext else ''}]"),
                    variant=(32 + ext * 8 + inst * 4 + nee * 2 + rr
                             if tri == 2 else ext * 16 + inst * 8 + tri * 4
                             + nee * 2 + rr))
        elif cur is not None and "stack frame" in ln \
                and props == cur["name"]:
            f = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                          ln)
            cur.update(stack=int(f.group(1)), spill_stores=int(f.group(2)))
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(smem.group(1)) if smem else 0
            del cur["name"]
            out.append(cur)
            cur = None
    return out


def ptxas_summary(lib: str, log: Path) -> str:
    """ptxas_table's instantiations as one line: registers, stack frame,
    spill stores and shared memory of each."""
    return "; ".join(f"{x['tag']} {x['registers']} registers, "
                     f"{x.get('stack', 0)} B stack, {x.get('spill_stores', 0)} "
                     f"B spill stores, {x['smem']} B smem"
                     for x in ptxas_table(lib, log))


def trace_instantiations() -> list:
    """Each trace instantiation's ptxas record (ptxas_table) with the
    persistent launch the runtime gives it (ops/trace.trace_config: grid,
    threads a block, resident blocks per SM, registers, local and shared
    memory); no trace instantiation stages tables in shared memory."""
    from parallelraytracing_tpu_torch.ops import _build
    from parallelraytracing_tpu_torch.ops.trace import trace_config
    table = {x["variant"]: x for x in ptxas_table(
        "trace", _build.library_path("trace").with_suffix(".log"))}
    return [{**table.get(v, {"variant": v}), **trace_config("cuda", v),
             "staged": False} for v in range(48)]


def segment_launch(r) -> dict:
    """The segment kernel's launch for wavefront_fused renderer r: its
    instantiation and what that runs with (engines/tables.trace_launch)."""
    from parallelraytracing_tpu_torch.engines.tables import trace_launch
    return trace_launch(r._tables, r.config, "segment")


def segment_instantiations() -> list:
    """Each segment instantiation's ptxas record (ptxas_table) with the
    persistent launch the runtime gives it (ops/segment.segment_config)."""
    from parallelraytracing_tpu_torch.ops import _build
    from parallelraytracing_tpu_torch.ops.segment import segment_config
    table = {x["variant"]: x for x in ptxas_table(
        "segment", _build.library_path("segment").with_suffix(".log"))}
    return [{**table.get(v, {"variant": v}), **segment_config("cuda", v)}
            for v in range(48)]


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


def kernel_vs_plain(r, tag: str, label: str = "nee-vs-plain") -> dict:
    """The trace kernel against the plain version through renderer r's
    tables and config (NEE and roulette as r runs them): every ray of
    depth 1 without jitter, every ray of frame 0 at r's depth with jitter
    (within RAY_ATOL on RAY_SHARE of them), and the films of
    NEE_FILM_FRAMES frames (HDR RMSE < FILM_RMSE).  Raises on a miss;
    returns the record for the kernels line."""
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    cfg = r.config
    k1, p1 = both_traces(r._tables, dataclasses.replace(cfg, max_depth=1),
                         *frame_inputs(r, 0, jitter=False))
    share1 = ray_share(k1, p1)
    inputs = frame_inputs(r, 0)
    k = traced_on(r, trace)(*inputs)
    p, plain_ms = timed_ms(lambda: traced_on(r, trace_reference)(*inputs))
    share = ray_share(k, p)
    err = max(float((k - p).abs().max()), float((k1 - p1).abs().max()))
    ms = cuda_ms(lambda: traced_on(r, trace)(*inputs), 5)
    del k1, p1
    acc_k, acc_p = k, p
    for f in range(1, NEE_FILM_FRAMES):
        inputs = frame_inputs(r, f)
        acc_k = acc_k + traced_on(r, trace)(*inputs)
        acc_p = acc_p + traced_on(r, trace_reference)(*inputs)
    rmse = float(((acc_k - acc_p) / NEE_FILM_FRAMES).pow(2).mean().sqrt())
    size = f"{cfg.width}x{cfg.height}"
    phase(label, f"{tag} {size}: depth 1 no jitter {share1:.6f} "
          f"of rays within {RAY_ATOL}; depth {cfg.max_depth} frame 0 "
          f"{share:.6f} within {RAY_ATOL}, max abs err {err:.3e}; "
          f"x{NEE_FILM_FRAMES} frames HDR RMSE {rmse:.3e}; trace kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms (frame 0)")
    if share1 < RAY_SHARE or share < RAY_SHARE or not rmse < FILM_RMSE:
        raise AssertionError(f"{tag}: trace kernel disagrees with plain")
    return dict(size=size, depth1_share=share1, share=share, max_abs_err=err,
                film_rmse=rmse, ms=ms, plain_ms=plain_ms)


def check_segments(r, tag: str) -> list:
    """Each segment of frame 0 of wavefront_fused renderer r at its real
    queue: the kernel and the plain version on the same input
    (queue_vs_plain, slots matched by pixel id), the kernel's queue and
    radiance carried on.  RAY_SHARE of the live slots' outcomes within
    RAY_ATOL, the alive plane (1, or NEE's 2) equal on every survivor and
    the same survivors, the keys exact.  Raises on a miss; returns one
    record each."""
    import torch
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        segmented_trace
    segs = []

    def checked(pix, state, count, rad, *tabs, **kw):
        rec, k, k_rad = queue_vs_plain(
            r, pix, state, count, kw["seed"], kw["depth0"], kw["n_bounces"],
            kw["sort_rays"], out=kw["out"])
        segs.append(rec)
        rad.copy_(torch.where(torch.isnan(k_rad), rad, k_rad))
        return k
    segmented_trace(r._tables, *frame_inputs(r, 0), r.config,
                    sort_rays=r.sort_rays, schedule=tuple(r.segment_lengths()),
                    seg_fn=checked)
    cfg = r.config
    for sg in segs:
        phase("segment-vs-plain", f"{tag} {cfg.width}x{cfg.height} frame 0, "
              f"segment of {sg['bounces']} bounces: {segment_line(sg)}")
        if not segment_agrees(sg):
            raise AssertionError(f"{tag}: segment kernel disagrees with plain")
    if len(segs) != len(r.segment_lengths()):
        raise AssertionError(f"{tag}: {len(segs)} segments checked, want "
                             f"{len(r.segment_lengths())}")
    return segs


def boundary_times(w, frames: int = 3) -> dict:
    """wavefront_fused renderer w's segment boundaries as its sort_rays
    runs them: each boundary's time in the frame (CUDA events from the end
    of one segment launch to the start of the next, mean over frames
    0..frames-1: the argsort and the two gathers, or nothing under ""),
    and, with a sort, each boundary's argsort and two gathers alone on
    frame 0's pushed queues (mean of 5)."""
    import torch
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        segmented_trace
    from parallelraytracing_tpu_torch.ops.segment import segment
    marks, kept = [], []

    def marked(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        res = segment(*a, **kw)
        end.record()
        marks.append((start, end))
        return res

    def keep(*a, **kw):
        res = segment(*a, **kw)
        if res[2] is not None:
            kept.append(tuple(x.clone() for x in res[:3]))
        return res

    def frame(f, fn):
        segmented_trace(w._tables, *frame_inputs(w, f), w.config,
                        sort_rays=w.sort_rays,
                        schedule=tuple(w.segment_lengths()), seg_fn=fn)
        torch.cuda.synchronize()
    gaps = []
    for f in range(frames):
        marks.clear()
        frame(f, marked)
        gaps.append([marks[i][1].elapsed_time(marks[i + 1][0])
                     for i in range(len(marks) - 1)])
    alone = []
    if w.sort_rays:
        frame(0, keep)
        for state, pix, key in kept:
            def boundary():
                order = torch.argsort(key, stable=True)
                return state.index_select(1, order), pix.index_select(0, order)
            alone.append(cuda_ms(boundary, 5))
    return dict(in_frame_ms=[sum(g[i] for g in gaps) / frames
                             for i in range(len(gaps[0]))],
                sort_gather_ms=alone)


#: the sort modes' records by scene (sort_modes_phase), and the frames
#: whose sample buffers are held bit-equal to the fused engine's
SORTS, BIT_FRAMES = {}, 2


def pixel_order(r, buf):
    """Renderer r's sample buffer in pixel order: the fused engine keeps
    its rays' (and film's) Morton order, buffer row j being pixel
    r._ids[j]; wavefront_fused's is in pixel order already."""
    if r.film_layout() is None:
        return buf
    out = buf.new_empty(buf.shape)
    out[r._ids.long()] = buf
    return out


def sort_modes_phase(w, f, tag: str) -> dict:
    """Each sort mode of wavefront_fused renderer w against fused renderer
    f on the same scene, size and config: the sample buffers of frames
    0..BIT_FRAMES-1 (what the film accumulates) bit-equal to f's; the
    segment boundaries timed (boundary_times); the frame timed (TIMED
    frames after WARMUP), beside f's.  w's sort_rays is restored.
    Raises unless every mode's buffers are bit-equal; returns the record
    (also kept in SORTS)."""
    import torch
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        SORT_MODES
    want = [pixel_order(f, f.render_sample_buffer(i))
            for i in range(BIT_FRAMES)]
    default, cfg = w.sort_rays, w.config
    rec = {}
    for mode in SORT_MODES:
        w.sort_rays = mode
        equal = all(torch.equal(w.render_sample_buffer(i), want[i])
                    for i in range(BIT_FRAMES))
        times = boundary_times(w)
        for _ in range(WARMUP):
            w.progressive_render()
        ms = cuda_ms(w.progressive_render, TIMED)
        rec[mode or "none"] = dict(bit_equal=equal, ms_per_frame=ms, **times)
        phase("sort-modes", f"{tag} {cfg.width}x{cfg.height} depth "
              f"{cfg.max_depth}, schedule {tuple(w.segment_lengths())}, "
              f"sort_rays {mode!r}: frames 0-{BIT_FRAMES - 1} bit-equal to "
              f"fused {equal}; boundaries in the frame " + " + ".join(
                  f"{x:.3f}" for x in times["in_frame_ms"]) + " ms"
              + ("; argsort + 2 gathers alone " + " + ".join(
                  f"{x:.3f}" for x in times["sort_gather_ms"]) + " ms"
                 if mode else "") + f"; {ms:.3f} ms/frame over {TIMED}")
    w.sort_rays = default
    for _ in range(WARMUP):
        f.progressive_render()
    rec["fused_ms_per_frame"] = cuda_ms(f.progressive_render, TIMED)
    phase("sort-modes", f"{tag}: fused {rec['fused_ms_per_frame']:.3f} "
          f"ms/frame over {TIMED}")
    if not all(rec[m or "none"]["bit_equal"] for m in SORT_MODES):
        raise AssertionError(f"{tag}: a sort mode's frame differs from "
                             f"the fused engine's")
    SORTS[tag] = rec
    return rec


#: phase 28: the live counts of the queue's edge cases (none, one, under
#: a warp, a warp and two more, a ragged count of blocks); the phase adds
#: the segment kernel's persistent grid's threads + 1
EDGE_COUNTS = (0, 1, 31, 33, 4101)


def queue_edge_phase(ply: str) -> dict:
    """Phase 28: the segment kernel's queue at its edges, on the level-5
    mesh (wavefront_fused, 1920x1080, depth 20) and CORNELL --nee
    --rr-depth 3: for each live count of EDGE_COUNTS and the persistent
    grid's threads + 1, the first segment of frame 0 over that prefix of
    the camera rays' queue equals the plain version bit for bit (each
    survivor's 13 planes, its pixel id and key, each ended path's
    radiance: queue_vs_plain), and a second launch gives the same
    survivors and radiance; then a whole frame into a radiance buffer
    filled with NaN leaves no NaN, and its segments end exactly one path
    per pixel.  Raises on a miss; returns the record."""
    import torch
    from parallelraytracing_tpu_torch.engines.tables import trace_launch
    from parallelraytracing_tpu_torch.engines.wavefront_fused import (
        _initial_state, segmented_trace)
    from parallelraytracing_tpu_torch.ops.segment import segment
    rec = dict(cases=[], frames={})
    for tag in ("mesh", "cornell nee rr"):
        if tag == "mesh":
            r, _ = mesh_renderer("wavefront_fused", ply, MAIN_W, MAIN_H,
                                 max_depth=MAIN_DEPTH, jitter=True)
        else:
            r, _ = make_renderer("cornell", MAIN_W, MAIN_H, "wavefront_fused",
                                 max_depth=MAIN_DEPTH, jitter=True, nee=True,
                                 russian_roulette_depth=RR_DEPTH)
        launch = trace_launch(r._tables, r.config, "segment")
        full = launch["grid"] * launch["threads"] + 1
        o, d, pix, seed = frame_inputs(r, 0)
        state = _initial_state(o, d)
        n_b = r.segment_lengths()[0]
        for n in EDGE_COUNTS + (full,):
            count = torch.full((1,), n, dtype=torch.int32, device="cuda")
            cmp, k, k_rad = queue_vs_plain(r, pix, state, count, seed, 0, n_b,
                                           r.sort_rays, reps=0)
            first = segment_outcomes(k, k_rad)
            _, k2, k2_rad = queue_vs_plain(r, pix, state, count, seed, 0, n_b,
                                           r.sort_rays, reps=0)
            again = segment_outcomes(k2, k2_rad)
            rec["cases"].append(dict(
                scene=tag, count=n, survivors=cmp["survivors"],
                plain_bit_equal=cmp["bit_equal"], key_exact=cmp["key_exact"],
                repeat_equal=bool(torch.equal(first.view(torch.int32),
                                              again.view(torch.int32)))))
        ends = []

        def counted(pix_, state_, count_, rad_, *tabs, **kw):
            res = segment(pix_, state_, count_, rad_, *tabs, **kw)
            ends.append(int(count_) - int(res[3]))
            return res
        rad = torch.full((MAIN_W * MAIN_H, 3), float("nan"), device="cuda")
        segmented_trace(r._tables, o, d, pix, seed, r.config,
                        sort_rays=r.sort_rays,
                        schedule=tuple(r.segment_lengths()), seg_fn=counted,
                        rad=rad)
        rec["frames"][tag] = dict(launch=launch, nan=int(torch.isnan(rad).sum()),
                                  ended=sum(ends), pixels=MAIN_W * MAIN_H,
                                  ended_by_segment=ends)
        del r, o, d, pix, state, rad
    bad = [c for c in rec["cases"] if not (c["plain_bit_equal"]
                                          and c["key_exact"]
                                          and c["repeat_equal"])]
    phase("queue-edges", f"mesh and cornell --nee --rr-depth {RR_DEPTH} "
          f"{MAIN_W}x{MAIN_H}, first segment over live counts {EDGE_COUNTS} "
          f"and the persistent grid's threads + 1: "
          f"{len(rec['cases']) - len(bad)} of {len(rec['cases'])} cases "
          f"bit-equal to the plain version and to a second launch; whole "
          f"frames into NaN-filled radiance: " + "; ".join(
              f"{k} {v['nan']} NaN left, {v['ended']} paths ended for "
              f"{v['pixels']} pixels" for k, v in rec["frames"].items()))
    if bad or any(v["nan"] or v["ended"] != v["pixels"]
                  for v in rec["frames"].values()):
        raise AssertionError(f"queue edges: {bad}, {rec['frames']}")
    return rec


def timed_path(r, film, tag: str, png_dir) -> dict:
    """A main path through its engine, as the CLI drives it: WARMUP
    frames, then every launch count set to 0, TIMED frames timed with
    CUDA events, the counts read; ms/frame, Msamples/s and Mrays/s over
    count_frame_rays (camera rays plus the rays entering each later
    bounce; NEE's shadow rays are not counted).  Raises unless the path
    launched only its own kernel (trace for fused, segment for
    wavefront_fused, once per segment); checks and writes the film."""
    import torch
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        count_frame_rays
    from parallelraytracing_tpu_torch.ops.rays import generate_camera_rays_ids
    from parallelraytracing_tpu_torch.ops.segment import segment
    from parallelraytracing_tpu_torch.ops.trace import trace
    rays = count_frame_rays(r._tables, *frame_inputs(r, 0), r.config)
    for _ in range(WARMUP):
        r.progressive_render()
    torch.cuda.synchronize()
    trace.launches = 0
    segment.launches = 0
    generate_camera_rays_ids.launches = 0
    ms = cuda_ms(r.progressive_render, TIMED)
    launches = dict(trace=trace.launches, segment=segment.launches,
                    raygen=generate_camera_rays_ids.launches)
    cfg = r.config
    samples = cfg.width * cfg.height * cfg.samples_per_frame
    wavefront = r.name == "wavefront_fused"
    phase("timed", f"{tag}: {r.name} {cfg.width}x{cfg.height} depth "
          f"{cfg.max_depth}, nee {r._tables.nee}, rr_depth "
          f"{cfg.russian_roulette_depth}: {ms:.3f} ms/frame, "
          f"{samples / ms / 1e3:.3f} Msamples/s, {rays / ms / 1e3:.3f} Mrays/s "
          f"({rays} rays in frame 0, shadow rays not counted) over {TIMED} "
          f"frames; launches {launches}")
    want = len(r.segment_lengths()) * TIMED if wavefront else None
    if (wavefront and (launches["segment"] != want or launches["trace"])) \
            or (not wavefront and (launches["trace"] < TIMED
                                   or launches["segment"])):
        raise AssertionError(f"{tag}: launches {launches} in {TIMED} frames")
    phase("timed", check_film(film, r._tables.sky[:3], tag, png_dir))
    return dict(engine=r.name, ms_per_frame=ms,
                msamples_per_s=samples / ms / 1e3, mrays_per_s=rays / ms / 1e3,
                rays=rays, launches=launches)


def nee_unbiased() -> dict:
    """NEE is unbiased and lowers the error on CORNELL (the bounds of
    tests/test_nee.py): a truth of TRUTH_FRAMES frames without NEE (seed
    7), NEE_FRAMES NEE frames (seed 0) and NEE_FRAMES frames without
    (seed 1), all through the fused engine on the card."""
    def film_of(frames, **cfg_kw):
        r, film = make_renderer("cornell", CMP_W, CMP_H, max_depth=MAIN_DEPTH,
                                **cfg_kw)
        for _ in range(frames):
            r.progressive_render()
        return film.hdr_average()
    truth = film_of(TRUTH_FRAMES, seed=7)
    nee = film_of(NEE_FRAMES, seed=0, nee=True)
    plain = film_of(NEE_FRAMES, seed=1)
    rel = float((nee.mean() - truth.mean()).abs() / truth.mean())
    rmse_nee = float((nee - truth).pow(2).mean().sqrt())
    rmse_plain = float((plain - truth).pow(2).mean().sqrt())
    phase("nee-unbiased", f"cornell {CMP_W}x{CMP_H} depth {MAIN_DEPTH}: "
          f"NEE x{NEE_FRAMES} mean {float(nee.mean()):.5f} vs truth "
          f"x{TRUTH_FRAMES} {float(truth.mean()):.5f} (rel {rel:.4f} < "
          f"{MEAN_REL}); RMSE to truth NEE {rmse_nee:.5f} vs no NEE "
          f"{rmse_plain:.5f} (ratio {rmse_nee / rmse_plain:.3f} < {RMSE_RATIO})")
    if not (rel < MEAN_REL and rmse_nee < RMSE_RATIO * rmse_plain):
        raise AssertionError("NEE is biased or does not lower the error")
    return dict(mean_rel=rel, rmse_nee=rmse_nee, rmse_plain=rmse_plain)


def depth_counts(r) -> list:
    """Rays entering each bounce of frame 0 of renderer r."""
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        count_depth_rays
    return count_depth_rays(r._tables, *frame_inputs(r, 0), r.config)


#: every trace bound from counted visits of the run, which phase 25 gives
#: the measured peaks
COUNTED = []


def probe_counts(r, inputs) -> dict:
    """The probe kernel's counters of one launch of renderer r on
    `inputs`, summed over the rays."""
    from parallelraytracing_tpu_torch.ops.trace import trace
    _, stats = traced_on(r, functools.partial(trace, collect_stats=True))(
        *inputs)
    return sum_counts(stats)


def trace_bounds(r, inputs, segments: int, ext_ops: float = 0.0,
                 tag: str = "") -> dict:
    """The bounds of one trace launch of renderer r on `inputs`: the walk
    shape's (``kernel_bound``: `segments` ray segments, the data sheet's
    peaks) and, under "counted", the counted visits' (the probe kernel's
    counters of the same launch; phase 25 adds the measured peaks); and
    under "launch" the instantiation it runs and its persistent launch
    (engines/tables.trace_launch)."""
    from parallelraytracing_tpu_torch.engines.tables import trace_launch
    n = int(inputs[0].shape[0])
    counted = counted_bound(r._tables, probe_counts(r, inputs), n,
                            TRACE_RAY_BYTES, ext_ops)
    counted["tag"] = tag
    COUNTED.append(counted)
    return dict(**kernel_bound(r._tables, segments, n * TRACE_RAY_BYTES,
                               ext_ops), counted=counted,
                launch=dict(trace_launch(r._tables, r.config),
                            staged=False))


#: every segment bound of the run (walk-shape operations, the data
#: sheet's rates), which phase 25 recomputes at the measured peaks
WALK = []


def segment_bounds(segs: list, t, counts: list, sort_rays: str,
                   first_ops: float = 0.0) -> list:
    """Add to each segment record of a frame (its "bounces", in order) the
    walk-shape bound (``kernel_bound``) of its launch over tables t and
    register it in WALK: its ray segments and queue bytes from the rays
    entering each bounce `counts` (live input slots: the rays entering its
    first bounce; survivors: those entering the next segment's, 0 at the
    frame's end; a key written with `sort_rays` except at the end);
    `first_ops`, the scene extensions' work, on the first segment.  The
    first record also keeps the byte count of the one-thread-per-slot
    form (every slot's 13 planes and pixel id read, 13 planes written)
    as ``slot_io_bytes``."""
    depth0 = 0
    for i, sg in enumerate(segs):
        end = depth0 + sg["bounces"]
        live, survivors = counts[depth0], counts[end] if end < len(counts) else 0
        io = segment_io_bytes(live, survivors, bool(sort_rays and survivors))
        sg.update(kernel_bound(t, sum(counts[depth0:end]), io,
                               first_ops if i == 0 else 0.0),
                  io_bytes=io, counted_live=live,
                  counted_survivors=survivors)
        WALK.append(sg)
        depth0 = end
    if segs:
        segs[0]["slot_io_bytes"] = counts[0] * (13 * 4 * 2 + 4)
    return segs


#: phase 23: each scene's probe records, and the rays sampled for the
#: plain replay
PROBES, PROBE_RAYS = {}, 256


def probe_check(r, tag: str) -> dict:
    """Phase 23 on fused renderer r: frame 0 through the probe kernel.  Its
    radiance equals the trace kernel's bit for bit, its depths sum to
    count_frame_rays' segments, and on PROBE_RAYS sampled rays its depths
    and counters equal the plain version's (its own bounce loop, the
    replay of ops/walk_stats.py); the probe and trace kernels timed (mean
    of 5 launches), and the counters summarised per ray and per warp
    (benchmarks/trace_stats.py).  Raises on a miss."""
    import torch
    from parallelraytracing_tpu_torch.benchmarks.trace_stats import summarize
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        count_frame_rays
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    inputs = frame_inputs(r, 0)
    o, d, pix, seed = inputs
    probe = traced_on(r, functools.partial(trace, depth_out=True,
                                           collect_stats=True))
    k = traced_on(r, trace)(*inputs)
    pk, depth, stats = probe(*inputs)
    rays = count_frame_rays(r._tables, *inputs, r.config)
    sel = torch.randperm(o.shape[0], generator=torch.Generator().manual_seed(
        0))[:PROBE_RAYS].to("cuda")
    sub = (o[sel].contiguous(), d[sel].contiguous(), pix[sel].contiguous(),
           seed)
    (p_rad, p_depth, p_stats), plain_ms = timed_ms(lambda: traced_on(
        r, functools.partial(trace_reference, depth_out=True,
                             collect_stats=True))(*sub))
    rec = dict(
        rad_equal=bool(torch.equal(pk, k)),
        max_abs_err=float((pk - k).abs().max()),
        plain_max_abs_err=float((p_rad - pk[sel]).abs().max()),
        depth_sum=int(depth.double().sum()), rays=rays,
        depth_equal=bool(torch.equal(p_depth, depth[sel])),
        stats_equal=bool(torch.equal(p_stats, stats[sel])),
        sampled=PROBE_RAYS, ms=cuda_ms(lambda: probe(*inputs), 5),
        trace_ms=cuda_ms(lambda: traced_on(r, trace)(*inputs), 5),
        plain_ms=plain_ms, cmp_ms=cuda_ms(lambda: probe(*sub), 5),
        counts=sum_counts(stats), summary=summarize(stats))
    cfg = r.config
    phase("probes", f"{tag} {cfg.width}x{cfg.height} depth {cfg.max_depth} "
          f"frame 0: probe radiance bit-equal to trace {rec['rad_equal']} "
          f"(max abs err {rec['max_abs_err']!r}); depth sum "
          f"{rec['depth_sum']} vs count_frame_rays {rays}; on {PROBE_RAYS} "
          f"rays depths equal {rec['depth_equal']}, counters equal the "
          f"replay {rec['stats_equal']} (plain {plain_ms:.1f} ms); probe "
          f"kernel {rec['ms']:.3f} ms vs trace {rec['trace_ms']:.3f} ms; "
          f"counts {rec['counts']}")
    sm = rec["summary"]
    phase("trace-stats", f"{tag}: per ray " + ", ".join(
        f"{k} mean {v['mean']:.2f} p50 {v['p50']:g} p90 {v['p90']:g} max "
        f"{v['max']}" for k, v in sm["per_ray"].items()) + "; per warp SIMT "
        "efficiency " + ", ".join(
        f"{k} {v['simt_efficiency']:.3f}" for k, v in sm["per_warp"].items()))
    if not (rec["rad_equal"] and rec["depth_sum"] == rays
            and rec["depth_equal"] and rec["stats_equal"]):
        raise AssertionError(f"{tag}: the probe kernel disagrees")
    PROBES[tag] = rec
    return rec


#: phase 26: the ray counts of the persistent trace kernel's edge cases
#: (none, one, under a warp, a warp and two more, a ragged count of
#: blocks); the phase adds the persistent grid's threads + 1
REGEN_RAYS = (0, 1, 31, 33, 4101)


def regeneration_phase(head) -> dict:
    """Phase 26: the persistent trace kernel regenerates paths without
    changing a bit.  On the headline and CORNELL --nee at MAIN_W x MAIN_H,
    depth 1 and MAIN_DEPTH, for each ray count of REGEN_RAYS and the
    persistent grid's threads + 1 (a prefix of frame 0's rays), the trace
    kernel's radiance equals the probe kernel's (one thread per ray)
    bit for bit and a second launch gives the same bits.  Then the
    headline renderer `head`'s trace kernel on frames 0 and 7 (mean of 5
    launches each), beside ``scene_records`` alone.  Raises on a miss;
    returns the record."""
    import torch
    from parallelraytracing_tpu_torch.engines.tables import trace_launch
    from parallelraytracing_tpu_torch.ops.pack import scene_records
    from parallelraytracing_tpu_torch.ops.trace import trace
    cases = []
    for preset, nee in (("random_balls_large", False), ("cornell", True)):
        for depth in (1, MAIN_DEPTH):
            r, _ = make_renderer(preset, MAIN_W, MAIN_H, max_depth=depth,
                                 nee=nee, jitter=True)
            launch = trace_launch(r._tables, r.config)
            o, d, pix, seed = frame_inputs(r, 0)
            full = launch["grid"] * launch["threads"] + 1
            kern = traced_on(r, trace)
            probe = traced_on(r, functools.partial(trace, depth_out=True))
            for n in REGEN_RAYS + (full,):
                args = (o[:n].contiguous(), d[:n].contiguous(),
                        pix[:n].contiguous(), seed)
                k1, k2, pk = kern(*args), kern(*args), probe(*args)[0]
                torch.cuda.synchronize()
                cases.append(dict(
                    scene=preset, nee=nee, depth=depth, rays=n,
                    probe_equal=bool(torch.equal(k1, pk)),
                    repeat_equal=bool(torch.equal(k1, k2)),
                    finite=bool(torch.isfinite(k1).all())))
            del o, d, pix, r
    bad = [c for c in cases if not (c["probe_equal"] and c["repeat_equal"]
                                    and c["finite"])]
    phase("regeneration", f"headline and cornell --nee {MAIN_W}x{MAIN_H} "
          f"depth 1 and {MAIN_DEPTH}, rays {REGEN_RAYS} and the persistent "
          f"grid's threads + 1: {len(cases) - len(bad)} of {len(cases)} "
          f"cases bit-equal to the probe kernel and to a second launch")
    if bad:
        raise AssertionError(f"regeneration: {bad}")
    t = head._tables
    frames = {}
    for f in (0, 7):
        inputs = frame_inputs(head, f)
        frames[f] = cuda_ms(lambda: traced_on(head, trace)(*inputs), 5)
    pack_ms = cuda_ms(lambda: scene_records(t), 5)
    phase("regeneration", f"headline trace kernel frame 0 {frames[0]:.3f} "
          f"ms, frame 7 {frames[7]:.3f} ms; scene_records alone "
          f"{pack_ms:.3f} ms")
    return dict(cases=cases, frame0_ms=frames[0], frame7_ms=frames[7],
                scene_records_ms=pack_ms)


#: phase 24: the depth_sort values driven on the headline
DEPTH_SORTS = (0, 1, 13)


def depth_sort_phase() -> dict:
    """Phase 24: the fused engine on the headline with each of
    DEPTH_SORTS.  Every launch count set to 0, the renderers made (each
    with depth_sort > 0 probes a frame) and NEE_FILM_FRAMES frames
    rendered, the counts read; the films bit-equal.  Then each timed as
    in phase 4 (ms/frame over TIMED frames), its trace kernel on frame 0
    and, with depth_sort > 0, the probe frame's seconds.  Raises on a
    miss; returns the record."""
    import torch
    from parallelraytracing_tpu_torch.ops.segment import segment
    from parallelraytracing_tpu_torch.ops.trace import trace
    trace.launches = trace.probe_launches = segment.launches = 0
    runs = {ds: make_renderer("random_balls_large", MAIN_W, MAIN_H,
                              attrs=dict(depth_sort=ds),
                              max_depth=MAIN_DEPTH, jitter=True)
            for ds in DEPTH_SORTS}
    for _ in range(NEE_FILM_FRAMES):
        for r, _ in runs.values():
            r.progressive_render()
    torch.cuda.synchronize()
    launches = dict(trace=trace.launches, probe=trace.probe_launches,
                    segment=segment.launches)
    hdr = {ds: film.hdr_average() for ds, (_, film) in runs.items()}
    equal = {ds: bool(torch.equal(hdr[ds], hdr[0])) for ds in DEPTH_SORTS}
    phase("depth-sort", f"random_balls_large {MAIN_W}x{MAIN_H} depth "
          f"{MAIN_DEPTH}: depth_sort {DEPTH_SORTS}, films of "
          f"{NEE_FILM_FRAMES} frames bit-equal to depth_sort 0: {equal}; "
          f"launches {launches}")
    want = len(DEPTH_SORTS) * NEE_FILM_FRAMES
    if not all(equal.values()) or launches["probe"] != len(DEPTH_SORTS) - 1 \
            or launches["trace"] != want or launches["segment"]:
        raise AssertionError(f"depth_sort: films {equal}, launches {launches}")
    del hdr
    rec = dict(launches=launches, films_equal=equal, modes={})
    for ds, (r, film) in runs.items():
        for _ in range(WARMUP):
            r.progressive_render()
        ms = cuda_ms(r.progressive_render, TIMED)
        inputs = frame_inputs(r, 0)
        k_ms = cuda_ms(lambda: traced_on(r, trace)(*inputs), 5)
        probe_s = None
        if ds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r._depth_reorder()
            torch.cuda.synchronize()
            probe_s = time.perf_counter() - t0
        rec["modes"][ds] = dict(ms_per_frame=ms, trace_ms=k_ms,
                                probe_frame_s=probe_s)
        phase("depth-sort", f"depth_sort {ds}: {ms:.3f} ms/frame over "
              f"{TIMED} frames, trace kernel {k_ms:.3f} ms (frame 0)"
              + (f", probe frame {probe_s:.3f} s" if ds else ""))
        del inputs
    del runs
    return rec


#: phase 25: the micro's bound against its plain version (relative: the
#: kernel's fmaf rounds once where the plain version rounds through
#: float64, a last-bit difference carried along a chain)
MICRO_REL = 1e-6
#: and its time at LOOPS over its time at LOOPS // 2: the chains drift by
#: less than MICRO_REL over a few iterations, so the time shows that every
#: iteration runs
LOOP_RATIO = (1.8, 2.2)


def micro_phase(smi: str) -> dict:
    """Phase 25: the float32 peak micro (benchmarks/micro.py) against its
    plain version at the timed launch's shape (x a ramp in [0.25, 1]) and
    its time at LOOPS against LOOPS // 2 (LOOP_RATIO), then timed with
    every launch count set to 0 first, the read rate, the SASS
    instruction counts; then every counted-visit trace bound of the run
    (COUNTED) at the measured peaks, beside the data sheet's bound and the
    walk-shape one, and every segment bound (WALK).  Raises on a miss;
    returns the record."""
    import torch
    from parallelraytracing_tpu_torch.benchmarks import micro
    x = torch.linspace(0.25, 1.0, micro.N_ELEMS, device="cuda")
    cmp = {}
    for mix in micro.MIXES:
        k = micro.peak_chains(x, micro.LOOPS, mix)
        p, plain_ms = timed_ms(lambda: micro.peak_chains_reference(
            x, micro.LOOPS, mix))
        cmp[mix] = dict(max_abs_err=float((k - p).abs().max()),
                        max_rel_err=float(((k - p).abs() / p.abs()).max()),
                        plain_ms=plain_ms)
    del x, k, p
    phase("micro-vs-plain", f"{micro.N_ELEMS} elements x {micro.LOOPS} "
          f"iterations: " + ", ".join(
              f"{m} max rel err {c['max_rel_err']:.3e} (< {MICRO_REL}), "
              f"plain {c['plain_ms']:.0f} ms" for m, c in cmp.items()))
    if max(c["max_rel_err"] for c in cmp.values()) >= MICRO_REL:
        raise AssertionError("the micro kernel disagrees with plain")
    ratio = {mix: micro.loop_ratio(mix) for mix in micro.MIXES}
    phase("micro-loops", f"time at {micro.LOOPS} iterations over the time "
          f"at {micro.LOOPS // 2}: " + ", ".join(
              f"{m} {v:.3f}" for m, v in ratio.items()) + f" (want "
          f"{LOOP_RATIO[0]}-{LOOP_RATIO[1]})")
    if not all(LOOP_RATIO[0] <= v <= LOOP_RATIO[1] for v in ratio.values()):
        raise AssertionError(f"the micro kernel skips iterations: {ratio}")
    micro.peak_chains.launches = 0
    rates = {}
    for mix in micro.MIXES:
        sec, ops = micro.fp32_peak(mix)
        rates[mix] = dict(ms=sec * 1e3, ops_per_s=ops / sec,
                          flop_per_s=micro.flops(mix, micro.LOOPS,
                                                 micro.N_ELEMS) / sec)
    launches = micro.peak_chains.launches
    read = micro.read_rate()
    sass = micro.sass_counts()
    peaks = dict(fma=rates["fma"]["ops_per_s"],
                 slab=rates["slab"]["ops_per_s"], bytes=read)
    phase("micro", f"{smi}: " + "; ".join(
        f"{m} {v['ms']:.3f} ms, {v['ops_per_s'] / 1e12:.2f} T ops/s "
        f"({v['flop_per_s'] / 1e12:.2f} TFLOP/s, a multiply-add as 2)"
        for m, v in rates.items()) + f"; read {read / 1e12:.3f} TB/s "
          f"({micro.READ_BYTES} bytes); launches {launches}; SASS {sass}")
    if launches < 2:
        raise AssertionError(f"micro: {launches} launches")
    for rec in COUNTED:
        rec.update(bound_from(rec["slab_ops"], rec["other_ops"],
                              rec["bytes"], peaks), peaks=peaks)
        phase("roofline", f"{rec['tag']}: counted visits {rec['counts']}: "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}) at the "
              f"measured peaks, {rec['datasheet_bound_ms']:.4f} ms at the "
              f"data sheet's")
    for rec in WALK:
        rec.update(bound_from(rec["slab_ops"], rec["other_ops"],
                              rec["bytes"], peaks), peaks=peaks)
    phase("roofline", f"{len(WALK)} segment launches' walk-shape bounds at "
          f"the measured peaks (at the data sheet's): " + ", ".join(
              f"{rec['bound_ms']:.4f} ({rec['datasheet_bound_ms']:.4f}) ms"
              for rec in WALK))
    return dict(vs_plain=cmp, loop_ratio=ratio, rates=rates,
                launches=launches, read_bytes_per_s=read, sass=sass,
                peaks=peaks)


def icosahedron():
    """The 20-triangle icosahedron, vertices on the unit sphere, flat
    normals: the stand-in for the reference's icosahedron.ply."""
    from parallelraytracing_tpu_torch.core.mesh import Mesh, icosphere
    ico = icosphere(0)
    return Mesh(ico.vertices, ico.indices)


def equirect_uv(mesh):
    """`mesh` (vertices on the unit sphere) with per-vertex texture
    coordinates u = 0.5 + atan2(z, x) / 2 pi, v = 0.5 + asin(y) / pi."""
    from parallelraytracing_tpu_torch.core.mesh import Mesh
    v = mesh.vertices.astype(np.float64)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    uv = np.stack([0.5 + np.arctan2(v[:, 2], v[:, 0]) / (2.0 * np.pi),
                   0.5 + np.arcsin(np.clip(v[:, 1], -1.0, 1.0)) / np.pi], 1)
    return Mesh(mesh.vertices, mesh.indices, mesh.normals,
                uv.astype(np.float32))


def multimesh_scene(bunny, ico, textured: bool = False):
    """bench.py's multimesh scene (multimesh_scene), through the port's
    API: the bunny twice, the icosahedron three times in glass and twice
    in red, over a 120x120 ground quad under an emissive sphere.
    `textured` (workload T3): the bunny's two copies in texture_demo's
    globe image at the equirectangular texture coordinates of
    ``equirect_uv``."""
    from parallelraytracing_tpu_torch import Scene
    from parallelraytracing_tpu_torch.core.scene import globe_image
    s = Scene(preset=None)
    if textured:
        bunny = equirect_uv(bunny)
        body = s.add_textured_lambertian(s.add_texture(globe_image()))
    else:
        body = s.add_lambertian((0.7, 0.6, 0.45))
    s.add_mesh_instances(bunny, body, [((6, 6, 6), (0, 160, 0), (0, 6, 0)),
                                       ((3, 3, 3), (0, 40, 0), (-12, 3, 6))])
    glass = s.add_dielectric(1.5)
    red = s.add_lambertian((0.8, 0.15, 0.1))
    s.add_mesh_instances(ico, glass, [((2.5,) * 3, (0, 30 * i, 0),
                                       (9 + 2.5 * i, 2.5, 8 - 3.0 * i))
                                      for i in range(3)])
    s.add_mesh_instances(ico, red, [((2,) * 3, (0, 15, 25), (-9, 2, 12)),
                                    ((1.5,) * 3, (30, 0, 0), (4, 1.5, 14))])
    s.add_quad(120, 120, s.add_lambertian((0.5, 0.5, 0.52)), None)
    s.add_sphere(3.5, s.add_emissive((11, 11, 10)),
                 ((1, 1, 1), (0, 0, 0), (14, 26, 14)))
    return s


def tlas_blas_scene(ico, baked: bool):
    """bench.py's tlas_blas gate scene (ico_scene): 4 icosahedron
    instances, or the same transforms baked with add_mesh."""
    from parallelraytracing_tpu_torch import Scene
    s = Scene(preset=None)
    red = s.add_lambertian((0.8, 0.15, 0.1))
    blue = s.add_lambertian((0.2, 0.3, 0.8))
    tfs = [(red, ((2.0,) * 3, (0, 30 * i, 0), (-4 + 4 * i, 2, 0)))
           for i in range(3)]
    tfs.append((blue, ((1.5,) * 3, (0, 15, 25), (0, 2, 5))))
    for mid, tf in tfs:
        if baked:
            s.add_mesh(ico, mid, tf)
        else:
            s.add_mesh_instances(ico, mid, [tf])
    s.add_quad(60, 60, s.add_lambertian((0.5, 0.5, 0.52)), None)
    return s


def scene_renderer(engine: str, scene, eye, direction, width: int,
                   height: int, attrs=None, **cfg_kw):
    from parallelraytracing_tpu_torch import (Camera, Film, RenderConfig,
                                              create_renderer)
    cfg = RenderConfig(width=width, height=height, **cfg_kw)
    film = Film(width, height, "cuda")
    r = create_renderer(engine, "cuda")
    for k, v in (attrs or {}).items():
        setattr(r, k, v)
    r.init(film, scene, Camera(np.asarray(eye, np.float64),
                               np.asarray(direction, np.float64),
                               float(width), float(height), 100.0), cfg)
    return r, film


def time_segments(r) -> list:
    """Each segment kernel launch of frame 0 of wavefront_fused renderer r,
    timed at its real queue (mean of 5 launches on the same input)."""
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        segmented_trace
    from parallelraytracing_tpu_torch.ops.segment import segment
    segs = []

    def timed(pix, state, count, rad, *tabs, **kw):
        ms = cuda_ms(lambda: segment(pix, state, count, rad, *tabs, **kw), 5)
        res = segment(pix, state, count, rad, *tabs, **kw)
        segs.append(dict(bounces=kw["n_bounces"], live=int(count),
                         survivors=int(res[3]), ms=ms))
        return res
    segmented_trace(r._tables, *frame_inputs(r, 0), r.config,
                    sort_rays=r.sort_rays, schedule=tuple(r.segment_lengths()),
                    seg_fn=timed)
    return segs


def instanced_phases(ply: str, png_dir) -> dict:
    """Phases 12-15: the instanced path.  Raises on any miss; returns the
    records for the kernels line."""
    import torch
    from parallelraytracing_tpu_torch.core.mesh import load_ply
    from parallelraytracing_tpu_torch.engines.wavefront_fused import (
        TRI_HEAVY, scene_triangles)
    from parallelraytracing_tpu_torch.ops.trace import trace
    rec = {}

    # 12. the scene, its tables and their memory
    t0 = time.perf_counter()
    bunny, ico = load_ply(ply), icosahedron()
    scene = multimesh_scene(bunny, ico)
    torch.cuda.reset_peak_memory_stats()
    cmp_kw = dict(max_depth=INST_CMP_DEPTH, jitter=True)
    f_r, f_film = scene_renderer("fused", scene, INST_EYE, INST_DIR, CMP_W,
                                 CMP_H, **cmp_kw)
    t = f_r._tables.inst
    n_inst, n_unique = t.n_inst, t.itri.shape[1]
    baked_tris = sum(hi - lo for lo, hi in t.ranges)
    inst_bytes = sum(x.numel() * 4 for x in (t.itri, t.iacc, t.ibox, t.inst))
    # baked flat tables: the (27, N) triangle table of every world copy and
    # at least the trees of every copy (one per instance)
    blas_nodes = {}
    roots = t.inst[0].tolist()
    ends = sorted(set(int(x) for x in roots)) + [t.iacc.shape[1]]
    for a, b in zip(ends, ends[1:]):
        blas_nodes[a] = b - a
    baked_bytes = 27 * 4 * baked_tris + 8 * 4 * sum(blas_nodes[int(x)]
                                                    for x in roots)
    n_bunny = 20 * 4 ** MESH_LEVEL
    if (n_inst, n_unique, baked_tris) != (7, n_bunny + 20, 2 * n_bunny + 100) \
            or f_r._tables.tri_live or f_r._scene_data.tri_valid.any():
        raise AssertionError(f"multimesh scene: {n_inst} instances, "
                             f"{n_unique} unique / {baked_tris} baked "
                             f"triangles")
    phase("instances", f"bench multimesh scene: {n_inst} instances of "
          f"{len(scene._inst_meshes)} unique meshes (level-{MESH_LEVEL} "
          f"icosphere for the bunny, 20-triangle icosahedron), {n_unique} "
          f"unique local triangles ({baked_tris} baked), built and packed in "
          f"{time.perf_counter() - t0:.2f} s; itri {tuple(t.itri.shape)}, "
          f"iacc {tuple(t.iacc.shape)}; instance tables {inst_bytes} bytes "
          f"vs >= {baked_bytes} bytes baked (27 x {baked_tris} triangle "
          f"columns + every copy's tree); base scene: no triangle")
    rec["memory"] = dict(instance_table_bytes=inst_bytes,
                         baked_table_bytes_at_least=baked_bytes,
                         unique_triangles=n_unique, baked_triangles=baked_tris)

    # 13. kernels vs plain at CMP_W x CMP_H, without and with NEE
    cmp = {}
    for nee in (False, True):
        tag = f"instances{' nee' if nee else ''}"
        r = f_r if not nee else scene_renderer(
            "fused", scene, INST_EYE, INST_DIR, CMP_W, CMP_H, nee=True,
            **cmp_kw)[0]
        if r._tables.nee != nee:
            raise AssertionError(f"{tag}: nee {r._tables.nee}")
        trace_rec = kernel_vs_plain(r, tag)
        w_r, _ = scene_renderer("wavefront_fused", scene, INST_EYE, INST_DIR,
                                CMP_W, CMP_H, nee=nee, **cmp_kw)
        seg_rec = segment_both(w_r)
        phase("segment-vs-plain", f"{tag} {CMP_W}x{CMP_H}, one 2-bounce "
              f"segment: {segment_line(seg_rec)}")
        if not segment_agrees(seg_rec):
            raise AssertionError(f"{tag}: segment kernel disagrees with plain")
        cmp["nee" if nee else "plain"] = dict(trace=trace_rec,
                                              segment=seg_rec)
        del w_r
    rec["vs_plain"] = cmp
    phase("instances", f"torch.cuda.max_memory_allocated() "
          f"{torch.cuda.max_memory_allocated()} bytes (phases 12-13)")

    # 14. the engines agree; instanced against baked
    w_r, w_film = scene_renderer("wavefront_fused", scene, INST_EYE, INST_DIR,
                                 CMP_W, CMP_H, **cmp_kw)
    f_r, f_film = scene_renderer("fused", scene, INST_EYE, INST_DIR, CMP_W,
                                 CMP_H, **cmp_kw)
    for _ in range(AGREE_FRAMES):
        w_r.progressive_render()
        f_r.progressive_render()
    diff = w_film.hdr_average() - f_film.hdr_average()
    agree = dict(rmse=float(diff.pow(2).mean().sqrt()),
                 max_abs=float(diff.abs().max()),
                 schedule=w_r.segment_lengths())
    phase("engines-agree", f"instances {CMP_W}x{CMP_H} depth {INST_CMP_DEPTH} "
          f"x{AGREE_FRAMES} frames: wavefront_fused {tuple(agree['schedule'])}"
          f" vs fused HDR RMSE {agree['rmse']:.3e}, max abs diff "
          f"{agree['max_abs']!r}")
    if not agree["rmse"] < FILM_RMSE:
        raise AssertionError("instances: wavefront_fused and fused disagree")
    rec["engines_agree"] = agree
    del w_r, w_film, f_r, f_film, diff
    # 27. the sort modes at 1920x1080: films bit-equal, boundaries timed
    sort_modes_phase(*(scene_renderer(e, scene, INST_EYE, INST_DIR, MAIN_W,
                                      MAIN_H, max_depth=INST_DEPTH,
                                      jitter=True)[0]
                       for e in ("wavefront_fused", "fused")), "instances")

    films = {}
    for baked in (False, True):
        r, film = scene_renderer(
            "fused", tlas_blas_scene(ico, baked), (0.0, 6.0, 16.0),
            (0.0, -4.0, -16.0), TLAS_W, TLAS_H, max_depth=TLAS_DEPTH, seed=0,
            samples_per_frame=TLAS_SPP)
        if (r._tables.inst is None) != baked:
            raise AssertionError("tlas_blas: the instanced render is baked")
        for _ in range(TLAS_FRAMES):
            r.progressive_render()
        films[baked] = film.hdr_average()
    tlas_rmse = float((films[False] - films[True]).pow(2).mean().sqrt())
    phase("instanced-vs-baked", f"bench tlas_blas scene {TLAS_W}x{TLAS_H} "
          f"depth {TLAS_DEPTH}, {TLAS_SPP} spp x {TLAS_FRAMES} frames through "
          f"the trace kernel: instanced vs baked (add_mesh) HDR RMSE "
          f"{tlas_rmse:.3e}, max abs diff "
          f"{float((films[False] - films[True]).abs().max())!r}")
    if not tlas_rmse < FILM_RMSE:
        raise AssertionError("tlas_blas: instanced and baked films disagree")
    rec["tlas_blas_rmse"] = tlas_rmse
    del films

    # 15. the instanced path at 1920x1080, depth 8: kernels on frame 0,
    # then timed
    paths = {}
    for engine in ("wavefront_fused", "fused"):
        for nee in (False, True):
            tag = f"instances_{engine}{'_nee' if nee else ''}"
            r, film = scene_renderer(engine, scene, INST_EYE, INST_DIR,
                                     MAIN_W, MAIN_H, max_depth=INST_DEPTH,
                                     jitter=True, nee=nee)
            counts = depth_counts(r)
            if engine == "fused":
                inputs = frame_inputs(r, 0)
                k_ms = cuda_ms(lambda: traced_on(r, trace)(*inputs), 5)
                kern = dict(ms=k_ms, **trace_bounds(r, inputs, sum(counts),
                                                    tag=tag))
                detail = f"trace kernel {k_ms:.3f} ms"
                probe_check(r, tag)  # 23. the probes on the instances
                del inputs
            else:
                segs = segment_bounds(time_segments(r), r._tables, counts,
                                      r.sort_rays)
                kern = dict(segments=segs, launch=segment_launch(r))
                detail = "segment kernels " + " + ".join(
                    f"{sg['ms']:.3f}" for sg in segs) + " ms"
            phase("instances-kernels", f"{tag} {MAIN_W}x{MAIN_H} depth "
                  f"{INST_DEPTH} frame 0: {detail}; rays entering each "
                  f"bounce {counts}")
            p = timed_path(r, film, tag, png_dir)
            p.update(spp64_wall_s=64.0 * p["ms_per_frame"] / 1000.0,
                     schedule=(r.segment_lengths() if engine != "fused"
                               else None), nee=nee, kernels=kern)
            phase("timed", f"{tag}: bench spp64_wall_s "
                  f"{p['spp64_wall_s']:.3f} s (64 x ms/frame)"
                  + (f", schedule {tuple(p['schedule'])}" if p['schedule']
                     else ""))
            want = [2, INST_DEPTH - 2] \
                if scene_triangles(scene) > TRI_HEAVY else [3, 3, 2]
            if engine == "wavefront_fused" and p["schedule"] != want:
                raise AssertionError(f"{tag}: schedule {p['schedule']}, "
                                     f"want the JAX engine's {want}")
            paths[tag] = p
            del r, film
    rec["paths"] = paths
    phase("instances", f"torch.cuda.max_memory_allocated() "
          f"{torch.cuda.max_memory_allocated()} bytes (phases 12-15)")
    return rec


def camera_hit_counts(r) -> dict:
    """Frame 0's camera rays of renderer r by what they hit, counted by one
    depth-1 launch of the trace kernel on a probe copy of r's tables in
    which every material is an emitter whose emission marks it (red 1 an
    image texture off a sphere, blue 2 an image on a sphere, green 1 a
    checker) under a sky of blue 1.  Returns the counts of image hits off
    spheres, image hits on spheres, checker hits and misses."""
    import torch
    from parallelraytracing_tpu_torch.core.scene import MAT_EMISSIVE
    from parallelraytracing_tpu_torch.ops.trace import trace
    t, cfg = r._tables, r.config
    n = t.mats.shape[1]
    image = torch.zeros(n + 1, device="cuda")
    checker = torch.zeros(n + 1, device="cuda")
    for c in t.checker:
        checker[int(c[0])] = 1.0
    for m in t.itex:
        image[int(m[0])] = 1.0
    sph = t.sph.clone()
    sph[4] = torch.where(image[sph[4].long()] > 0, float(n), sph[4])
    mats = torch.zeros((5, n + 1), device="cuda")
    mats[0] = MAT_EMISSIVE
    mats[1, :n] = image[:n]
    mats[2] = checker
    mats[3, n] = 2.0
    o, d, pix, seed = frame_inputs(r, 0)
    out = trace(o, d, pix, seed, dataclasses.replace(
        t, sph=sph, mats=mats, sky=(0.0, 0.0, 1.0), nee=False, checker=(),
        itex=(), itex_tab=None, records=None),
        cfg.replace(max_depth=1, russian_roulette_depth=0))
    return dict(image=int((out[:, 0] == 1.0).sum()),
                sphere_image=int((out[:, 2] == 2.0).sum()),
                checker=int((out[:, 1] == 1.0).sum()),
                miss=int((out[:, 2] == 1.0).sum()))


def extension_ops(r) -> tuple:
    """(operations, hit counts): the scene extensions' work on frame 0's
    camera rays of renderer r (camera_hit_counts), a lower bound: the
    later bounces' textured hits and sky misses are not counted."""
    c = camera_hit_counts(r)
    ops = c["image"] * TEX_OPS + c["sphere_image"] * (TEX_OPS + SPH_UV_OPS) \
        + c["checker"] * CHECKER_OPS
    if len(r._tables.sky) == 13:
        ops += c["miss"] * SKY_OPS
    return float(ops), c


def ext_kernel_record(kernel: str, ext: dict) -> dict:
    """The kernels-line entry of the scene extensions' instantiations of
    `kernel` (trace or segment): launches over T1's timed frames (fused
    for the trace, wavefront_fused for the segment), the kernel's time on
    T1's frame 0 at MAIN_W x MAIN_H and its bound there (the first segment
    for the segment kernel), the plain version's time at CMP_W x CMP_H
    beside the kernel's at that size, and the largest error over every
    comparison of phase 17."""
    cmp = ext["vs_plain"]
    t1 = cmp["T1"][kernel]
    if kernel == "trace":
        path = ext["paths"]["T1_fused"]
        timed = path["kernels"]
        source, replaces = SOURCE, REPLACES
    else:
        path = ext["paths"]["T1_wavefront_fused"]
        timed = path["kernels"]["segments"][0]
        source, replaces = SEG_SOURCE, SEG_REPLACES
    bound = timed["counted"] if kernel == "trace" else timed
    return {
        "name": f"{kernel}[ext]", "route": "cuda", "source": source,
        "replaces": replaces, "launches": path["launches"][kernel],
        "max_abs_err": max(c[kernel]["max_abs_err"] for c in cmp.values()),
        "ms": timed["ms"], "plain_ms": t1["plain_ms"],
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": None,
        "size": f"the {kernel} kernel's scene-extension instantiations "
                f"(kExt): ms, bound and launches on T1 (texture_demo) "
                f"{MAIN_W}x{MAIN_H}, frame 0 (launches over its {TIMED} "
                f"timed frames); plain_ms and cmp_ms on T1 at {CMP_W}x"
                f"{CMP_H}, frame 0; max_abs_err over T1 (with and without "
                f"NEE, QMC + thin lens), T2 and T3 at {CMP_W}x{CMP_H}; "
                f"library_ms null: no single PyTorch call computes it",
        "cmp_ms": t1["ms"], "bound": timed, "vs_plain": cmp,
        "launch": (timed if kernel == "trace" else path["kernels"])["launch"],
        **({} if kernel == "trace" else {"segment_bounds_ms": [
            sg["bound_ms"] for sg in path["kernels"]["segments"]]}),
        "engines_agree": ext["engines_agree"],
        "paths": {k: v for k, v in ext["paths"].items()
                  if ("wavefront" in k) == (kernel == "segment")}}


def extension_phases(bunny, png_dir) -> dict:
    """Phases 17-19: the scene extensions, workloads T1 (texture_demo), T2
    (sky_demo) and T3 (the instanced multimesh scene with its bunny
    stand-in textured).  Raises on any miss; returns the records for the
    kernels line."""
    import torch
    from parallelraytracing_tpu_torch import Scene, ScenePreset
    from parallelraytracing_tpu_torch.ops.trace import trace
    ico = icosahedron()
    t3 = multimesh_scene(bunny, ico, textured=True)
    eye = np.asarray(PRESET_EYE, np.float64)
    look = np.asarray(PRESET_LOOK, np.float64)

    def renderer(wl, engine, width, height, depth=INST_DEPTH, **cfg_kw):
        if wl == "T3":
            return scene_renderer(engine, t3, INST_EYE, INST_DIR, width,
                                  height, max_depth=depth, jitter=True,
                                  **cfg_kw)
        scene = Scene(ScenePreset({"T1": "texture_demo",
                                   "T2": "sky_demo"}[wl]))
        return scene_renderer(engine, scene, eye, look - eye, width, height,
                              max_depth=MAIN_DEPTH, jitter=True, **cfg_kw)

    lens = dict(lens_radius=LENS_RADIUS, focus_distance=FOCUS_DISTANCE)
    opts = {"": {}, "nee": dict(nee=True), "lens": lens,
            "qmc+lens": dict(qmc=True, **lens)}
    rec = {}

    # 17. kernels vs plain at CMP_W x CMP_H
    cmp = {}
    for wl, opt in (("T1", ""), ("T1", "nee"), ("T1", "qmc+lens"),
                    ("T2", ""), ("T3", "")):
        tag = f"{wl}{' ' + opt if opt else ''}"
        r, _ = renderer(wl, "fused", CMP_W, CMP_H, INST_CMP_DEPTH, **opts[opt])
        t = r._tables
        if not (t.checker or t.itex or len(t.sky) == 13) \
                or (wl == "T3" and t.inst.itri.shape[0] != 31):
            raise AssertionError(f"{tag}: the scene extensions are not on")
        trace_rec = kernel_vs_plain(r, tag, "ext-vs-plain")
        w_r, _ = renderer(wl, "wavefront_fused", CMP_W, CMP_H, INST_CMP_DEPTH,
                          **opts[opt])
        seg_rec = segment_both(w_r)
        phase("ext-segment-vs-plain", f"{tag} {CMP_W}x{CMP_H}, one 2-bounce "
              f"segment: {segment_line(seg_rec)}")
        if not segment_agrees(seg_rec):
            raise AssertionError(f"{tag}: segment kernel disagrees with plain")
        cmp[tag] = dict(trace=trace_rec, segment=seg_rec)
        del r, w_r
    rec["vs_plain"] = cmp

    # 18. the engines agree
    agree = {}
    for wl in ("T1", "T3"):
        (w_r, w_film), (f_r, f_film) = (
            renderer(wl, e, CMP_W, CMP_H) for e in ("wavefront_fused",
                                                    "fused"))
        for _ in range(AGREE_FRAMES):
            w_r.progressive_render()
            f_r.progressive_render()
        diff = w_film.hdr_average() - f_film.hdr_average()
        agree[wl] = dict(rmse=float(diff.pow(2).mean().sqrt()),
                         max_abs=float(diff.abs().max()),
                         schedule=w_r.segment_lengths())
        phase("ext-engines-agree", f"{wl} {CMP_W}x{CMP_H} x{AGREE_FRAMES} "
              f"frames: wavefront_fused {tuple(agree[wl]['schedule'])} vs "
              f"fused HDR RMSE {agree[wl]['rmse']:.3e}, max abs diff "
              f"{agree[wl]['max_abs']!r}")
        if not agree[wl]["rmse"] < FILM_RMSE:
            raise AssertionError(f"{wl}: wavefront_fused and fused disagree")
        del w_r, f_r, w_film, f_film, diff
    rec["engines_agree"] = agree
    # 27. the sort modes on T1 at 1920x1080
    sort_modes_phase(*(renderer("T1", e, MAIN_W, MAIN_H)[0]
                       for e in ("wavefront_fused", "fused")), "T1")

    # 19. T1-T3 timed at MAIN_W x MAIN_H
    paths = {}
    for wl, engine, opt in (("T1", "fused", ""), ("T1", "wavefront_fused", ""),
                            ("T1", "fused", "lens"),
                            ("T1", "fused", "qmc+lens"),
                            ("T1", "fused", "nee"), ("T2", "fused", ""),
                            ("T2", "wavefront_fused", ""), ("T3", "fused", ""),
                            ("T3", "wavefront_fused", "")):
        tag = f"{wl}_{engine}{'_' + opt.replace('+', '_') if opt else ''}"
        r, film = renderer(wl, engine, MAIN_W, MAIN_H, **opts[opt])
        counts = depth_counts(r)
        ext_ops, hits = extension_ops(r)
        if engine == "fused":
            inputs = frame_inputs(r, 0)
            k_ms = cuda_ms(lambda: traced_on(r, trace)(*inputs), 5)
            kern = dict(ms=k_ms, **trace_bounds(r, inputs, sum(counts),
                                                ext_ops, tag=tag))
            detail = (f"trace kernel {k_ms:.3f} ms, bound {kern['bound_ms']:.4f}"
                      f" ms ({kern['bound_by']}), {kern['bound_ms'] / k_ms:.1%}"
                      f" of it")
            del inputs
        else:
            segs = segment_bounds(time_segments(r), r._tables, counts,
                                  r.sort_rays, ext_ops)
            kern = dict(segments=segs, launch=segment_launch(r))
            detail = "segment kernels " + " + ".join(
                f"{sg['ms']:.3f}" for sg in segs) + " ms, bounds " + " + ".join(
                f"{sg['bound_ms']:.4f}" for sg in segs) + " ms"
        phase("ext-kernels", f"{tag} {MAIN_W}x{MAIN_H} depth "
              f"{r.config.max_depth} frame 0: {detail}; camera rays' hits "
              f"{hits}; rays entering each bounce {counts}")
        p = timed_path(r, film, tag, png_dir)
        p.update(kernels=kern, hits=hits, schedule=(
            r.segment_lengths() if engine != "fused" else None))
        paths[tag] = p
        del r, film
    rec["paths"] = paths
    phase("ext", f"torch.cuda.max_memory_allocated() "
          f"{torch.cuda.max_memory_allocated()} bytes (phases 17-19)")
    return rec


@contextlib.contextmanager
def shared_tables():
    """Within the block, the engines' renderers of one scene share its
    packed tables: ``build_scene_tables`` is memoized on (scene, device,
    ops/pack.py's STREAM_THRESHOLD and STREAM_CHUNK), with NEE set per
    call as it sets it (on when asked and the scene has a light).  Packing
    a big mesh takes seconds, and the tables do not depend on the engine.
    Yields the memo: key -> (scene, tables, scene data, has a light,
    seconds of the packing call)."""
    from parallelraytracing_tpu_torch.engines import tables as tmod
    from parallelraytracing_tpu_torch.ops import pack
    from parallelraytracing_tpu_torch.ops.nee import extract_lights
    orig = tmod.build_scene_tables
    memo = {}

    def build(scene, device, nee=False):
        key = (id(scene), str(device), pack.STREAM_THRESHOLD,
               pack.STREAM_CHUNK)
        if key not in memo:
            t0 = time.perf_counter()
            t, sd = orig(scene, device)
            lit = extract_lights(sd.numpy()) is not None
            memo[key] = (scene, t, sd, lit, time.perf_counter() - t0)
        _, t, sd, lit, _ = memo[key]
        return dataclasses.replace(t, nee=bool(nee and lit)), sd
    tmod.build_scene_tables = build
    try:
        yield memo
    finally:
        tmod.build_scene_tables = orig


def big_mesh_scene(level: int):
    """bench.py's big-mesh scene (big_mesh_scene) with the icosphere of
    `level` (20 x 4 ** level triangles, smooth vertex normals) for the
    subdivided dragon scan, which is not in the repo: the mesh scaled 8,
    turned 180 degrees about y and lifted 8, over a 100x100 ground quad,
    under an emissive sphere of radius 3.  Returns (scene, seconds)."""
    from parallelraytracing_tpu_torch import Scene
    from parallelraytracing_tpu_torch.core.mesh import icosphere
    t0 = time.perf_counter()
    mesh = icosphere(level)
    s = Scene(preset=None)
    s.add_mesh(mesh, s.add_lambertian((0.75, 0.65, 0.5)),
               ((8, 8, 8), (0, 180, 0), (0, 8, 0)))
    s.add_quad(100, 100, s.add_lambertian((0.5, 0.5, 0.5)), None)
    s.add_sphere(3.0, s.add_emissive((12, 12, 12)),
                 ((1, 1, 1), (0, 0, 0), (12, 25, 12)))
    return s, time.perf_counter() - t0


@contextlib.contextmanager
def stream_constants(threshold=None, chunk=None):
    """ops/pack.py's STREAM_THRESHOLD and STREAM_CHUNK set to `threshold`
    and `chunk` (where given) within the block."""
    from parallelraytracing_tpu_torch.ops import pack
    old = pack.STREAM_THRESHOLD, pack.STREAM_CHUNK
    pack.STREAM_THRESHOLD = old[0] if threshold is None else threshold
    pack.STREAM_CHUNK = old[1] if chunk is None else chunk
    try:
        yield
    finally:
        pack.STREAM_THRESHOLD, pack.STREAM_CHUNK = old


#: a stream threshold no scene passes: the dense layout
DENSE = 1 << 30


def big_renderer(engine: str, scene, nee: bool = False, width=BIG_W,
                 height=BIG_H, threshold=None, chunk=None):
    """A renderer of `engine` on a big-mesh scene at bench's camera, depth
    BIG_DEPTH, jitter on, its tables packed at the stream `threshold` and
    `chunk` (ops/pack.py's constants where not given)."""
    from parallelraytracing_tpu_torch import (Camera, Film, RenderConfig,
                                              create_renderer)
    film = Film(width, height, "cuda")
    r = create_renderer(engine, "cuda")
    with stream_constants(threshold, chunk):
        r.init(film, scene, Camera(np.asarray(BIG_EYE, np.float64),
                                   np.asarray(BIG_DIR, np.float64),
                                   float(width), float(height), 100.0),
               RenderConfig(width=width, height=height, max_depth=BIG_DEPTH,
                            jitter=True, nee=nee))
    return r, film


def sampled_rays(r, jitter=None):
    """BIG_RAYS camera rays of frame 0 of renderer r, drawn at random (a
    fixed seed) from the frame's: (o, d, pixel ids, path seed)."""
    import torch
    o, d, pix, seed = frame_inputs(r, 0, jitter)
    sel = torch.randperm(o.shape[0], generator=torch.Generator().manual_seed(
        0))[:BIG_RAYS].to("cuda")
    return o[sel].contiguous(), d[sel].contiguous(), pix[sel].contiguous(), seed


def segment_vs_plain(w, rays) -> dict:
    """One 2-bounce segment of wavefront_fused renderer w from camera
    `rays` (o, d, pixel ids, path seed), every slot live, through the
    segment kernel and its plain version: queue_vs_plain's record."""
    import torch
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        _initial_state
    o, d, pix, seed = rays
    count = torch.full((1,), o.shape[0], dtype=torch.int32, device="cuda")
    rec = queue_vs_plain(w, pix, _initial_state(o, d), count, seed, 0, 2,
                         w.sort_rays)[0]
    return dict(rec, slots=int(o.shape[0]))


def full_frame_vs_plain(r, w, tag: str) -> dict:
    """The stream instantiations against their plain versions on every
    camera ray of frame 0 (BIG_W x BIG_H): fused renderer r's trace at
    depth 1 without jitter (within RAY_ATOL on RAY_SHARE of the rays) and
    one 2-bounce segment of wavefront_fused renderer w over the full queue
    (all 13 planes within RAY_ATOL on RAY_SHARE of the slots, the alive
    plane equal).  Raises on a miss; returns the record."""
    cfg1 = dataclasses.replace(r.config, max_depth=1)
    (k, p), both_ms = timed_ms(lambda: both_traces(
        r._tables, cfg1, *frame_inputs(r, 0, jitter=False)))
    sg = segment_vs_plain(w, frame_inputs(w, 0))
    rec = dict(rays=int(k.shape[0]), depth1_share=ray_share(k, p),
               max_abs_err=float((k - p).abs().max()), trace_both_ms=both_ms,
               segment=sg)
    phase("stream-vs-plain", f"{tag}, all {rec['rays']} camera rays of frame "
          f"0: trace depth 1 no jitter {rec['depth1_share']:.6f} within "
          f"{RAY_ATOL}, max abs err {rec['max_abs_err']:.3e} (kernel and "
          f"plain {both_ms / 1e3:.1f} s); 2-bounce segment over the full "
          f"queue: {segment_line(sg)}")
    if rec["depth1_share"] < RAY_SHARE or not segment_agrees(sg):
        raise AssertionError(f"{tag}: a stream kernel disagrees with plain "
                             f"on the whole frame")
    return rec


def stream_vs_plain(r, w, tag: str) -> dict:
    """The stream instantiations against their plain versions on BIG_RAYS
    camera rays of fused renderer r and wavefront_fused renderer w: the
    trace at depth 1 without jitter and at BIG_DEPTH with jitter (within
    RAY_ATOL on RAY_SHARE of the rays), and one 2-bounce segment from the
    jittered rays (all 13 planes within RAY_ATOL on RAY_SHARE of the
    slots, the alive plane equal).  Raises on a miss; returns the
    record."""
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    if r._tables.stream is None or not r._tables.tri_live \
            or w._tables.stream is None:
        raise AssertionError(f"{tag}: the mesh is not on the stream route")
    cfg = r.config
    k1, p1 = both_traces(r._tables, dataclasses.replace(cfg, max_depth=1),
                         *sampled_rays(r, jitter=False))
    inputs = sampled_rays(r)
    k = traced_on(r, trace)(*inputs)
    p, plain_ms = timed_ms(lambda: traced_on(r, trace_reference)(*inputs))
    ms = cuda_ms(lambda: traced_on(r, trace)(*inputs), 5)
    sg = segment_vs_plain(w, sampled_rays(w))
    rec = dict(depth1_share=ray_share(k1, p1), share=ray_share(k, p),
               max_abs_err=max(float((k - p).abs().max()),
                               float((k1 - p1).abs().max())),
               ms=ms, plain_ms=plain_ms, rays=BIG_RAYS, segment=sg)
    phase("stream-vs-plain", f"{tag}, {BIG_RAYS} camera rays: trace depth 1 "
          f"no jitter {rec['depth1_share']:.6f} within {RAY_ATOL}, depth "
          f"{cfg.max_depth} {rec['share']:.6f}, max abs err "
          f"{rec['max_abs_err']:.3e}, kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; 2-bounce segment: {segment_line(sg)}")
    if min(rec["depth1_share"], rec["share"]) < RAY_SHARE \
            or not segment_agrees(sg):
        raise AssertionError(f"{tag}: a stream kernel disagrees with plain")
    return rec


def films_of(renderers, frames: int) -> list:
    """The HDR films of `frames` frames of each (renderer, film)."""
    for _ in range(frames):
        for r, _ in renderers:
            r.progressive_render()
    return [film.hdr_average() for _, film in renderers]


def kernel_times(r, counts, tag: str) -> dict:
    """Frame 0's kernel launches of renderer r at its size, timed (mean of
    5 launches at the real queue), each with its bound over the frame's
    ray counts per bounce `counts`."""
    from parallelraytracing_tpu_torch.ops.trace import trace
    cfg = r.config
    if r.name == "fused":
        inputs = frame_inputs(r, 0)
        k_ms = cuda_ms(lambda: traced_on(r, trace)(*inputs), 5)
        kern = dict(ms=k_ms, **trace_bounds(r, inputs, sum(counts), tag=tag))
        detail = (f"trace kernel {k_ms:.3f} ms, bound {kern['bound_ms']:.4f} "
                  f"ms ({kern['bound_by']}), {kern['bound_ms'] / k_ms:.1%} of "
                  f"it")
    else:
        segs = segment_bounds(time_segments(r), r._tables, counts,
                              r.sort_rays)
        kern = dict(segments=segs, launch=segment_launch(r))
        detail = "segment kernels " + " + ".join(
            f"{sg['ms']:.3f}" for sg in segs) + " ms, bounds " + " + ".join(
            f"{sg['bound_ms']:.4f}" for sg in segs) + " ms"
    phase("stream-kernels", f"{tag} {cfg.width}x{cfg.height} depth "
          f"{cfg.max_depth} frame 0: {detail}; rays entering each bounce "
          f"{counts}")
    return kern


def big_level(level: int, png_dir, sweep: bool) -> dict:
    """Phase 21 (level 7) or 22 (level 8): bench's big-mesh scene at the
    default stream route: its build and pack, table bytes, both stream
    kernels against their plain versions, the two engines' films, then
    wavefront_fused and fused, each with and without NEE, timed as in
    phase 8 (ms/frame, Mrays/s, kernel ms and share of bound).  With
    `sweep` (--stream-sweep), ``chunk_sweep``.  Raises on any miss."""
    import torch
    name = f"level{level}"
    torch.cuda.reset_peak_memory_stats()
    scene, build_s = big_mesh_scene(level)
    rec = {}
    with shared_tables() as memo:
        f_r, _ = big_renderer("fused", scene)
        (_, t, _, _, pack_s), = memo.values()
        n_tri = 20 * 4 ** level
        rec["tables"] = dict(
            triangles=n_tri, scene_build_s=build_s, build_tables_s=pack_s,
            table_bytes=table_bytes(t), slots=int(t.tri.shape[1]),
            chunk=t.stream.chunk, node_rows=t.stream.node_rows,
            top_nodes=int(t.tri_cl.shape[1]))
        phase(name, f"bench big-mesh scene, icosphere level {level} ({n_tri} "
              f"triangles): add_mesh {build_s:.2f} s; build_scene_tables "
              f"(Scene.build, pack, upload) {pack_s:.2f} s; stream route, "
              f"chunk {t.stream.chunk}, node_rows {t.stream.node_rows}: tri "
              f"{tuple(t.tri.shape)}, top tree {tuple(t.tri_cl.shape)}, "
              f"mini-trees {tuple(t.stream.mini.shape)}; table bytes "
              f"{table_bytes(t)}")
        w_r, _ = big_renderer("wavefront_fused", scene)
        cmp = {"plain": stream_vs_plain(f_r, w_r, f"{name}")}
        cmp["nee"] = stream_vs_plain(big_renderer("fused", scene, True)[0],
                                     big_renderer("wavefront_fused", scene,
                                                  True)[0], f"{name} nee")
        rec["vs_plain"] = cmp
        del f_r, w_r
        films = films_of([big_renderer(e, scene) for e in ("fused",
                                                           "wavefront_fused")],
                         BIG_FRAMES)
        diff = films[0] - films[1]
        agree = dict(rmse=float(diff.pow(2).mean().sqrt()),
                     max_abs=float(diff.abs().max()))
        phase("engines-agree", f"{name} {BIG_W}x{BIG_H} depth {BIG_DEPTH} "
              f"x{BIG_FRAMES} frames: wavefront_fused vs fused HDR RMSE "
              f"{agree['rmse']:.3e}, max abs diff {agree['max_abs']!r}")
        if not agree["rmse"] < FILM_RMSE:
            raise AssertionError(f"{name}: wavefront_fused and fused disagree")
        rec["engines_agree"] = agree
        del films, diff
        # 27. the sort modes at BIG_W x BIG_H
        sort_modes_phase(*(big_renderer(e, scene)[0]
                           for e in ("wavefront_fused", "fused")), name)
        paths = {}
        for engine in ("wavefront_fused", "fused"):
            for nee in (False, True):
                tag = f"{name}_{engine}{'_nee' if nee else ''}"
                r, film = big_renderer(engine, scene, nee)
                counts = depth_counts(r)
                kern = kernel_times(r, counts, tag)
                if engine == "fused" and level == 7:
                    probe_check(r, tag)  # 23. the probes on the stream route
                p = timed_path(r, film, tag, png_dir)
                p.update(kernels=kern, nee=nee, schedule=(
                    r.segment_lengths() if engine != "fused" else None))
                paths[tag] = p
                del r, film
        rec["paths"] = paths
        if sweep:
            rec["chunk_sweep"] = chunk_sweep(scene, memo)
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        phase(name, f"torch.cuda.max_memory_allocated() "
              f"{rec['max_memory_allocated']} bytes")
    return rec


def chunk_sweep(scene, memo) -> dict:
    """The level-7 scene at each chunk of CHUNK_SWEEP: build_scene_tables
    seconds, slots, the fused trace kernel and the wavefront_fused
    segments of frame 0 (mean of 5 launches each), the fused frame.  How
    STREAM_CHUNK was chosen; only with --stream-sweep."""
    from parallelraytracing_tpu_torch.ops.trace import trace
    out = {}
    for chunk in CHUNK_SWEEP:
        r, film = big_renderer("fused", scene, chunk=chunk)
        key = [k for k in memo if k[0] == id(scene) and k[3] == chunk][0]
        inputs = frame_inputs(r, 0)
        k_ms = cuda_ms(lambda: traced_on(r, trace)(*inputs), 5)
        segs = time_segments(big_renderer("wavefront_fused", scene,
                                          chunk=chunk)[0])
        for _ in range(WARMUP):
            r.progressive_render()
        f_ms = cuda_ms(r.progressive_render, TIMED)
        t = r._tables
        out[chunk] = dict(build_tables_s=memo[key][4], trace_ms=k_ms,
                          segments_ms=[sg["ms"] for sg in segs],
                          fused_frame_ms=f_ms, slots=int(t.tri.shape[1]),
                          node_rows=t.stream.node_rows,
                          top_nodes=int(t.tri_cl.shape[1]))
        phase("chunk-sweep", f"chunk {chunk}: build_scene_tables "
              f"{memo[key][4]:.2f} s, {t.tri.shape[1]} slots, node_rows "
              f"{t.stream.node_rows}; fused trace kernel {k_ms:.3f} ms, "
              f"frame {f_ms:.3f} ms; wavefront_fused segments "
              + " + ".join(f"{sg['ms']:.3f}" for sg in segs) + " ms")
        del r, film, inputs
    return out


def layout_divergence(scene) -> dict:
    """The layouts ray by ray: frames 0..BIG_FRAMES-1 of a big-mesh scene
    at BIG_W x BIG_H traced one bounce at a time by the segment kernel on
    the dense tables and on the stream route at each chunk of CHUNK_SWEEP,
    each bounce from the dense tables' queue.  Where a layout's outcome
    for a pixel (the survivor's 13 planes, or the ended path's radiance)
    differs from the dense one, one of the two must equal the plain
    version's (each value within RAY_ATOL): the layouts may differ only
    where one tree's box test culls a hit that the triangle test takes (a
    ray grazing a triangle's vertex on a box face, rounded differently by
    the two tests), which the plain version's brute force does not cull.
    At most LAYOUT_SHARE of the segments may differ for each chunk.
    Raises otherwise; returns the differing slots of each chunk and the
    layouts the plain version sided with.  Only with --stream-sweep."""
    import torch
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        _initial_state
    from parallelraytracing_tpu_torch.ops.segment import segment, segment_reference
    rs = {"dense": big_renderer("fused", scene, threshold=DENSE)[0]}
    for chunk in CHUNK_SWEEP:
        rs[chunk] = big_renderer("fused", scene, chunk=chunk)[0]
    out = {chunk: dict(slots=0, plain_sides_with_stream=0,
                       plain_sides_with_dense=0) for chunk in CHUNK_SWEEP}
    cfg = rs["dense"].config
    n_pix = cfg.width * cfg.height

    def outcomes(r, pix, state, count, seed, b, fn):
        rad = torch.full((n_pix, 3), float("nan"), device="cuda")
        res = fn(pix, state, count, rad, r._tables, r.config, seed=seed,
                 depth0=b, n_bounces=1)
        return res, segment_outcomes(res, rad)

    def near(x, y):  # every value within RAY_ATOL, or held by neither
        return (((x - y).abs() <= RAY_ATOL)
                | (torch.isnan(x) & torch.isnan(y))).all(1)
    segments = 0
    for f in range(BIG_FRAMES):
        o, d, pix, seed = frame_inputs(rs["dense"], f)
        state = _initial_state(o, d)
        count = torch.full((1,), o.shape[0], dtype=torch.int32, device="cuda")
        for b in range(BIG_DEPTH):
            n = int(count)
            segments += n
            outs = {k: outcomes(r, pix, state, count, seed, b, segment)
                    for k, r in rs.items()}
            slot = torch.empty(n_pix, dtype=torch.long, device="cuda")
            slot[pix[:n].long()] = torch.arange(n, device="cuda")
            for chunk in CHUNK_SWEEP:
                differs = (outs[chunk][1].view(torch.int32)
                           != outs["dense"][1].view(torch.int32)).any(1)
                px = torch.nonzero(differs)[:, 0]
                if not px.numel():
                    continue
                idx = slot[px]
                m = torch.full((1,), idx.numel(), dtype=torch.int32,
                               device="cuda")
                _, plain = outcomes(rs["dense"], pix[idx].contiguous(),
                                    state[:, idx].contiguous(), m, seed, b,
                                    segment_reference)
                near_s = near(outs[chunk][1][px], plain[px])
                near_d = near(outs["dense"][1][px], plain[px])
                o_ = out[chunk]
                o_["slots"] += px.numel()
                o_["plain_sides_with_stream"] += int(near_s.sum())
                o_["plain_sides_with_dense"] += int(near_d.sum())
                if not bool((near_s | near_d).all()):
                    raise AssertionError(f"level6 chunk {chunk}: a slot "
                                         f"differs from dense and from plain")
            state, pix, _, count = outs["dense"][0]
    worst = max(o_["slots"] for o_ in out.values())
    if worst > LAYOUT_SHARE * segments:
        raise AssertionError(f"level6: {worst} of {segments} slots differ "
                             f"between two layouts")
    phase("stream-layouts", f"level6 {BIG_W}x{BIG_H} x{BIG_FRAMES} frames, "
          f"{segments} ray segments, one bounce at a time: slots whose state "
          f"differs from the dense layout's, by chunk: {out} (each equals "
          f"the plain version in one of the two layouts)")
    return dict(segments=segments, by_chunk=out)


def stream_phases(png_dir, levels, sweep: bool) -> dict:
    """Phases 20-22: a big mesh on the stream route.  Phase 20, level 6
    (81,920 triangles): the stream kernels against their plain versions
    on sampled rays and on the whole frame, the films streamed at chunks
    STREAM_CHUNK and ALT_CHUNK and dense, bit for bit, and the fused
    kernel's time dense and streamed; with `sweep` (--stream-sweep) the
    layouts ray by ray (``layout_divergence``); then ``big_level`` for
    each of `levels` (7, and 8 when asked)."""
    import torch
    from parallelraytracing_tpu_torch.ops.pack import STREAM_CHUNK
    from parallelraytracing_tpu_torch.ops.trace import trace
    rec = {}
    scene, build_s = big_mesh_scene(6)
    with shared_tables() as memo:
        f_r, _ = big_renderer("fused", scene)
        w_r, _ = big_renderer("wavefront_fused", scene)
        t = f_r._tables
        phase("level6", f"bench big-mesh scene, icosphere level 6 (81920 "
              f"triangles): add_mesh {build_s:.2f} s; default threshold: "
              f"stream route, chunk {t.stream.chunk}: tri "
              f"{tuple(t.tri.shape)}, mini-trees {tuple(t.stream.mini.shape)}")
        cmp = {"plain": stream_vs_plain(f_r, w_r, "level6")}
        cmp["nee"] = stream_vs_plain(big_renderer("fused", scene, True)[0],
                                     big_renderer("wavefront_fused", scene,
                                                  True)[0], "level6 nee")
        cmp["full_frame"] = full_frame_vs_plain(f_r, w_r, "level6")
        rec["vs_plain"] = cmp
        del f_r, w_r
        films = {}
        for engine in ("fused", "wavefront_fused"):
            for tag, kw in (("stream", {}), ("alt", dict(chunk=ALT_CHUNK)),
                            ("dense", dict(threshold=DENSE))):
                films[engine, tag] = big_renderer(engine, scene, **kw)
        keys = list(films)
        hdr = dict(zip(keys, films_of([films[k] for k in keys], BIG_FRAMES)))
        if films["fused", "dense"][0]._tables.stream is not None \
                or films["fused", "alt"][0]._tables.stream.chunk != ALT_CHUNK:
            raise AssertionError("level6: the layouts were not packed as asked")
        eq = {}
        for e in ("fused", "wavefront_fused"):
            eq[f"{e} chunk {STREAM_CHUNK} vs dense"] = bool(torch.equal(
                hdr[e, "stream"], hdr[e, "dense"]))
            eq[f"{e} chunk {STREAM_CHUNK} vs {ALT_CHUNK}"] = bool(torch.equal(
                hdr[e, "stream"], hdr[e, "alt"]))
        engines = float((hdr["fused", "stream"]
                         - hdr["wavefront_fused", "stream"]).abs().max())
        phase("stream-vs-dense", f"level6 {BIG_W}x{BIG_H} depth {BIG_DEPTH} "
              f"x{BIG_FRAMES} frames, films bit-equal: {eq}; wavefront_fused "
              f"vs fused max abs diff {engines!r}")
        if not all(eq.values()):
            raise AssertionError("level6: the layouts' films differ")
        rec["films_equal"] = eq
        if sweep:
            rec["layouts"] = layout_divergence(scene)
        times = {}
        for tag in ("stream", "dense"):
            r = films["fused", tag][0]
            inputs = frame_inputs(r, 0)
            times[tag] = cuda_ms(lambda: traced_on(r, trace)(*inputs), 5)
        rec["fused_trace_ms"] = times
        phase("stream-vs-dense", f"level6 fused trace kernel, frame 0: "
              f"streamed {times['stream']:.3f} ms, dense {times['dense']:.3f} "
              f"ms ({times['stream'] / times['dense']:.2f}x)")
        del films, hdr
    for level in levels:
        rec[f"level{level}"] = big_level(level, png_dir,
                                         sweep=sweep and level == 7)
    return rec


def stream_kernel_record(kernel: str, st: dict) -> dict:
    """The kernels-line entry of the stream instantiations of `kernel`
    (trace or segment): launches over the level-7 timed frames without
    NEE (fused for the trace, wavefront_fused for the segment), the
    kernel's time on that path's frame 0 at BIG_W x BIG_H and its bound
    there (the first segment for the segment kernel), the plain version's
    time on BIG_RAYS rays beside the kernel's on them, and the largest
    error over every stream comparison of phases 20-22."""
    l7 = st["level7"]
    cmps = [c for lv in st.values() if isinstance(lv, dict)
            and "vs_plain" in lv for c in lv["vs_plain"].values()]
    cmps += list(st["vs_plain"].values())
    if kernel == "trace":
        path = l7["paths"]["level7_fused"]
        timed = path["kernels"]
        source, replaces = SOURCE, REPLACES
        errs = [c["max_abs_err"] for c in cmps]
        plain, cmp_ms = l7["vs_plain"]["plain"]["plain_ms"], \
            l7["vs_plain"]["plain"]["ms"]
    else:
        path = l7["paths"]["level7_wavefront_fused"]
        timed = path["kernels"]["segments"][0]
        source, replaces = SEG_SOURCE, SEG_REPLACES
        errs = [c["segment"]["max_abs_err"] for c in cmps]
        seg = l7["vs_plain"]["plain"]["segment"]
        plain, cmp_ms = seg["plain_ms"], seg["ms"]
    bound = timed["counted"] if kernel == "trace" else timed
    return {
        "name": f"{kernel}[stream]", "route": "cuda", "source": source,
        "replaces": replaces, "launches": path["launches"][kernel],
        "max_abs_err": max(errs), "ms": timed["ms"], "plain_ms": plain,
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": None,
        "size": f"the {kernel} kernel's stream instantiations (the K7 walk): "
                f"ms, bound and launches on bench's big-mesh scene at "
                f"icosphere level 7 (327,680 triangles) {BIG_W}x{BIG_H} "
                f"depth {BIG_DEPTH} without NEE, frame 0 (launches over its "
                f"{TIMED} timed frames); plain_ms and cmp_ms on {BIG_RAYS} of "
                f"its camera rays; max_abs_err over every stream comparison "
                f"(levels 6-8, with and without NEE); library_ms null: no "
                f"single PyTorch call computes it",
        "cmp_ms": cmp_ms, "bound": timed,
        "launch": (timed if kernel == "trace" else path["kernels"])["launch"],
        **({} if kernel == "trace" else {"segment_bounds_ms": [
            sg["bound_ms"] for sg in path["kernels"]["segments"]]}),
        "levels": {k: {kk: vv for kk, vv in v.items() if kk != "paths"}
                   for k, v in st.items() if k.startswith("level")},
        "level6": {k: v for k, v in st.items()
                   if not k.startswith("level")},
        "paths": {k: v for k, v in l7["paths"].items()
                  if ("wavefront" in k) == (kernel == "segment")}}


#: phase 29: bench.py's converged-spp gates (bench.py:455-602): 64x48,
#: depth 10, 32 samples a frame, HDR RMSE of the mean < 1e-3 against the
#: port's megakernel; the instanced row at twice the samples, as bench
#: takes it (its variance is ~4x the others')
GATE_W, GATE_H, GATE_DEPTH, GATE_SPF, GATE_SPP, GATE_RMSE = 64, 48, 10, 32, \
    4096, 1e-3
#: the level of the icosphere standing in for bench's bunny (1,280
#: triangles: the megakernel's brute force tests every ray against every
#: triangle, so its time grows with the mesh: 31 s on the card here)
GATE_ICO_LEVEL = 3
#: phase 29's rows of the plain PyTorch engines: 32 spp (bench's
#: equal-streams row)
LBVH_GATE_SPP = 32
#: phase 33: BASELINE config 5's frames (bvh with a per-frame refit)
LBVH_ANIM_FRAMES = 4
#: phase 31: the adaptive engine's warm-up and adaptive frames
ADAPT_WARMUP, ADAPT_FRAMES = 4, 4
#: phase 32: the denoiser's levels, and its MSE check (CORNELL at 128x96,
#: depth 5: DENOISE_FRAMES frames against a truth of DENOISE_TRUTH)
DENOISE_LEVELS, DENOISE_W, DENOISE_H = 4, 128, 96
DENOISE_FRAMES, DENOISE_TRUTH = 8, 256


def gate_render(engine: str, scene, eye, direction, spp: int):
    """The HDR mean of `spp` samples a pixel of `engine` at the gates'
    size, depth and samples a frame, and the engine's frames' seconds."""
    import torch
    r, film = scene_renderer(engine, scene, eye, direction, GATE_W, GATE_H,
                             max_depth=GATE_DEPTH, seed=0,
                             samples_per_frame=GATE_SPF)
    t0 = time.perf_counter()
    for _ in range(max(1, spp // GATE_SPF)):
        r.progressive_render()
    torch.cuda.synchronize()
    return film.hdr_average(), time.perf_counter() - t0


def gate_phase() -> list:
    """Phase 29: bench.py's fidelity rows on the card, each engine's image
    against the megakernel's at converged spp; the trace and segment
    launch counts of the kernels' renders.  Raises on a miss."""
    import torch
    from parallelraytracing_tpu_torch import Scene, ScenePreset
    from parallelraytracing_tpu_torch.core.mesh import icosphere
    from parallelraytracing_tpu_torch.ops.segment import segment
    from parallelraytracing_tpu_torch.ops.trace import trace

    def bunny_scene():  # bench's bunny_scene, the icosphere for the bunny
        s = Scene(preset=None)
        s.add_mesh(icosphere(GATE_ICO_LEVEL), s.add_lambertian((0.7, 0.6, 0.45)),
                   ((6, 6, 6), (0, 0, 0), (0, 0, 0)))
        s.add_quad(120, 120, s.add_lambertian((0.5, 0.5, 0.52)), None)
        return s

    def tex_scene():  # bench's tex_scene
        yy, xx = np.mgrid[0:16, 0:16]
        img16 = np.stack([(xx % 8) / 7.0, (yy % 8) / 7.0,
                          ((xx + yy) % 16) / 15.0], axis=-1)
        s = Scene(preset=None)
        tm = s.add_textured_lambertian(s.add_texture(img16))
        s.add_quad(6, 6, tm, ((1, 1, 1), (60, 0, 0), (0, 4, -4)))
        s.add_quad(40, 40, s.add_lambertian((0.5, 0.5, 0.52)), None)
        return s

    mat = ((5.0, 5.0, 8.0), (-5.0, -5.0, -8.0))
    rows = [("fused", "material_test", lambda b: Scene(ScenePreset.MATERIAL_TEST),
             mat, GATE_SPP),
            ("wavefront_fused", "material_test",
             lambda b: Scene(ScenePreset.MATERIAL_TEST), mat, GATE_SPP),
            ("wavefront_fused", f"bunny_sah (icosphere level {GATE_ICO_LEVEL})",
             lambda b: bunny_scene(), ((0.0, 14.0, 28.0), (0.0, -7.0, -28.0)),
             GATE_SPP),
            ("wavefront_fused", "tlas_blas",
             lambda baked: tlas_blas_scene(icosahedron(), baked),
             ((0.0, 6.0, 16.0), (0.0, -4.0, -16.0)), 2 * GATE_SPP),
            ("fused", "textured_image", lambda b: tex_scene(),
             ((0.0, 5.0, 10.0), (0.0, -2.0, -10.0)), GATE_SPP)]
    oracles, out = {}, []
    for engine, tag, scene, (eye, dirn), spp in rows:
        key = (tag, spp)
        if key not in oracles:
            oracles[key] = gate_render("megakernel", scene(True), eye, dirn, spp)
        ref, ref_s = oracles[key]
        trace.launches = segment.launches = 0
        img, img_s = gate_render(engine, scene(False), eye, dirn, spp)
        launches = dict(trace=trace.launches, segment=segment.launches)
        rmse = float((img - ref).pow(2).mean().sqrt())
        ok = bool(rmse < GATE_RMSE) and bool(torch.isfinite(img).all())
        out.append(dict(row=tag, engine=engine, spp=spp, rmse=rmse,
                        passed=ok, launches=launches, engine_s=img_s,
                        megakernel_s=ref_s))
        phase("gates", f"{tag}: {engine} vs megakernel at {spp} spp "
              f"({GATE_W}x{GATE_H}, depth {GATE_DEPTH}, {GATE_SPF} spp a "
              f"frame): HDR RMSE {rmse:.6e} (gate {GATE_RMSE}); {engine} "
              f"{img_s:.2f} s, launches {launches}; megakernel {ref_s:.2f} s")
        kernel = "segment" if engine == "wavefront_fused" else "trace"
        if not ok or launches[kernel] == 0:
            raise AssertionError(f"gate {tag}: {engine} RMSE {rmse} "
                                 f"(launches {launches})")
    out += lbvh_gate_rows(mat)
    return out


def lbvh_gate_rows(mat) -> list:
    """Phase 29's rows of the plain PyTorch engines, at 32 spp: bench's
    equal-streams row (bvh against megakernel, both a sample a frame: the
    same threefry streams, so ~0), wavefront against megakernel (0 where
    the frame is one ray tile), wavefront_bvh against bvh, and tlas_ref on
    the instanced tlas_blas scene against megakernel on it baked.  Each
    prints its RMSE, max abs difference and seconds, and raises on a miss
    (RMSE >= GATE_RMSE, a non-finite film, or a kernel launched)."""
    import torch
    from parallelraytracing_tpu_torch import Scene, ScenePreset
    from parallelraytracing_tpu_torch.ops.segment import segment
    from parallelraytracing_tpu_torch.ops.trace import trace

    def render(engine, scene, view, spf):
        eye, dirn = view
        r, film = scene_renderer(engine, scene, eye, dirn, GATE_W, GATE_H,
                                 max_depth=GATE_DEPTH, seed=0,
                                 samples_per_frame=spf)
        t0 = time.perf_counter()
        for _ in range(LBVH_GATE_SPP // spf):
            r.progressive_render()
        torch.cuda.synchronize()
        return film.hdr_average(), time.perf_counter() - t0

    def material():
        return Scene(ScenePreset.MATERIAL_TEST)
    inst = ((0.0, 6.0, 16.0), (0.0, -4.0, -16.0))
    rows = [("bvh equal streams", "bvh", "megakernel", material, material,
             mat, 1),
            ("wavefront one tile", "wavefront", "megakernel", material,
             material, mat, GATE_SPF),
            ("wavefront_bvh", "wavefront_bvh", "bvh", material, material, mat,
             GATE_SPF),
            ("tlas_ref vs baked", "tlas_ref", "megakernel",
             lambda: tlas_blas_scene(icosahedron(), False),
             lambda: tlas_blas_scene(icosahedron(), True), inst, GATE_SPF)]
    out = []
    for tag, engine, ref_engine, scene, ref_scene, view, spf in rows:
        ref, ref_s = render(ref_engine, ref_scene(), view, spf)
        trace.launches = segment.launches = 0
        img, img_s = render(engine, scene(), view, spf)
        launches = dict(trace=trace.launches, segment=segment.launches)
        diff = img - ref
        rmse = float(diff.pow(2).mean().sqrt())
        max_abs = float(diff.abs().max())
        ok = (rmse < GATE_RMSE and bool(torch.isfinite(img).all())
              and not any(launches.values()))
        out.append(dict(row=tag, engine=engine, reference=ref_engine,
                        spp=LBVH_GATE_SPP, samples_per_frame=spf, rmse=rmse,
                        max_abs_diff=max_abs, passed=ok, launches=launches,
                        engine_s=img_s, reference_s=ref_s))
        phase("gates", f"{tag}: {engine} vs {ref_engine} at {LBVH_GATE_SPP} "
              f"spp ({GATE_W}x{GATE_H}, depth {GATE_DEPTH}, {spf} spp a "
              f"frame): HDR RMSE {rmse:.6e} (gate {GATE_RMSE}), max abs "
              f"diff {max_abs!r}; {engine} {img_s:.2f} s, {ref_engine} "
              f"{ref_s:.2f} s; kernel launches {launches}")
        if not ok:
            raise AssertionError(f"gate {tag}: {engine} RMSE {rmse} "
                                 f"(launches {launches})")
    return out


def lbvh_phase(png_dir) -> dict:
    """Phase 33 (lbvh-engines), at full size: the headline (RANDOM_BALLS_LARGE
    at 1920x1080, depth 20, 1 spp, jitter, seed 0) through bvh,
    wavefront_bvh and wavefront, one warm-up and one timed frame each;
    BASELINE config 5 (bvh with a per-frame refit of a moving sphere,
    LBVH_ANIM_FRAMES frames at 1920x1080, depth 20), its boxes checked on
    the card; tlas_ref on the multimesh scene at 1920x1080, depth
    INST_DEPTH.  Raises on a miss; returns the record."""
    import torch
    from parallelraytracing_tpu_torch import Scene, ScenePreset
    from parallelraytracing_tpu_torch.accel import lbvh, traverse
    from parallelraytracing_tpu_torch.core.mesh import load_ply
    from parallelraytracing_tpu_torch.engines import tracer, wavefront
    from parallelraytracing_tpu_torch.ops.segment import segment
    from parallelraytracing_tpu_torch.ops.trace import trace
    t_phase = time.perf_counter()
    rec = {}
    scene = Scene(ScenePreset.RANDOM_BALLS_LARGE).build("cuda")
    lbvh.build_bvh(scene, "cuda")  # a first call loads numpy's and torch's paths
    t0 = time.perf_counter()
    bvh = lbvh.build_bvh(scene, "cuda")
    torch.cuda.synchronize()
    rec["build_bvh"] = dict(seconds=time.perf_counter() - t0,
                            nodes=bvh.num_nodes)
    samples = MAIN_W * MAIN_H

    def counted_frame(r):
        """One frame of r timed with every count set to 0 first."""
        tracer.ray_segments[0] = wavefront.ray_segments[0] = 0
        traverse.walk_counts.update(walks=0, rounds=0, steps=0)
        trace.launches = segment.launches = 0
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(r.progressive_render, 1)
        return dict(ms=ms, segments=tracer.ray_segments[0]
                    + wavefront.ray_segments[0],
                    walk=dict(traverse.walk_counts),
                    kernel_launches=trace.launches + segment.launches,
                    peak_bytes=torch.cuda.max_memory_allocated())

    for engine in ("bvh", "wavefront_bvh", "wavefront"):
        t0 = time.perf_counter()
        r, film = make_renderer("random_balls_large", MAIN_W, MAIN_H, engine,
                                max_depth=MAIN_DEPTH, jitter=True, seed=0)
        r.progressive_render()  # warm-up
        torch.cuda.synchronize()
        fr = counted_frame(r)
        walk = fr["walk"]
        per_walk = (walk["steps"] / walk["walks"], walk["rounds"] / walk["walks"]) \
            if walk["walks"] else (0.0, 0.0)
        fr.update(msamples_per_s=samples / fr["ms"] / 1e3,
                  mrays_per_s=fr["segments"] / fr["ms"] / 1e3,
                  steps_per_bounce=per_walk[0], rounds_per_bounce=per_walk[1],
                  seconds=time.perf_counter() - t0)
        film_msg = check_film(film, r._scene_data.sky.tolist(),
                              f"lbvh_{engine}_random_balls_large", png_dir)
        phase("lbvh-engines", f"{engine} random_balls_large {MAIN_W}x{MAIN_H} "
              f"depth {MAIN_DEPTH}: {fr['ms']:.1f} ms/frame (one frame after "
              f"a warm-up), {fr['msamples_per_s']:.4f} Msamples/s, "
              f"{fr['mrays_per_s']:.4f} Mrays/s ({fr['segments']} ray "
              f"segments counted by the bounce loop); walks {walk['walks']}, "
              f"{per_walk[0]:.1f} box-test steps and {per_walk[1]:.1f} rounds "
              f"a bounce; peak {fr['peak_bytes'] / 2**30:.2f} GiB; kernel "
              f"launches {fr['kernel_launches']}; {film_msg}")
        if fr["kernel_launches"]:
            raise AssertionError(f"{engine} launched a kernel")
        rec[engine] = fr
        del r, film
    rec["anim"] = anim_phase(png_dir)

    # tlas_ref on bench's multimesh scene (phase 12's: the level-5
    # icosphere for the bunny)
    with tempfile.TemporaryDirectory() as tmp:
        ply = str(Path(tmp) / "bunny.ply")
        write_ply(ply)
        bunny = load_ply(ply)
    t0 = time.perf_counter()
    r, film = scene_renderer("tlas_ref", multimesh_scene(bunny, icosahedron()),
                             INST_EYE, INST_DIR, MAIN_W, MAIN_H,
                             max_depth=INST_DEPTH, seed=0)
    init_s = time.perf_counter() - t0
    fr = counted_frame(r)
    fr.update(init_s=init_s, instances=r._tlas.num_instances,
              unique_triangles=r._tlas.num_unique_triangles,
              msamples_per_s=samples / fr["ms"] / 1e3,
              mrays_per_s=fr["segments"] / fr["ms"] / 1e3)
    film_msg = check_film(film, r._scene_data.sky.tolist(),
                          "lbvh_tlas_ref_multimesh", png_dir)
    phase("lbvh-engines", f"tlas_ref multimesh ({fr['instances']} instances, "
          f"{fr['unique_triangles']} unique triangles) {MAIN_W}x{MAIN_H} "
          f"depth {INST_DEPTH}: init {init_s:.2f} s, {fr['ms']:.1f} ms for "
          f"its first frame, {fr['mrays_per_s']:.4f} Mrays/s, rounds "
          f"{fr['walk']['rounds']}; kernel launches {fr['kernel_launches']}; "
          f"{film_msg}")
    if fr["kernel_launches"]:
        raise AssertionError("tlas_ref launched a kernel")
    rec["tlas_ref_multimesh"] = fr
    rec["seconds"] = time.perf_counter() - t_phase
    phase("lbvh-engines", f"phase seconds {rec['seconds']:.1f}")
    return rec


def anim_phase(png_dir) -> dict:
    """BASELINE config 5: bvh with an animate hook that moves one sphere of
    the headline each frame (``orbit_first_sphere``), LBVH_ANIM_FRAMES
    frames at 1920x1080,
    depth 20; each frame's refit timed alone, and on the card after each
    refit: every internal box holds its two children's, every leaf box is
    its moved primitive's ``leaf_aabbs`` box, and at frame 0 the refit
    boxes are the build's bit for bit."""
    import torch
    from parallelraytracing_tpu_torch.accel.refit import leaf_aabbs, refit_bvh
    r, film = make_renderer("random_balls_large", MAIN_W, MAIN_H, "bvh",
                            attrs=dict(animate=orbit_first_sphere),
                            max_depth=MAIN_DEPTH, jitter=True, seed=0)
    bvh, plan = r._bvh, r._plan
    internal = (bvh.node_kind < 0).nonzero()[:, 0]
    left = internal + 1
    right = bvh.node_miss[left].long()
    frames = []
    for f in range(LBVH_ANIM_FRAMES):
        moved = orbit_first_sphere(r._scene_data, f)
        refit, refit_ms = timed_ms(lambda: refit_bvh(bvh, moved, plan))
        mn, mx = leaf_aabbs(moved, bvh.node_kind, bvh.node_idx, plan.quad_pad)
        leaf = bvh.node_kind >= 0
        ok_leaf = bool(torch.equal(refit.node_min[leaf], mn[leaf])
                       and torch.equal(refit.node_max[leaf], mx[leaf]))
        ok_union = bool(
            (refit.node_min[internal] <= torch.minimum(
                refit.node_min[left], refit.node_min[right])).all()
            and (refit.node_max[internal] >= torch.maximum(
                refit.node_max[left], refit.node_max[right])).all())
        ok_build = f > 0 or bool(torch.equal(refit.node_min, bvh.node_min)
                                 and torch.equal(refit.node_max, bvh.node_max))
        frame_ms = cuda_ms(r.progressive_render, 1)
        frames.append(dict(refit_ms=refit_ms, frame_ms=frame_ms,
                           leaves_ok=ok_leaf, unions_ok=ok_union,
                           frame0_equals_build=ok_build))
        if not (ok_leaf and ok_union and ok_build):
            raise AssertionError(f"config 5 frame {f}: refit boxes wrong "
                                 f"{frames[-1]}")
    film_msg = check_film(film, r._scene_data.sky.tolist(),
                          "lbvh_config5_refit", png_dir)
    centre = orbit_first_sphere(r._scene_data, LBVH_ANIM_FRAMES - 1)
    phase("lbvh-engines", f"config 5: bvh with a per-frame refit, one sphere "
          f"orbiting, {LBVH_ANIM_FRAMES} frames {MAIN_W}x{MAIN_H} depth "
          f"{MAIN_DEPTH}: refit " + ", ".join(f"{x['refit_ms']:.3f}"
                                              for x in frames)
          + " ms, frame " + ", ".join(f"{x['frame_ms']:.1f}" for x in frames)
          + f" ms; boxes hold their children and equal leaf_aabbs on every "
          f"frame, frame 0 equal to the build; last centre "
          f"{[round(float(v), 3) for v in centre.sph_center[0]]}; "
          f"{film_msg}")
    return dict(frames=frames, nodes=bvh.num_nodes, levels=len(plan.levels))


def orbit_first_sphere(scene, frame: int):
    """examples/animated_refit.py's orbit on the headline: sphere 0 moved
    along a circle of radius 6 in the ground's plane that starts at its
    place, a twelfth of a turn a frame (frame 0 leaves the scene as built;
    a new SceneData, the other spheres unmoved)."""
    import math
    ang = frame * (2.0 * math.pi / 12.0)
    c = scene.sph_center.clone()
    c[0, 0] += 6.0 * math.cos(ang) - 6.0
    c[0, 2] += 6.0 * math.sin(ang)
    return dataclasses.replace(scene, sph_center=c)


def megakernel_phase() -> dict:
    """Phase 30: one megakernel frame of the headline at 1920x1080, depth
    20, timed with CUDA events beside the fused engine's frames; the
    film checked as phase 4 checks it."""
    import torch
    from parallelraytracing_tpu_torch.ops.trace import trace
    mk, mk_film = make_renderer("random_balls_large", MAIN_W, MAIN_H,
                                "megakernel", max_depth=MAIN_DEPTH, jitter=True)
    trace.launches = 0
    torch.cuda.reset_peak_memory_stats()
    mk_ms = cuda_ms(mk.progressive_render, 1)
    mk_launches = trace.launches
    peak = torch.cuda.max_memory_allocated()
    f, _ = make_renderer("random_balls_large", MAIN_W, MAIN_H,
                         max_depth=MAIN_DEPTH, jitter=True)
    f.progressive_render()
    f_ms = cuda_ms(f.progressive_render, TIMED)
    phase("megakernel", f"random_balls_large {MAIN_W}x{MAIN_H} depth "
          f"{MAIN_DEPTH}: megakernel {mk_ms:.1f} ms for one frame (plain "
          f"PyTorch, brute force over 809 primitives, peak "
          f"{peak / 2**30:.2f} GiB), fused {f_ms:.3f} ms/frame; trace "
          f"launches in the megakernel frame {mk_launches}; "
          + check_film(mk_film, mk._scene_data.sky.tolist(),
                       "megakernel_random_balls_large", None))
    if mk_launches:
        raise AssertionError("the megakernel launched the trace kernel")
    return dict(ms=mk_ms, fused_ms_per_frame=f_ms, peak_bytes=peak)


def adaptive_phase(png_dir, peaks) -> dict:
    """Phase 31: the adaptive engine on the headline at 1920x1080, depth
    20: ADAPT_WARMUP warm-up frames bit-equal to the fused engine's; on
    the first adaptive frame the trace kernel on the selected ids against
    trace_reference (within RAY_ATOL on >= RAY_SHARE of the rays), the
    selection, the kernel and the slot add timed; then ADAPT_FRAMES
    adaptive frames with every launch count set to 0: one trace launch a
    frame.  Raises on a miss; returns the record."""
    import torch
    from parallelraytracing_tpu_torch import Film
    from parallelraytracing_tpu_torch.engines.adaptive import select_slots
    from parallelraytracing_tpu_torch.ops.segment import segment
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    ad, ad_film = make_renderer("random_balls_large", MAIN_W, MAIN_H,
                                "adaptive", attrs=dict(warmup=ADAPT_WARMUP),
                                max_depth=MAIN_DEPTH, jitter=True)
    f, f_film = make_renderer("random_balls_large", MAIN_W, MAIN_H,
                              max_depth=MAIN_DEPTH, jitter=True)
    for _ in range(ADAPT_WARMUP):
        ad.progressive_render()
        f.progressive_render()
    torch.cuda.synchronize()
    equal = bool(torch.equal(ad_film.accum, f_film.accum)
                 and torch.equal(ad_film.weights, f_film.weights))
    del f, f_film
    budget = ad._budget_slots

    def select():
        return select_slots(ad._m1, ad._m2, ad._n, budget)
    sel = select()  # a first call loads the sort's kernels
    sel_ms = cuda_ms(select, 5)
    ids = ad._ids[sel]
    o, d, seed = ad._sample_rays(ids, ad._frame_index, 0)
    k, k_ms = timed_ms(lambda: trace(o, d, ids, seed, ad._tables,
                                     ad.config))
    kernel_ms = cuda_ms(lambda: trace(o, d, ids, seed, ad._tables,
                                      ad.config), 5)
    p, plain_ms = timed_ms(lambda: traced_on(ad, trace_reference)(o, d, ids,
                                                                  seed))
    # the probe kernel's counted visits of the same launch: its bound
    counted = counted_bound(ad._tables, probe_counts(ad, (o, d, ids, seed)),
                            int(ids.numel()), TRACE_RAY_BYTES, 0.0, peaks)
    err = (k - p).abs().amax(1)
    share, max_err = float((err <= RAY_ATOL).float().mean()), float(err.max())
    scratch = Film(MAIN_W, MAIN_H, "cuda")  # the slot add, on a film alike
    scratch.set_layout(ad.film_layout())
    scratch.add_sample_slots(sel, k, 1.0)
    add_ms = cuda_ms(lambda: scratch.add_sample_slots(sel, k, 1.0), 5)
    del scratch
    phase("adaptive", f"random_balls_large {MAIN_W}x{MAIN_H} depth "
          f"{MAIN_DEPTH}: {ADAPT_WARMUP} warm-up films bit-equal to fused: "
          f"{equal}; budget {budget} of {MAIN_W * MAIN_H} ids; first "
          f"adaptive frame: trace kernel on the selected ids {kernel_ms:.3f} "
          f"ms (first launch {k_ms:.3f} ms), plain {plain_ms:.1f} ms, "
          f"{share:.6f} of rays within {RAY_ATOL} (max abs err "
          f"{max_err:.3e}); selection {sel_ms:.3f} ms, slot add "
          f"{add_ms:.3f} ms (means of 5 after a first call); the kernel's "
          f"counted-visit bound on them {counted['bound_ms']:.4f} ms "
          f"({counted['bound_by']}; data sheet "
          f"{counted['datasheet_bound_ms']:.4f} ms), "
          f"{counted['bound_ms'] / kernel_ms:.1%} of the kernel's time")
    if not equal or share < RAY_SHARE:
        raise AssertionError(f"adaptive: warm-up equal {equal}, share {share}")
    del k, p, err, o, d
    trace.launches = segment.launches = 0
    frame_ms = cuda_ms(ad.progressive_render, ADAPT_FRAMES)
    launches = trace.launches
    phase("adaptive", f"{ADAPT_FRAMES} adaptive frames: {frame_ms:.3f} "
          f"ms/frame; trace launches {launches}, segment launches "
          f"{segment.launches}; "
          + check_film(ad_film, ad._tables.sky, "adaptive_random_balls_large",
                       png_dir))
    if launches != ADAPT_FRAMES or segment.launches:
        raise AssertionError(f"adaptive: {launches} trace launches in "
                             f"{ADAPT_FRAMES} frames")
    return dict(launches=launches, budget_ids=budget, ms=kernel_ms,
                plain_ms=plain_ms, max_abs_err=max_err, share=share,
                bound_ms=counted["bound_ms"], bound_by=counted["bound_by"],
                bound=counted,
                selection_ms=sel_ms, slot_add_ms=add_ms,
                ms_per_frame=frame_ms, warmup_films_equal=equal)


def denoise_phase(png_dir) -> dict:
    """Phase 32: the à-trous denoiser.  At 1920x1080 on the headline's
    film (phase 31's scene, 4 fused frames) the guide pass and
    DENOISE_LEVELS levels, each timed; at DENOISE_W x DENOISE_H on
    CORNELL (depth 5) the denoised DENOISE_FRAMES-frame image is nearer
    (MSE) a DENOISE_TRUTH-frame fused truth than the raw image; then the
    CLI with --engine adaptive --denoise and --engine megakernel writes
    its PNGs.  Raises on a miss."""
    import torch
    from parallelraytracing_tpu_torch import cli
    from parallelraytracing_tpu_torch.postfx.denoise import (atrous_denoise,
                                                             aux_buffers,
                                                             save_denoised_png)
    r, film = make_renderer("random_balls_large", MAIN_W, MAIN_H,
                            max_depth=MAIN_DEPTH, jitter=True)
    for _ in range(4):
        r.progressive_render()
    scene = r._scene.build("cuda")
    guides, guide_ms = timed_ms(lambda: aux_buffers(scene, r._cam_params,
                                                    r.config))
    rad = film.hdr_average()
    den, filt_ms = timed_ms(lambda: atrous_denoise(rad, *guides,
                                                   DENOISE_LEVELS))
    if not torch.isfinite(den).all():
        raise AssertionError("denoise: non-finite output at 1080p")
    del r, film, guides, rad, den

    def cornell(frames, seed):
        c, cfilm = make_renderer("cornell", DENOISE_W, DENOISE_H, max_depth=5,
                                 seed=seed, jitter=True)
        for _ in range(frames):
            c.progressive_render()
        return c, cfilm

    _, truth_film = cornell(DENOISE_TRUTH, 0)
    truth = truth_film.hdr_average()
    c, noisy_film = cornell(DENOISE_FRAMES, 123)
    noisy = noisy_film.hdr_average()
    cscene = c._scene.build("cuda")
    den = atrous_denoise(noisy, *aux_buffers(cscene, c._cam_params, c.config),
                         DENOISE_LEVELS)
    mse_raw = float((noisy - truth).pow(2).mean())
    mse_den = float((den - truth).pow(2).mean())
    out_dir = Path(png_dir) if png_dir is not None else Path(tempfile.mkdtemp())
    out_dir.mkdir(parents=True, exist_ok=True)
    save_denoised_png(str(out_dir / "denoised_cornell.png"), noisy_film,
                      cscene, c._cam_params, c.config, DENOISE_LEVELS)
    with contextlib.redirect_stdout(sys.stderr):
        for engine, extra in (("adaptive", ["--denoise", str(DENOISE_LEVELS),
                                            "--frames", "8"]),
                              ("megakernel", ["--frames", "2"])):
            cli.main(["--device", "cuda", "--engine", engine, "--scene",
                      "cornell", "--width",
                      str(DENOISE_W), "--height", str(DENOISE_H), "--depth",
                      "5", "--out", str(out_dir / f"cli_{engine}.png")] + extra)
    pngs = sorted(x.name for x in out_dir.glob("*.png")
                  if x.name.startswith(("cli_", "denoised_")))
    if png_dir is None:
        shutil.rmtree(out_dir)
    phase("denoise", f"{MAIN_W}x{MAIN_H}: guide pass {guide_ms:.1f} ms, "
          f"{DENOISE_LEVELS} a-trous levels {filt_ms:.1f} ms (plain "
          f"PyTorch); cornell {DENOISE_W}x{DENOISE_H} depth 5, "
          f"{DENOISE_FRAMES} frames against {DENOISE_TRUTH}: MSE raw "
          f"{mse_raw:.4e}, denoised {mse_den:.4e}; the CLI wrote {pngs}")
    if not mse_den < mse_raw or len(pngs) != 3:
        raise AssertionError(f"denoise: MSE {mse_den} not below {mse_raw}, "
                             f"PNGs {pngs}")
    return dict(guide_ms=guide_ms, filter_ms=filt_ms, levels=DENOISE_LEVELS,
                mse_raw=mse_raw, mse_denoised=mse_den)


#: the viewer phase (34): frames at rest, rotate messages, frames after
#: the engine switch, the preview scale and the display cadence
APP_REST, APP_ORBIT, APP_SWITCH = 32, 20, 8
APP_PREVIEW, APP_DISPLAY_MS = 3, 250.0
#: the host-stage phase (35): the program's spans of a fused frame
FRAME_SPANS = ("prt.frame", "prt.seeds", "prt.raygen", "prt.trace",
               "prt.film_add")


def _http(url: str, body: bytes = None) -> bytes:
    """GET (or POST `body` to) a route of the viewer on 127.0.0.1."""
    import urllib.request
    req = urllib.request.Request(url, data=body,
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return r.read()


def _same_film(a, b) -> bool:
    """Two films' canonical accumulation and weights, bit for bit."""
    import torch
    (acc_a, w_a), (acc_b, w_b) = a._canonical_buffers(), b._canonical_buffers()
    return bool(torch.equal(acc_a, acc_b) and torch.equal(w_a, w_b)
                and a.sample_count == b.sample_count)


def _fused_reference(scene, camera, cfg, frames: int):
    """A separate fused renderer's film after `frames` frames."""
    from parallelraytracing_tpu_torch import Film, create_renderer
    film = Film(cfg.width, cfg.height, "cuda")
    r = create_renderer("fused", "cuda")
    r.init(film, scene, camera, cfg)
    for _ in range(frames):
        r.progressive_render()
    return film


def app_phase(png_dir) -> dict:
    """Phase 34: the viewer on the main path at full width."""
    import copy
    import threading
    from http.server import ThreadingHTTPServer
    import torch
    from parallelraytracing_tpu_torch import (Film, RenderConfig, Scene,
                                              ScenePreset, default_camera)
    from parallelraytracing_tpu_torch.ops.segment import segment
    from parallelraytracing_tpu_torch.ops.trace import trace
    from parallelraytracing_tpu_torch.utils.png import read_png
    from parallelraytracing_tpu_torch.viewer.app import ViewerState, make_handler
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, max_depth=MAIN_DEPTH,
                       jitter=True, seed=0)
    scene = Scene(ScenePreset.RANDOM_BALLS_LARGE)
    t0 = time.perf_counter()
    state = ViewerState(scene, default_camera(MAIN_W, MAIN_H), cfg, "fused",
                        "cuda", preview_scale=APP_PREVIEW,
                        display_interval_ms=APP_DISPLAY_MS)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rec = {"init_s": time.perf_counter() - t0}
    try:
        if f'width="{MAIN_W}"' not in _http(base + "/").decode():
            raise AssertionError("app: the page does not carry the width")
        # (a) at rest: one trace launch a frame, the film a fused film's
        torch.cuda.synchronize()
        trace.launches = 0
        segment.launches = 0
        t0 = time.perf_counter()
        for _ in range(APP_REST):
            state._step(1.0 / 60.0)
        torch.cuda.synchronize()
        rest_s = time.perf_counter() - t0
        rest_launches = trace.launches
        ref = _fused_reference(scene, default_camera(MAIN_W, MAIN_H), cfg,
                               APP_REST)
        rest_equal = _same_film(state.film, ref)
        del ref
        rings = _ring_means(state, APP_REST)
        rec["rest"] = dict(frames=APP_REST, fps=APP_REST / rest_s,
                           trace_launches=rest_launches,
                           segment_launches=segment.launches,
                           film_bit_equal=rest_equal, rings_mean_ms=rings)
        phase("app", f"(a) {APP_REST} frames at rest, fused {MAIN_W}x{MAIN_H} "
              f"depth {MAIN_DEPTH}: {APP_REST / rest_s:.2f} fps sustained "
              f"(display every {APP_DISPLAY_MS:g} ms); trace launches "
              f"{rest_launches}, segment launches {segment.launches}; film "
              f"bit-equal to a separate fused renderer's: {rest_equal}; ring "
              f"means (ms) " + ", ".join(f"{k} {v:.3f}" for k, v in rings.items()))
        if rest_launches != APP_REST or segment.launches or not rest_equal:
            raise AssertionError(f"app (a): {rec['rest']}")

        # (b) orbit through /control: the preview twin renders the motion
        trace.launches = 0
        previews = []
        t0 = time.perf_counter()
        for i in range(APP_ORBIT):
            _http(base + "/control", json.dumps(
                {"kind": "rotate", "dx": 4.0, "dy": 0.0}).encode())
            state._step(1.0 / 60.0)
            if i in (0, APP_ORBIT - 1):
                previews.append(json.loads(_http(base + "/stats"))["preview"])
        torch.cuda.synchronize()
        orbit_s = time.perf_counter() - t0
        orbit_launches = trace.launches
        rings = _ring_means(state, APP_ORBIT)
        pw, ph = state.preview_film.width, state.preview_film.height
        state._step(1.0 / 60.0)  # the motion stopped: back to full size
        torch.cuda.synchronize()
        restarted = (not state.previewing and state.film.sample_count == 1
                     and state.renderer.frame_index == 1)
        rec["orbit"] = dict(frames=APP_ORBIT, fps=APP_ORBIT / orbit_s,
                            preview=previews, preview_size=[pw, ph],
                            trace_launches=orbit_launches,
                            restarted_at_frame_0=restarted,
                            rings_mean_ms=rings)
        phase("app", f"(b) {APP_ORBIT} rotate messages through /control, one "
              f"a frame: {APP_ORBIT / orbit_s:.2f} fps sustained (the HTTP "
              f"round trip included), preview twin {pw}x{ph} (/stats preview "
              f"{previews}), trace launches {orbit_launches}; motion stopped: "
              f"film cleared and refinement restarted at frame 0: {restarted}; "
              f"ring means (ms) " + ", ".join(f"{k} {v:.3f}"
                                             for k, v in rings.items()))
        if (not all(previews) or (pw, ph) != (MAIN_W // APP_PREVIEW,
                                              MAIN_H // APP_PREVIEW)
                or orbit_launches != APP_ORBIT or not restarted):
            raise AssertionError(f"app (b): {rec['orbit']}")

        # (c) the engine switch to wavefront_fused (the segment kernel)
        cam_after = copy.deepcopy(state.camera)
        _http(base + "/control", json.dumps(
            {"kind": "engine", "name": "wavefront_fused"}).encode())
        trace.launches = 0
        segment.launches = 0
        t0 = time.perf_counter()
        for _ in range(APP_SWITCH):
            state._step(1.0 / 60.0)
        torch.cuda.synchronize()
        switch_s = time.perf_counter() - t0
        seg_launches, sw_trace = segment.launches, trace.launches
        per_frame = len(state.renderer.segment_lengths())
        ref = _fused_reference(scene, cam_after, cfg, APP_SWITCH)
        switch_equal = (state.engine_name == "wavefront_fused"
                        and _same_film(state.film, ref))
        del ref
        rec["switch"] = dict(frames=APP_SWITCH, seconds=switch_s,
                             segment_launches=seg_launches,
                             trace_launches=sw_trace,
                             segments_per_frame=per_frame,
                             film_bit_equal_fused=switch_equal)
        phase("app", f"(c) switch to wavefront_fused, {APP_SWITCH} frames in "
              f"{switch_s:.2f} s (its init included): segment launches "
              f"{seg_launches} ({per_frame} a frame), trace launches "
              f"{sw_trace}; film bit-equal to a separate fused renderer's "
              f"under the new camera: {switch_equal}")
        if (seg_launches != per_frame * APP_SWITCH or sw_trace
                or not switch_equal):
            raise AssertionError(f"app (c): {rec['switch']}")

        # (d) the denoiser toggled, one display; (e) /frame.png read back
        _http(base + "/control", json.dumps(
            {"kind": "denoise", "on": True}).encode())
        before = state.png_cache
        state._last_display_t = 0.0  # take this frame's display
        t0 = time.perf_counter()
        state._step(1.0 / 60.0)
        denoise_ms = (time.perf_counter() - t0) * 1e3
        deadline = time.time() + 60
        while state.png_cache is before and time.time() < deadline:
            time.sleep(0.01)
        body = _http(base + "/frame.png?f=1")
        png_path = Path(png_dir or tempfile.mkdtemp()) / "app_frame.png"
        png_path.parent.mkdir(parents=True, exist_ok=True)
        png_path.write_bytes(body)
        img = read_png(str(png_path))
        if png_dir is None:
            shutil.rmtree(png_path.parent)
        sky_film = Film(1, 1, "cuda")
        sky_film.add_sample_buffer(torch.tensor([state.renderer._tables.sky],
                                                device="cuda"))
        sky_rgb = sky_film.display_numpy()[0, 0, :3]
        sky_share = float((img[..., :3] == sky_rgb).all(-1).mean())
        png_ok = (img.shape == (MAIN_H, MAIN_W, 4) and int(img.max()) > 0
                  and sky_share < 0.5 and state.denoise)
        stats = json.loads(_http(base + "/stats"))
        rec["display"] = dict(denoise_step_ms=denoise_ms, png_bytes=len(body),
                              png_shape=list(img.shape), sky_share=sky_share,
                              ok=png_ok, encode_ms=state.encode_ms,
                              stats_frame=stats["frame"])
        phase("app", f"(d) denoise toggled: the step with its display "
              f"{denoise_ms:.1f} ms, its encode {state.encode_ms:.1f} ms; (e) "
              f"/frame.png {len(body)} bytes decodes through utils/png to "
              f"{img.shape}, sky-only pixels {sky_share:.4f}, max "
              f"{int(img.max())}: {png_ok}; /stats frame {stats['frame']}")
        if not png_ok:
            raise AssertionError(f"app (d, e): {rec['display']}")
    finally:
        state.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    return rec


def _ring_means(state, n: int) -> dict:
    """Means (ms) of the viewer's render, tonemap, encode and total rings
    over their last n entries."""
    return {k: float(np.mean(list(state.history[k])[-n:]))
            for k in ("render", "tonemap", "encode", "total")}


def host_stages_phase(png_dir) -> dict:
    """Phase 35: the headline fused frame's stages, host and device ms of
    each of the program's spans (a FrameTimer attached to them), and
    under the profiler the device's idle share and each span's idle and
    launched device time."""
    import torch
    from parallelraytracing_tpu_torch.ops.trace import trace
    from parallelraytracing_tpu_torch.utils.profiling import (device_busy,
                                                              record_into)
    from parallelraytracing_tpu_torch.utils.profiling import trace as ptrace
    from parallelraytracing_tpu_torch.utils.timing import FrameTimer
    r, film = make_renderer("random_balls_large", MAIN_W, MAIN_H,
                            max_depth=MAIN_DEPTH, jitter=True, seed=0)
    ref_r, ref_film = make_renderer("random_balls_large", MAIN_W, MAIN_H,
                                    max_depth=MAIN_DEPTH, jitter=True, seed=0)
    for _ in range(WARMUP):
        r.progressive_render()
    for _ in range(WARMUP + 2 * TIMED):  # the spans off
        ref_r.progressive_render()
    torch.cuda.synchronize()
    timer = FrameTimer("cuda")
    trace.launches = 0
    record_into(timer)
    try:
        t0 = time.perf_counter()
        for _ in range(TIMED):
            r.progressive_render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED
    finally:
        record_into(None)
    launches = trace.launches
    rows = {name: dict(host_ms=sec * 1e3 / TIMED, calls=calls / TIMED,
                       device_ms=timer.device_mean(name) * calls / TIMED * 1e3)
            for name, (sec, calls) in timer.totals().items()}
    child_ms = sum(x["host_ms"] for name, x in rows.items()
                   if name != "prt.frame")
    phase("host-stages", f"headline fused {MAIN_W}x{MAIN_H} depth "
          f"{MAIN_DEPTH}, {TIMED} frames after {WARMUP} warm-up through "
          f"progressive_render, its spans recorded into FrameTimer: "
          f"{wall_ms:.3f} ms a frame on the host clock (synchronised at the "
          f"end), prt.frame's children {child_ms:.3f} ms of its "
          f"{rows['prt.frame']['host_ms']:.3f}; trace launches {launches}")
    for name, x in rows.items():
        phase("host-stages", f"  {name:<14} host {x['host_ms']:8.3f} ms   "
              f"device {x['device_ms']:8.3f} ms   ({x['calls']:g} a frame)")
    if launches != TIMED or set(rows) != set(FRAME_SPANS):
        raise AssertionError(f"host-stages: {launches} trace launches, "
                             f"spans {sorted(rows)}")

    log_dir = Path(png_dir or tempfile.mkdtemp()) / "host_stages_trace"
    with ptrace(str(log_dir)) as path:
        for _ in range(TIMED):
            r.progressive_render()
        torch.cuda.synchronize()
    busy = device_busy(path, list(FRAME_SPANS))
    if png_dir is None:
        shutil.rmtree(log_dir.parent)
    equal = _same_film(film, ref_film)
    phase("host-stages", f"film after {TIMED} recorded and {TIMED} profiled "
          f"frames bit-equal to one rendered with the spans off: {equal}")
    del ref_r, ref_film
    if not equal:
        raise AssertionError("host-stages: the spans changed the film")
    gaps = busy["gaps"][:3]
    spans = {name: dict(idle_ms=x["idle"] / 1e3 / TIMED,
                        device_ms=x["device"] / 1e3 / TIMED)
             for name, x in busy["spans"].items()}
    rec = dict(stages=rows, wall_ms_per_frame=wall_ms, trace_launches=launches,
               film_bit_equal=equal, window_ms=busy["window"] / 1e3,
               busy_ms=busy["busy"] / 1e3, busy_share=busy["busy_share"],
               idle_share=busy["idle_share"], device_kernels=busy["kernels"],
               cuda_launches_per_frame=busy["launches"] / TIMED,
               spans_per_frame=spans,
               longest_gaps=[dict(ms=g["length"] / 1e3,
                                  at_ms=g["start"] / 1e3, stage=g["stage"])
                             for g in gaps])
    if busy["kernels"] == 0:
        phase("host-stages", "profiler: no device kernel in the trace; the "
              "idle share is not measured")
        rec["idle_share"] = None
        return rec
    phase("host-stages", f"profiler over the next {TIMED} frames "
          f"(utils/profiling.trace): window {busy['window'] / 1e3:.3f} ms, "
          f"device busy {busy['busy'] / 1e3:.3f} ms = "
          f"{busy['busy_share']:.4f}, idle share {busy['idle_share']:.4f}; "
          f"{busy['kernels']} device kernels, "
          f"{busy['launches'] / TIMED:.1f} CUDA launches a frame; longest "
          f"idle gaps: " + "; ".join(
              f"{g['length'] / 1e3:.3f} ms in {g['stage']}" for g in gaps))
    for name, x in spans.items():
        phase("host-stages", f"  {name:<14} idle {x['idle_ms']:8.3f} ms   "
              f"launched device {x['device_ms']:8.3f} ms a frame")
    return rec


def doctor_phase() -> dict:
    """Phase 36: the CLI's --doctor in a subprocess: every row ok, exit 0."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "parallelraytracing_tpu_torch.cli",
                           "--doctor"], capture_output=True, text=True,
                          timeout=600)
    rows = [x for x in proc.stdout.splitlines() if x.startswith("[")]
    secs = time.perf_counter() - t0
    for row in rows:
        phase("doctor", row)
    bad = [x for x in rows if not x.startswith("[OK ]")]
    phase("doctor", f"exit code {proc.returncode}, {len(rows)} rows, "
          f"{len(bad)} not ok, {secs:.1f} s")
    if proc.returncode != 0 or bad or not rows:
        raise AssertionError(f"doctor: rc {proc.returncode}, not ok: {bad}; "
                             f"stderr: {proc.stderr[-2000:]}")
    return dict(rc=proc.returncode, rows=rows, seconds=secs)


def native_phase() -> dict:
    """Phase 37: the native helpers built on the card's host, each held
    to its Python twin."""
    import torch
    from parallelraytracing_tpu_torch import Scene, ScenePreset, native
    from parallelraytracing_tpu_torch.accel.lbvh import build_bvh
    from parallelraytracing_tpu_torch.core.mesh import icosphere, load_ply
    from parallelraytracing_tpu_torch.utils.png import decode_png, encode_png
    t0 = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - t0
    if not ok:
        log = native.build_log()
        err = next((x for x in log.splitlines() if "error" in x.lower()),
                   log.splitlines()[-1] if log else "(no log)")
        phase("native", f"build failed: {err}")
        raise AssertionError("native: the build failed:\n" + log[-3000:])
    cmd = native.build_log().splitlines()[0]
    phase("native", f"built {native.library_path().name} in {build_s:.2f} s "
          f"(g++ {' '.join(native.CXXFLAGS + native.LDFLAGS)})")
    fields = ("node_min", "node_max", "node_kind", "node_idx", "node_miss",
              "node_ord")
    rec = {"build_s": build_s, "command": cmd}
    scenes = {"headline": Scene(ScenePreset.RANDOM_BALLS_LARGE)}
    s = Scene(preset=None)
    s.add_mesh(icosphere(MESH_LEVEL), s.add_lambertian((0.5, 0.5, 0.5)), None)
    scenes[f"icosphere{MESH_LEVEL}"] = s
    for tag, scene in scenes.items():
        sd = scene.build("cpu")
        py, py_s = _seconds(lambda: build_bvh(sd, prefer_native=False))
        nat, nat_s = _seconds(lambda: build_bvh(sd))
        same = all(torch.equal(getattr(py, f), getattr(nat, f)) for f in fields)
        rec[f"lbvh_{tag}"] = dict(nodes=int(py.node_kind.shape[0]),
                                  python_s=py_s, native_s=nat_s, equal=same)
        phase("native", f"LBVH of {tag}: {py.node_kind.shape[0]} nodes, native "
              f"{nat_s:.4f} s vs Python {py_s:.4f} s, arrays equal: {same}")
        if not same:
            raise AssertionError(f"native LBVH of {tag} differs from Python")
    with tempfile.TemporaryDirectory() as tmp:
        for level in (MESH_LEVEL, 7):
            ply = str(Path(tmp) / f"icosphere{level}.ply")
            n_tri = write_ply(ply, level)
            py, py_s = _seconds(lambda: load_ply(ply, prefer_native=False))
            nat, nat_s = _seconds(lambda: load_ply(ply))
            same = all(np.array_equal(getattr(py, f), getattr(nat, f))
                       for f in ("vertices", "indices", "normals"))
            same = same and py.texcoords is None and nat.texcoords is None
            rec[f"ply_level{level}"] = dict(triangles=n_tri, python_s=py_s,
                                            native_s=nat_s, equal=same)
            phase("native", f"load_ply level {level} ({n_tri} triangles): "
                  f"native {nat_s:.4f} s vs Python {py_s:.4f} s, arrays "
                  f"equal: {same}")
            if not same:
                raise AssertionError(f"native load_ply level {level} differs")
    r, film = make_renderer("random_balls_large", MAIN_W, MAIN_H,
                            max_depth=MAIN_DEPTH, jitter=True, seed=0)
    r.progressive_render()
    img = film.display_numpy()
    reps = 5
    data, nat_s = _seconds(lambda: [native.encode_png(img, level=1)
                                    for _ in range(reps)])
    py_data, py_s = _seconds(lambda: encode_png(img, level=1))
    same = bool(np.array_equal(decode_png(data[0]), img)
                and np.array_equal(decode_png(py_data), img))
    rec["png_1080p"] = dict(native_ms=nat_s * 1e3 / reps, python_ms=py_s * 1e3,
                            native_bytes=len(data[0]),
                            python_bytes=len(py_data), round_trip=same)
    phase("native", f"encode_png of a {MAIN_W}x{MAIN_H} display (level 1): "
          f"native {nat_s * 1e3 / reps:.2f} ms a call ({len(data[0])} bytes), "
          f"Python {py_s * 1e3:.2f} ms ({len(py_data)} bytes); both decode "
          f"to the display: {same}")
    if not same:
        raise AssertionError("native encode_png does not round-trip")
    return rec


#: phase 38: frames of the headline's and the mesh's film checks, and
#: the seconds a world of ranks on the card may take before it is killed
SHARD_FRAMES, SHARD_MESH_FRAMES, SHARD_WORLD_S = 4, 2, 240


def turns_ms(fns: dict, reps: int) -> dict:
    """Mean ms a call of each of `fns`, called in turns (one call of each a
    turn, `reps` turns), each call between its own CUDA events."""
    import torch
    events = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events[k].append((start, end))
    torch.cuda.synchronize()
    return {k: sum(a.elapsed_time(b) for a, b in v) / reps
            for k, v in events.items()}


def host_ms(fn, reps: int = 5) -> float:
    """Mean ms of fn() then a device synchronize, on the host's clock (a
    collective over gloo waits on the host)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _hdr(film) -> np.ndarray:
    return film.hdr_average().cpu().numpy()


def _sharded_rank(rank: int, store: str, out: str, ply: str) -> None:
    """Phase 38 (c), one of two ranks on cuda:0 joined over gloo (NCCL
    refuses two ranks on one device): the headline at 2x1 (SHARD_FRAMES
    frames, the film gathered; rank 0 saves it) and at 1x2 (frame 0's
    sample buffer: the mean of spp streams 0 and 1; rank 0 saves it), the
    mesh at 2x1 through the segmented route (SHARD_MESH_FRAMES frames,
    gathered and saved); each timed over TIMED frames, with the gather's
    and the all-reduce's ms alone.  The record goes to out/rank<r>.json."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    from parallelraytracing_tpu_torch.ops.segment import segment
    from parallelraytracing_tpu_torch.ops.trace import trace
    from parallelraytracing_tpu_torch.parallel.sharding import sum_spp
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    rec = {}
    cfg = dict(max_depth=MAIN_DEPTH, jitter=True)
    try:
        r, film = make_renderer("random_balls_large", MAIN_W, MAIN_H,
                                "sharded", attrs={"spp_axis": 1}, **cfg)
        trace.launches = 0
        for _ in range(SHARD_FRAMES):
            r.progressive_render()
        launches = trace.launches
        r.gather_film()
        if rank == 0:
            np.save(Path(out) / "head_2x1.npy", _hdr(film))
        rec["2x1"] = dict(shape=r._mesh.shape, block=list(film.block),
                          launches=launches,
                          ms=cuda_ms(r.progressive_render, TIMED),
                          gather_ms=host_ms(r.gather_film))
        del r, film

        r, film = make_renderer("random_balls_large", MAIN_W, MAIN_H,
                                "sharded", attrs={"spp_axis": 2}, **cfg)
        buf = r.render_sample_buffer(0)
        if rank == 0:
            np.save(Path(out) / "head_1x2.npy", buf.cpu().numpy())
        x = torch.ones_like(buf)
        rec["1x2"] = dict(shape=r._mesh.shape,
                          ms=cuda_ms(r.progressive_render, TIMED),
                          allreduce_ms=host_ms(lambda: sum_spp(x, r._mesh)),
                          allreduce_bytes=x.numel() * 4)
        del r, film, buf, x

        r, film = mesh_renderer("sharded", ply, MAIN_W, MAIN_H, **cfg)
        trace.launches = segment.launches = 0
        for _ in range(SHARD_MESH_FRAMES):
            r.progressive_render()
        launches = (trace.launches, segment.launches)
        r.gather_film()
        if rank == 0:
            np.save(Path(out) / "mesh_2x1.npy", _hdr(film))
        rec["mesh_2x1"] = dict(shape=r._mesh.shape, route=(
            "segmented" if r._use_seg else "fused"),
            schedule=list(r._schedule), trace_launches=launches[0],
            segment_launches=launches[1],
            ms=cuda_ms(r.progressive_render, TIMED),
            gather_ms=host_ms(r.gather_film))
        rec = {"ok": True, **rec}
    except BaseException:
        rec = {"ok": False, "error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    Path(out, f"rank{rank}.json").write_text(json.dumps(rec))


def _nccl_rank(rank: int, store: str, out: str) -> None:
    """Phase 38 (c): NCCL's answer to two ranks on cuda:0, one line."""
    import datetime

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    try:
        dist.init_process_group(
            "nccl", store=dist.FileStore(store, 2), rank=rank, world_size=2,
            timeout=datetime.timedelta(seconds=60),
            device_id=torch.device("cuda", 0))
        x = torch.ones(1, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        msg = "accepted: all_reduce of two ranks on cuda:0 ran"
        dist.destroy_process_group()
    except Exception as e:  # the refusal is the phase's record
        msg = f"{type(e).__name__}: {e}"
    Path(out, f"nccl{rank}.txt").write_text(msg)


def run_ranks(target, args, tag: str, timeout: float) -> float:
    """Spawn two ranks of target(rank, store, out, *args) and join them;
    past `timeout` seconds kill the ranks and fail.  Returns the seconds."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=target, args=(rank,) + tuple(args))
             for rank in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(0.0, timeout - (time.perf_counter() - t0)))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung:
        raise AssertionError(f"sharded {tag}: ranks still running after "
                             f"{timeout} s: killed")
    return time.perf_counter() - t0


def sharded_phase() -> dict:
    """Phase 38: the sharded engine on the headline and the level-5 mesh
    at 1920x1080, depth 20: (a) at 1x1 without a process group, the film
    bit-equal to fused's, one trace launch a frame, then frames timed in
    turns with fused; (b) the mesh through the segmented route, the film
    bit-equal to wavefront_fused's (same schedule and sort mode), its
    segment launches; (c) two ranks spawned on cuda:0 over gloo
    (_sharded_rank): the 2x1 films bit-equal to (a)'s fused and (b)'s
    wavefront_fused films, the 1x2 frame bit-equal to the mean of spp
    streams 0 and 1 traced one by one on the 1x1 path; NCCL's refusal of
    two ranks on one device (_nccl_rank)."""
    import torch

    from parallelraytracing_tpu_torch.ops.rays import (frame_stream_seeds,
                                                       sample_key)
    from parallelraytracing_tpu_torch.ops.segment import segment
    from parallelraytracing_tpu_torch.ops.trace import trace
    from parallelraytracing_tpu_torch.parallel.sharding import fused_block
    t_phase = time.perf_counter()
    cfg = dict(max_depth=MAIN_DEPTH, jitter=True)
    rec = {}
    # (a) the headline at 1x1
    sh, sh_film = make_renderer("random_balls_large", MAIN_W, MAIN_H,
                                "sharded", **cfg)
    fu, fu_film = make_renderer("random_balls_large", MAIN_W, MAIN_H, **cfg)
    trace.launches = 0
    for _ in range(SHARD_FRAMES):
        sh.progressive_render()
    torch.cuda.synchronize()
    launches = trace.launches
    for _ in range(SHARD_FRAMES):
        fu.progressive_render()
    head = _hdr(fu_film)
    same = _same_film(sh_film, fu_film)
    phase("sharded", f"(a) 1x1 random_balls_large {MAIN_W}x{MAIN_H} depth "
          f"{MAIN_DEPTH}: mesh {sh._mesh.shape}, film after {SHARD_FRAMES} "
          f"frames bit-equal to fused's: {same}; trace launches "
          f"{launches} in {SHARD_FRAMES} frames")
    if not same or launches != SHARD_FRAMES:
        raise AssertionError("sharded 1x1: film or launches wrong")
    ms = turns_ms({"sharded": sh.progressive_render,
                   "fused": fu.progressive_render}, TIMED)
    rec["1x1"] = dict(launches=launches, film_equal=same, ms=ms["sharded"],
                      fused_ms=ms["fused"])
    phase("sharded", f"(a) {TIMED} frames in turns: sharded "
          f"{ms['sharded']:.3f} ms/frame, fused {ms['fused']:.3f}")
    # the 1x2 check's inputs: streams 0 and 1 of frame 0 on the 1x1 path
    c = sh.config
    jseed0, seed0 = frame_stream_seeds(sample_key(c.seed, 0, 0))
    streams = [fused_block(c, sh._tables, sh._cam_params, seed0, jseed0,
                           sh._sperm, i) for i in (0, 1)]
    mean2 = ((streams[0] + streams[1]) / 2 / c.samples_per_frame).cpu().numpy()
    del sh, sh_film, fu, fu_film, streams

    with tempfile.TemporaryDirectory() as tmp:
        ply = str(Path(tmp) / f"icosphere{MESH_LEVEL}.ply")
        write_ply(ply)
        # (b) the mesh through the segmented route at 1x1
        sm, sm_film = mesh_renderer("sharded", ply, MAIN_W, MAIN_H, **cfg)
        wf, wf_film = mesh_renderer("wavefront_fused", ply, MAIN_W, MAIN_H,
                                    attrs={"sort_rays": sm.sort_rays}, **cfg)
        trace.launches = segment.launches = 0
        for _ in range(SHARD_MESH_FRAMES):
            sm.progressive_render()
        torch.cuda.synchronize()
        seg_launches, tr_launches = segment.launches, trace.launches
        for _ in range(SHARD_MESH_FRAMES):
            wf.progressive_render()
        mesh_hdr = _hdr(wf_film)
        same = _same_film(sm_film, wf_film)
        sched = list(sm._schedule)
        phase("sharded", f"(b) 1x1 mesh (level {MESH_LEVEL}): route "
              f"{'segmented' if sm._use_seg else 'fused'}, schedule "
              f"{tuple(sched)} (wavefront_fused "
              f"{tuple(wf.segment_lengths())}), sort {sm.sort_rays!r}; film "
              f"after {SHARD_MESH_FRAMES} frames bit-equal: {same}; segment "
              f"launches {seg_launches}, trace launches {tr_launches}")
        if (not same or not sm._use_seg or tr_launches
                or seg_launches != SHARD_MESH_FRAMES * len(wf.segment_lengths())):
            raise AssertionError("sharded mesh 1x1: film, route or launches "
                                 "wrong")
        ms = turns_ms({"sharded": sm.progressive_render,
                       "wavefront_fused": wf.progressive_render}, TIMED)
        n_segs = len(wf.segment_lengths())
        rec["mesh_1x1"] = dict(schedule=sched, segment_launches=seg_launches,
                               film_equal=same, ms=ms["sharded"],
                               wavefront_fused_ms=ms["wavefront_fused"])
        phase("sharded", f"(b) {TIMED} frames in turns: sharded "
              f"{ms['sharded']:.3f} ms/frame, wavefront_fused "
              f"{ms['wavefront_fused']:.3f}")
        del sm, sm_film, wf, wf_film
        torch.cuda.empty_cache()

        # (c) two ranks on the one card over gloo
        secs = run_ranks(_sharded_rank, (str(Path(tmp) / "store"), tmp, ply),
                         "gloo", SHARD_WORLD_S)
        ranks = [json.loads(Path(tmp, f"rank{i}.json").read_text())
                 for i in range(2)]
        for i, rr in enumerate(ranks):
            if not rr["ok"]:
                raise AssertionError(f"sharded rank {i}:\n{rr['error']}")
        checks = {
            "head_2x1": np.array_equal(np.load(Path(tmp, "head_2x1.npy")),
                                       head),
            "mesh_2x1": np.array_equal(np.load(Path(tmp, "mesh_2x1.npy")),
                                       mesh_hdr),
            "head_1x2": np.array_equal(np.load(Path(tmp, "head_1x2.npy")),
                                       mean2)}
        for tag in ("2x1", "1x2", "mesh_2x1"):
            for i, rr in enumerate(ranks):
                x = rr[tag]
                phase("sharded", f"(c) gloo rank {i} {tag}: mesh "
                      f"{x['shape']}, {x['ms']:.3f} ms/frame"
                      + (f", gather {x['gather_ms']:.3f} ms"
                         if "gather_ms" in x else "")
                      + (f", all-reduce of {x['allreduce_bytes']} B "
                         f"{x['allreduce_ms']:.3f} ms"
                         if "allreduce_ms" in x else "")
                      + (f", block {x['block']}, trace launches "
                         f"{x['launches']}" if "block" in x else "")
                      + (f", route {x['route']} {tuple(x['schedule'])}, "
                         f"segment launches {x['segment_launches']}, trace "
                         f"launches {x['trace_launches']}"
                         if "route" in x else ""))
        phase("sharded", f"(c) two ranks in {secs:.1f} s: 2x1 headline film "
              f"bit-equal to fused's: {checks['head_2x1']}; 2x1 mesh film "
              f"bit-equal to wavefront_fused's: {checks['mesh_2x1']}; 1x2 "
              f"frame bit-equal to the mean of streams 0 and 1: "
              f"{checks['head_1x2']}")
        seg_ok = all(rr["mesh_2x1"]["segment_launches"]
                     == SHARD_MESH_FRAMES * n_segs
                     and rr["mesh_2x1"]["trace_launches"] == 0
                     and rr["2x1"]["launches"] == SHARD_FRAMES
                     for rr in ranks)
        if not all(checks.values()) or not seg_ok:
            raise AssertionError(f"sharded 2 ranks: {checks}, launches ok "
                                 f"{seg_ok}")
        rec["gloo_2_ranks"] = dict(ranks=ranks, checks=checks, seconds=secs)

        run_ranks(_nccl_rank, (str(Path(tmp) / "nccl_store"), tmp), "nccl",
                  90)
        nccl = [Path(tmp, f"nccl{i}.txt").read_text() for i in range(2)]
    for i, msg in enumerate(nccl):
        phase("sharded", f"(c) nccl, two ranks on cuda:0, rank {i}: "
              + " | ".join(x.strip() for x in msg.splitlines() if x.strip()))
    rec["nccl_two_ranks_one_card"] = nccl
    rec["seconds"] = time.perf_counter() - t_phase
    phase("sharded", f"phase 38 in {rec['seconds']:.1f} s")
    return rec


#: phase 39: the raygen kernel's cases at the main paths' shapes, (name,
#: width, height, yaw in degrees, jitter, lens, QMC, ids): "morton" the
#: fused engines' ids, "px_block" the last of RAYGEN_PX blocks of the
#: sharded engine's slots (Morton ids, then ids past H*W), timed reps
RAYGEN_LENS = (LENS_RADIUS, FOCUS_DISTANCE)
RAYGEN_CASES = (
    ("headline", MAIN_W, MAIN_H, 0.0, True, None, False, "morton"),
    ("orbit_360p_yaw", 640, 360, 0.75, True, None, False, "morton"),
    ("no_jitter", MAIN_W, MAIN_H, 0.0, False, None, False, "morton"),
    ("qmc", MAIN_W, MAIN_H, 0.0, True, None, True, "morton"),
    ("lens", MAIN_W, MAIN_H, 0.0, True, RAYGEN_LENS, False, "morton"),
    ("lens_qmc", MAIN_W, MAIN_H, 0.0, True, RAYGEN_LENS, True, "morton"),
    ("lens_center", MAIN_W, MAIN_H, 0.0, False, RAYGEN_LENS, False,
     "morton"),
    ("sharded_px_block", MAIN_W, MAIN_H, 0.0, True, None, False,
     "px_block"),
)
RAYGEN_PX, RAYGEN_REPS = 7, 20
#: bytes a camera ray moves through the raygen kernel: its pixel id read,
#: o and d written
RAYGEN_RAY_BYTES = 4 + 24


def raygen_phase(peaks) -> dict:
    """Phase 39: the raygen kernel (ops/rays.generate_camera_rays_ids on
    CUDA tensors, csrc/raygen.cu) against its plain chain
    (generate_camera_rays_ids_reference) on the card, o and d held equal
    with torch.equal for every case of RAYGEN_CASES; then both timed on
    the headline case: the kernel's device ms a launch under the profiler
    (RAYGEN_REPS launches), the wrapper's and the chain's ms a call by
    CUDA events (the host's rate: RAYGEN_REPS calls, 3 chains), beside
    the kernel's bytes bound at the measured read rate and at 3.35 TB/s.
    Raises on a miss; returns the record."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from parallelraytracing_tpu_torch import Camera
    from parallelraytracing_tpu_torch.benchmarks.roofline import PEAK_BYTES
    from parallelraytracing_tpu_torch.engines.fused import morton_pixel_perm
    from parallelraytracing_tpu_torch.ops import rays
    seed = 0xC0FFEE42  # a pixel seed above 2**31
    gen = rays.generate_camera_rays_ids
    cases, timed = {}, {}
    for name, w, h, yaw, jitter, lens, qmc, ids in RAYGEN_CASES:
        eye, look = np.array([5.0, 5.0, 8.0]), np.zeros(3)
        a = np.radians(yaw)
        rot = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                        [-np.sin(a), 0.0, np.cos(a)]])
        cam = torch.from_numpy(Camera(eye, rot @ (look - eye), float(w),
                                      float(h), 100.0).ray_params()).cuda()
        slots = morton_pixel_perm(w, h)[0]
        if ids == "px_block":
            blk = -(-w * h // RAYGEN_PX)  # sharding.shard_block_size
            slots = np.concatenate([slots, np.arange(w * h, RAYGEN_PX * blk)])
            slots = slots[(RAYGEN_PX - 1) * blk:]
        idx = torch.from_numpy(slots.astype(np.int32)).cuda()
        args = (cam, w, h, idx, jitter, seed if jitter or qmc else None,
                lens, rays.halton_qpt(5) if qmc else None)
        launches, plain = gen.launches, gen.plain
        o, d = gen(*args)
        if gen.launches != launches + 1 or gen.plain != plain:
            raise AssertionError(f"raygen {name}: {gen.launches - launches} "
                                 f"launches, {gen.plain - plain} plain")
        ro, rd = rays.generate_camera_rays_ids_reference(*args)
        bad = int(((o != ro).any(1) | (d != rd).any(1)).sum())
        cases[name] = dict(rays=int(idx.numel()), rays_differ=bad,
                           past_hw=int((idx >= w * h).sum()))
        if name == "headline":
            timed = dict(args=args, rays=int(idx.numel()))
    phase("raygen-vs-plain", "o and d against the plain chain on the card "
          "(rays differing of rays): " + ", ".join(
              f"{k} {v['rays_differ']} of {v['rays']}"
              + (f" ({v['past_hw']} past H*W)" if v["past_hw"] else "")
              for k, v in cases.items()))
    if any(v["rays_differ"] for v in cases.values()):
        raise AssertionError(f"raygen kernel differs from the chain: {cases}")
    args, n = timed["args"], timed["rays"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(RAYGEN_REPS):
            gen(*args)
        torch.cuda.synchronize()
    # the profiler may miss the first launches after it starts (16 of 20
    # seen on the H100): the mean is over the launches it recorded
    us = [e.time_range.elapsed_us() for e in prof.events()
          if "raygen_kernel" in e.name]
    if not us:
        raise AssertionError(f"the profiler saw no raygen kernel of "
                             f"{RAYGEN_REPS} launches")
    ms = sum(us) / len(us) / 1e3
    call_ms = cuda_ms(lambda: gen(*args), RAYGEN_REPS)
    plain_ms = cuda_ms(lambda: rays.generate_camera_rays_ids_reference(
        *args), 3)
    nbytes = RAYGEN_RAY_BYTES * n
    bound_ms = nbytes / peaks["bytes"] * 1e3
    sheet_ms = nbytes / PEAK_BYTES * 1e3
    phase("raygen", f"headline {MAIN_W}x{MAIN_H} with jitter, {n} rays: "
          f"kernel {ms * 1e3:.1f} us of device a launch (the mean of "
          f"{len(us)} the profiler recorded; {call_ms:.3f} ms "
          f"a call of its wrapper), plain chain {plain_ms:.3f} ms a call; "
          f"bound "
          f"{bound_ms * 1e3:.1f} us ({RAYGEN_RAY_BYTES} B a ray at the "
          f"measured read rate; {sheet_ms * 1e3:.1f} us at the data "
          f"sheet's), share {bound_ms / ms:.1%}")
    return dict(cases=cases, ms=ms, profiled=len(us), call_ms=call_ms,
                plain_ms=plain_ms,
                bound_ms=bound_ms, datasheet_bound_ms=sheet_ms, bytes=nbytes,
                rays=n)


def _seconds(fn):
    """(fn(), its host seconds)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--png-dir", default=None,
                    help="also copy the main paths' PNGs into this directory")
    ap.add_argument("--big-level", type=int, default=7, choices=(7, 8),
                    help="the largest icosphere level of the stream phases: "
                         "7 (327,680 triangles), or 8 to add phase 22 "
                         "(1,310,720 triangles; minutes of host packing)")
    ap.add_argument("--stream-sweep", action="store_true",
                    help="also time the level-7 stream route at chunks 64, "
                         "128 and 256 and compare the level-6 layouts one "
                         "bounce at a time (how STREAM_CHUNK was chosen)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from parallelraytracing_tpu_torch.engines.wavefront_fused import (
        count_frame_rays, segmented_trace)
    from parallelraytracing_tpu_torch.ops import _build
    from parallelraytracing_tpu_torch.ops.rays import generate_camera_rays_ids
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
    _build.build_all(list(_build.LIBRARIES))
    for lib in _build.LIBRARIES:
        _build.load(lib)
    build_s = time.perf_counter() - t0
    ptxas = [ptxas_summary(lib, _build.library_path(lib).with_suffix(".log"))
             for lib in _build.LIBRARIES]
    phase("build", f"{' + '.join(f'{lib}.cu' for lib in _build.LIBRARIES)} "
                   f"in {build_s:.2f} s; ptxas: "
                   f"{' | '.join(x for x in ptxas if x)}")
    insts = trace_instantiations()
    seg_insts = segment_instantiations()
    for lib, xs in (("trace", insts), ("segment", seg_insts)):
        phase("build", f"{lib} persistent launches (grid x threads, "
              f"blocks/SM, registers, local bytes): " + "; ".join(
                  f"{x.get('tag', x['variant'])} {x['grid']}x{x['threads']}, "
                  f"{x['blocks_per_sm']}/SM, {x['registers']} reg, "
                  f"{x['local_bytes']} B" for x in xs))

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
    args_t = (o, d, pix, seed, main_r._tables, main_r.config)
    kernel_ms = cuda_ms(lambda: trace(*args_t), 5)
    plain_ms = cuda_ms(lambda: trace_reference(*args_t), 1)
    trace_bound = trace_bounds(main_r, (o, d, pix, seed),
                               sum(depth_counts(main_r)), tag="headline")
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
    generate_camera_rays_ids.launches = generate_camera_rays_ids.plain = 0
    frame_ms = cuda_ms(main_r.progressive_render, TIMED)
    launches = trace.launches
    raygen_launches = (generate_camera_rays_ids.launches,
                       generate_camera_rays_ids.plain)
    samples = MAIN_W * MAIN_H * main_r.config.samples_per_frame
    phase("main-path", f"fused {MAIN_W}x{MAIN_H} depth {MAIN_DEPTH}: "
          f"{frame_ms:.3f} ms/frame, {samples / frame_ms / 1e3:.3f} "
          f"Msamples/s over {TIMED} frames; trace launches {launches}; "
          f"raygen launches {raygen_launches[0]}, plain chains "
          f"{raygen_launches[1]}")
    if launches < TIMED or segment.launches:
        raise AssertionError(f"{launches} trace launches in {TIMED} frames, "
                             f"{segment.launches} segment launches")
    if raygen_launches != (TIMED, 0):
        raise AssertionError(f"raygen (launches, plain chains) "
                             f"{raygen_launches} in {TIMED} frames")
    phase("main-path", check_film(main_film, main_r._tables.sky,
                                  "random_balls_large", args.png_dir))
    # 23. the probes on the headline
    probe_check(main_r, "headline")
    # 26. path regeneration: the persistent kernel against the probe's loop
    regen = regeneration_phase(main_r)
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

        seg_cmp = segment_both(wf_r)
        seg_err = seg_cmp["max_abs_err"]

        def segmented(fn):
            return lambda o, d, pix, seed: segmented_trace(
                wf_r._tables, o, d, pix, seed, wf_r.config, schedule=sched,
                seg_fn=fn)
        seg_rmse = film_rmse(wf_r, CMP_FRAMES, segmented(segment),
                             segmented(segment_reference))
        phase("mesh-segment-vs-plain", f"{size}: one 2-bounce segment: "
              f"{segment_line(seg_cmp)}; segmented_trace {sched} "
              f"x{CMP_FRAMES} frames HDR RMSE {seg_rmse:.3e}")
        if not segment_agrees(seg_cmp) or not seg_rmse < FILM_RMSE:
            raise AssertionError("mesh: segment kernel disagrees with plain")

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
        segs = segment_bounds(check_segments(mw_r, "mesh"), mw_r._tables,
                              depth_counts(mw_r), mw_r.sort_rays)
        seg_bound = segs[0]
        seg_main_launch = segment_launch(mw_r)
        phase("segment-bounds", "mesh frame 0, every segment's walk-shape "
              "bound at the data sheet's rates (queue bytes: live slots "
              "read, survivors and ended paths written): " + "; ".join(
                  f"{sg['bounces']} bounces {sg['bound_ms']:.4f} ms "
                  f"({sg['bound_by']}, {sg['io_bytes']} queue bytes)"
                  for sg in segs) + f"; the first segment's queue bytes in "
              f"the one-thread-per-slot form {segs[0]['slot_io_bytes']}")
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
        probe_check(mf_r, "mesh")  # 23. the probes on the level-5 mesh
        # 27. the sort modes at 1920x1080: films bit-equal, boundaries timed
        sort_modes_phase(mw_r, mf_r, "mesh")
        del mf_r, mf_film, mw_r, mw_film

        # 8. paths A and B: NEE, kernel vs plain at 1920x1080, then timed
        paths, nee_recs = {}, {}
        for tag, preset in (("A", "cornell"), ("B", "random_balls_large")):
            r, film = make_renderer(preset, MAIN_W, MAIN_H,
                                    max_depth=MAIN_DEPTH, jitter=True,
                                    nee=True)
            nee_recs[preset] = kernel_vs_plain(r, f"path {tag}: {preset} nee")
            paths[tag] = timed_path(r, film, f"path_{tag}_{preset}_nee",
                                    args.png_dir)
            if tag == "B":  # 23. the probes with NEE's shadow walks
                probe_check(r, "headline nee (path B)")
            del r, film

        # 9. Russian roulette, kernel vs plain at 1920x1080 (NEE off)
        r, _ = make_renderer("random_balls_large", MAIN_W, MAIN_H,
                             max_depth=MAIN_DEPTH, jitter=True,
                             russian_roulette_depth=RR_DEPTH)
        rr_rec = kernel_vs_plain(r, f"random_balls_large rr_depth {RR_DEPTH}")
        del r

        # 10. path C: wavefront_fused on CORNELL with NEE and roulette; every
        # segment of frame 0 against the plain version, then the two
        # engines' films, then timed
        cfg_c = dict(max_depth=MAIN_DEPTH, jitter=True, nee=True,
                     russian_roulette_depth=RR_DEPTH)
        c_r, c_film = make_renderer("cornell", MAIN_W, MAIN_H,
                                    "wavefront_fused", **cfg_c)
        segs_c = segment_bounds(check_segments(c_r, "path C: cornell nee rr"),
                                c_r._tables, depth_counts(c_r), c_r.sort_rays)
        cf_r, cf_film = make_renderer("cornell", MAIN_W, MAIN_H, **cfg_c)
        for _ in range(AGREE_FRAMES):
            c_r.progressive_render()
            cf_r.progressive_render()
        diff = c_film.hdr_average() - cf_film.hdr_average()
        c_rmse, c_max = float(diff.pow(2).mean().sqrt()), float(diff.abs().max())
        phase("engines-agree", f"path C {MAIN_W}x{MAIN_H} x{AGREE_FRAMES} "
              f"frames: wavefront_fused vs fused, nee + rr_depth {RR_DEPTH}: "
              f"HDR RMSE {c_rmse:.3e}, max abs diff {c_max!r}")
        if not c_rmse < FILM_RMSE:
            raise AssertionError("path C: wavefront_fused and fused disagree")
        sort_modes_phase(c_r, cf_r, "path C")  # 27.
        del cf_r, cf_film, diff
        paths["C"] = timed_path(c_r, c_film, "path_C_cornell_nee_rr",
                                args.png_dir)
        del c_r, c_film

        # 11. path D: the mesh with NEE; kernels vs plain at CMP_W x CMP_H
        # (a 1080p plain mesh frame with NEE takes ~45 s), then timed at
        # 1920x1080
        d_r, _ = mesh_renderer("fused", ply, CMP_W, CMP_H,
                               max_depth=MAIN_DEPTH, jitter=True, nee=True)
        mesh_nee = kernel_vs_plain(d_r, "path D: mesh nee")
        probe_check(d_r, "mesh nee (path D)")  # 23.
        del d_r
        dw_r, _ = mesh_renderer("wavefront_fused", ply, CMP_W, CMP_H,
                                max_depth=MAIN_DEPTH, jitter=True, nee=True)
        mesh_nee_seg = segment_both(dw_r)
        phase("segment-vs-plain", f"path D: mesh nee {size}, one 2-bounce "
              f"segment: {segment_line(mesh_nee_seg)}")
        if not segment_agrees(mesh_nee_seg):
            raise AssertionError("path D: segment kernel disagrees with plain")
        del dw_r
        dm_r, dm_film = mesh_renderer("wavefront_fused", ply, MAIN_W, MAIN_H,
                                      max_depth=MAIN_DEPTH, jitter=True,
                                      nee=True)
        paths["D"] = timed_path(dm_r, dm_film, "path_D_mesh_nee", args.png_dir)
        del dm_r, dm_film

        # 28. the segment kernel's queue at its edges
        edges = queue_edge_phase(ply)

        # 12-15. the instanced path
        inst = instanced_phases(ply, args.png_dir)

        # 17-19. the scene extensions (T1-T3)
        from parallelraytracing_tpu_torch.core.mesh import load_ply
        ext = extension_phases(load_ply(ply), args.png_dir)

    # 16. NEE is unbiased and lowers the error on the card
    unbiased = nee_unbiased()

    # 20-22. a big mesh on the stream route
    stream = stream_phases(args.png_dir, range(7, args.big_level + 1),
                           args.stream_sweep)

    # 24. depth_sort on the headline
    ds_rec = depth_sort_phase()

    # 25. the float32 peak micro and the read rate; every trace bound at
    # the measured peaks
    mic = micro_phase(smi)

    # 29-32. the reference engine and what stands on it: bench's
    # converged-spp gates, the megakernel frame, the adaptive engine (K1
    # on the selected ids) and the denoiser
    gates = gate_phase()
    mk_rec = megakernel_phase()
    adapt = adaptive_phase(args.png_dir, mic["peaks"])
    den_rec = denoise_phase(args.png_dir)

    # 33. the plain PyTorch LBVH engines at full size, config 5's refit
    # and tlas_ref
    lbvh_rec = lbvh_phase(args.png_dir)

    # 34-37. the app layer: the viewer on the main path, the headline
    # frame's host stages, the doctor and the native helpers
    t_app = time.perf_counter()
    app_rec = {"viewer": app_phase(args.png_dir),
               "host_stages": host_stages_phase(args.png_dir),
               "doctor": doctor_phase(), "native": native_phase()}
    app_rec["seconds"] = time.perf_counter() - t_app
    phase("app", f"phases 34-37 in {app_rec['seconds']:.1f} s")

    # 38. the sharded engine: 1x1 against fused and wavefront_fused, two
    # ranks on the card over gloo
    shard_rec = sharded_phase()

    # 39. the raygen kernel against its plain chain at the main paths'
    # shapes
    raygen_rec = raygen_phase(mic["peaks"])

    print(smi)
    print(json.dumps({"lbvh_engines": lbvh_rec}))
    print(json.dumps({"app": app_rec}))
    print(json.dumps({"sharded": shard_rec}))
    seg0 = segs[0]
    nee_recs["mesh"] = mesh_nee
    inst_cmp = inst["vs_plain"].values()
    trace_recs = list(nee_recs.values()) + [rr_rec] \
        + [x["trace"] for x in inst_cmp]
    seg_recs = segs + segs_c + [mesh_nee_seg] + [x["segment"] for x in inst_cmp]
    bound_note = ("bound_ms for the launch of ms: max(bytes / the measured "
                  "read rate, slab operations at the measured slab-mix "
                  "rate + the other operations at the measured fma-mix "
                  "rate), its walk term the shallowest root-to-leaf path "
                  "per ray segment (the JAX segment kernel has no counters "
                  "to hold a count to); datasheet_bound_ms the same work at "
                  "3.35 TB/s and 33.5e12 instructions/s (67 TFLOP/s, a "
                  "multiply-add counted once)")
    counted_note = ("bound_ms: the counted-visit bound (benchmarks/"
                    "roofline.py counted_bound) of the launch of ms: max("
                    "bytes / the measured read rate, the probe kernel's "
                    "counted nodes and every instance box per alive bounce "
                    "x SLAB_OPS at the measured slab-mix rate + counted "
                    "primitives x the cheapest live primitive test, alive "
                    "bounces x (SHADE_OPS + the tiny kinds' tests) and the "
                    "extensions' work at the measured fma-mix rate, one "
                    "instruction per operation); datasheet_bound_ms the "
                    "same work at 3.35 TB/s and 33.5e12 instructions/s "
                    "(67 TFLOP/s, a multiply-add counted once); the "
                    "walk-shape bound beside it")
    tb = trace_bound["counted"]
    head = PROBES["headline"]
    n_main = MAIN_W * MAIN_H
    probe_bound = bound_from(tb["slab_ops"], tb["other_ops"],
                             tb["bytes"] + n_main * (4 + 16), mic["peaks"])
    from parallelraytracing_tpu_torch.benchmarks.micro import (LOOPS,
                                                               N_ELEMS,
                                                               flops)
    from parallelraytracing_tpu_torch.benchmarks.roofline import PEAK_FLOPS
    inst_paths = inst.pop("paths")
    print(json.dumps({"kernels": [
        {"name": "trace", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": launches,
         "max_abs_err": max([max_abs_err, mesh_main_err]
                            + [x["max_abs_err"] for x in trace_recs]),
         "ms": kernel_ms, "plain_ms": plain_ms,
         "bound_ms": tb["bound_ms"], "bound_by": tb["bound_by"],
         "library_ms": None, "launch": trace_bound["launch"],
         "instantiations": insts, "regeneration": regen,
         "bound": {**trace_bound, "note": counted_note},
         "size": f"ms, plain_ms, launches: random_balls_large {MAIN_W}x"
                 f"{MAIN_H} depth {MAIN_DEPTH} without NEE, one frame "
                 f"(launches over its {TIMED} timed frames); max_abs_err over "
                 f"every trace comparison of the run; library_ms null: no "
                 f"single PyTorch call computes a path-traced frame",
         "mesh": {"launches": f_launches, "max_abs_err": mesh_main_err,
                  "ms": mesh_main_ms, "plain_ms": mesh_main_plain_ms,
                  "size": f"{n_tri}-triangle mesh {MAIN_W}x{MAIN_H} depth "
                          f"{MAIN_DEPTH}, one frame"},
         "nee": nee_recs, "rr": rr_rec, "nee_unbiased": unbiased,
         "adaptive": {**adapt, "size": f"the adaptive engine on "
                      f"random_balls_large {MAIN_W}x{MAIN_H} depth "
                      f"{MAIN_DEPTH}: launches over its {ADAPT_FRAMES} "
                      f"adaptive frames (one a frame, on budget_ids ids), "
                      f"ms / plain_ms the kernel and the plain version on "
                      f"the first adaptive frame's ids"},
         "gates": gates, "megakernel_frame": mk_rec, "denoise": den_rec,
         "sharded": {
             "launches_1x1": shard_rec["1x1"]["launches"],
             "launches_2x1": [rr["2x1"]["launches"] for rr in
                              shard_rec["gloo_2_ranks"]["ranks"]],
             "size": f"phase 38: trace launches of the sharded engine on "
                     f"random_balls_large {MAIN_W}x{MAIN_H} depth "
                     f"{MAIN_DEPTH} over its {SHARD_FRAMES} checked frames, "
                     f"at 1x1 and on each rank of 2x1"},
         "app": {"rest_launches": app_rec["viewer"]["rest"]["trace_launches"],
                 "orbit_launches": app_rec["viewer"]["orbit"]["trace_launches"],
                 "host_stages_launches":
                     app_rec["host_stages"]["trace_launches"]},
         "paths": {k: paths[k] for k in "AB"},
         "instances": {**inst, "paths": {k: v for k, v in inst_paths.items()
                                         if "_fused" in k and "wavefront" not in k}},
         "probe": {"launches": ds_rec["launches"]["probe"],
                   "scenes": {k: {kk: vv for kk, vv in v.items()
                                  if kk != "summary"}
                              for k, v in PROBES.items()},
                   "trace_stats": {k: v["summary"] for k, v in PROBES.items()},
                   "depth_sort": ds_rec}},
        {"name": "segment", "route": "cuda", "source": SEG_SOURCE,
         "replaces": SEG_REPLACES, "launches": seg_launches,
         "max_abs_err": max([seg_err] + [x["max_abs_err"] for x in seg_recs]),
         "ms": seg0["ms"], "plain_ms": seg0["plain_ms"],
         "bound_ms": seg_bound["bound_ms"], "bound_by": seg_bound["bound_by"],
         "library_ms": None, "bound": {**seg_bound, "note": bound_note},
         "size": f"ms, plain_ms, launches: {n_tri}-triangle mesh {MAIN_W}x"
                 f"{MAIN_H} without NEE, frame 0's first segment "
                 f"({seg0['bounces']} bounces over {seg0['live']} slots; "
                 f"launches over its {TIMED} timed frames); max_abs_err over "
                 f"every segment comparison of the run; library_ms null: no "
                 f"single PyTorch call computes a path segment",
         "launch": seg_main_launch, "instantiations": seg_insts,
         "segment_bounds_ms": [sg["bound_ms"] for sg in segs],
         "segments": segs, "nee_rr_segments": segs_c,
         "mesh_nee_segment": mesh_nee_seg, "sort_modes": SORTS,
         "queue_edges": edges,
         "app": {"switch_launches":
                 app_rec["viewer"]["switch"]["segment_launches"]},
         "sharded": {
             "launches_1x1": shard_rec["mesh_1x1"]["segment_launches"],
             "launches_2x1": [rr["mesh_2x1"]["segment_launches"] for rr in
                              shard_rec["gloo_2_ranks"]["ranks"]],
             "size": f"phase 38: segment launches of the sharded engine's "
                     f"segmented route on the {n_tri}-triangle mesh "
                     f"{MAIN_W}x{MAIN_H} depth {MAIN_DEPTH} over its "
                     f"{SHARD_MESH_FRAMES} checked frames, at 1x1 and on "
                     f"each rank of 2x1"},
         "paths": {k: paths[k] for k in "CD"},
         "instances": {"paths": {k: v for k, v in inst_paths.items()
                                 if "wavefront" in k}}},
        ext_kernel_record("trace", ext), ext_kernel_record("segment", ext),
        stream_kernel_record("trace", stream),
        stream_kernel_record("segment", stream),
        {"name": "trace[probe]", "route": "cuda", "source": PROBE_SOURCE,
         "replaces": REPLACES, "launches": ds_rec["launches"]["probe"],
         "max_abs_err": max(max(v["max_abs_err"], v["plain_max_abs_err"])
                            for v in PROBES.values()),
         "ms": head["ms"], "plain_ms": head["plain_ms"],
         "bound_ms": probe_bound["bound_ms"],
         "bound_by": probe_bound["bound_by"], "library_ms": None,
         "cmp_ms": head["cmp_ms"], "trace_ms": head["trace_ms"],
         "bound": {**probe_bound, "note": counted_note + "; plus the depth "
                   "and counters written, 20 bytes a ray"},
         "size": f"the probe kernel (depth_out and collect_stats): ms on the "
                 f"headline frame 0 ({MAIN_W}x{MAIN_H} depth {MAIN_DEPTH}) "
                 f"beside the trace kernel's trace_ms; launches: the probe "
                 f"frames of phase 24's depth_sort run; plain_ms on "
                 f"{PROBE_RAYS} sampled rays of it (the plain trace and the "
                 f"walk replay), cmp_ms the kernel on them; max_abs_err: the "
                 f"radiance against the trace kernel's and the plain "
                 f"version's over every scene of phase 23, whose depths and "
                 f"counters are held equal; library_ms null: no single "
                 f"PyTorch call computes it"},
        {"name": "fp32_peak", "route": "cuda", "source": MICRO_SOURCE,
         "replaces": MICRO_REPLACES, "launches": mic["launches"],
         "max_abs_err": max(c["max_abs_err"]
                            for c in mic["vs_plain"].values()),
         "ms": mic["rates"]["fma"]["ms"],
         "plain_ms": mic["vs_plain"]["fma"]["plain_ms"],
         "bound_ms": flops("fma", LOOPS, N_ELEMS) / PEAK_FLOPS * 1e3,
         "bound_by": "operations", "library_ms": None,
         "rates": mic["rates"], "read_bytes_per_s": mic["read_bytes_per_s"],
         "sass": mic["sass"], "vs_plain": mic["vs_plain"],
         "size": f"the fma mix, {N_ELEMS} elements x {LOOPS} iterations "
                 f"(ms, plain_ms); bound_ms its operations at the data "
                 f"sheet's 67 TFLOP/s, a multiply-add as 2; launches over "
                 f"phase 25's timed runs (both mixes, warm-up included); "
                 f"library_ms null: no PyTorch call computes it"},
        {"name": "raygen", "route": "cuda", "source": RAYGEN_SOURCE,
         "replaces": None, "launches": raygen_launches[0],
         "plain_launches": raygen_launches[1], "max_abs_err": 0.0,
         "ms": raygen_rec["ms"], "call_ms": raygen_rec["call_ms"],
         "plain_ms": raygen_rec["plain_ms"],
         "bound_ms": raygen_rec["bound_ms"], "bound_by": "bytes",
         "datasheet_bound_ms": raygen_rec["datasheet_bound_ms"],
         "library_ms": None, "cases": raygen_rec["cases"],
         "paths": {k: v["launches"]["raygen"] for k, v in paths.items()},
         "size": f"ms, call_ms, plain_ms: the headline's "
                 f"{raygen_rec['rays']} Morton ids at {MAIN_W}x{MAIN_H} with "
                 f"jitter: ms the kernel's device time a launch (profiler, "
                 f"mean of the {raygen_rec['profiled']} of {RAYGEN_REPS} "
                 f"launches it recorded), call_ms its wrapper's and "
                 f"plain_ms the plain chain's time a call by CUDA events "
                 f"(host-bound; {RAYGEN_REPS} calls, 3 chains); launches, "
                 f"plain_launches: phase 4's {TIMED} timed frames; paths: "
                 f"launches over each timed path's {TIMED} frames; bound_ms "
                 f"{RAYGEN_RAY_BYTES} B a ray (the id read, o and d "
                 f"written) at the measured read rate; max_abs_err 0: every "
                 f"case of phase 39 held to the plain chain with "
                 f"torch.equal; replaces null: no TPU kernel (the JAX "
                 f"package's raygen is XLA); library_ms null: no single "
                 f"PyTorch call computes it"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
