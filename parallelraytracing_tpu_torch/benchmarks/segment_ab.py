"""Time the wavefront_fused engine of several trees of the port, in turns,
on one card.

    python -m parallelraytracing_tpu_torch.benchmarks.segment_ab TREE [TREE ...]

Each TREE is a directory holding a ``parallelraytracing_tpu_torch/``
package (this checkout's root, or an older or changed copy of the package
unpacked beside it, e.g. ``git archive <commit>
parallelraytracing_tpu_torch``).  Every tree's segment library is built
first, one ``nvcc`` each, all started together; then each round runs
every tree once in a process of its own (the trees in order, then in
reverse, so a drift of the card's clocks falls on both sides), and each
run times, on three workloads, the wavefront_fused engine at its
default knobs: the mesh (the level-5 icosphere, 20,480 triangles, in the
PLY showcase scene, 1920x1080 depth 20: schedule (2, 4, 14)), T1
(texture_demo at the CLI's preset camera, 1920x1080 depth 20: segments
of 3) and level 7 (bench.py's big-mesh scene with the level-7
icosphere, 327,680 triangles on the stream route, 960x540 depth 8:
schedule (2, 6)).  For each:
every segment of frame 0 at its real queue (CUDA events around ``--reps``
launches on the segment's input), every segment boundary of frames 0-2
as the frame runs it (CUDA events from the end of one segment launch to
the start of the next), and the engine's ms/frame over 8 frames after 2
warm-up frames.  The engine's own segment function is wrapped, so every
version of the segment's signature is timed as the engine calls it.
Each run prints one JSON line; the last line is the mean per tree over
the rounds, with the registers, stack frame and spills of each
workload's segment instantiation from the tree's ptxas log and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

#: each workload's size, depth and segment instantiation (in a mangled
#: kernel name): the mesh's dense triangle fold, T1's scene extensions,
#: level 7's stream route
WORKLOADS = {"mesh": (1920, 1080, 20, "ILi1ELb0ELb0ELb0ELb0E"),
             "T1": (1920, 1080, 20, "ILi0ELb0ELb0ELb0ELb1E"),
             "level7": (960, 540, 8, "ILi2ELb0ELb0ELb0ELb0E")}


def _env(tree: Path) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tree) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _ptxas(tree: Path, variant: str) -> dict:
    """Registers, stack frame and spill stores of one segment
    instantiation, from the newest segment build log of `tree`."""
    logs = sorted((tree / "build" / "kernels").glob("libsegment_*.log"),
                  key=lambda p: p.stat().st_mtime)
    if not logs:
        return {}
    out, inside = {}, False
    for ln in logs[-1].read_text().splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            inside = "segment_kernel" in ln and variant in ln
        elif inside and "stack frame" in ln:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                          ln)
            out.update(stack=int(m.group(1)), spill_stores=int(m.group(2)))
        elif inside and "Used" in ln and "registers" in ln:
            out["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
            inside = False
    return out


def _renderer(workload: str):
    import numpy as np
    from parallelraytracing_tpu_torch import (Camera, Film, RenderConfig,
                                              Scene, ScenePreset,
                                              create_renderer)
    from parallelraytracing_tpu_torch.core.mesh import icosphere
    w, h, depth, _ = WORKLOADS[workload]
    if workload == "mesh":
        from parallelraytracing_tpu_torch.core.scene import showcase_scene
        scene, eye, look = showcase_scene(icosphere(5))
    elif workload == "T1":
        scene = Scene(ScenePreset("texture_demo"))
        eye, look = (5.0, 5.0, 8.0), (0.0, 0.0, 0.0)
    else:  # bench.py's big-mesh scene (chip_smoke.py big_mesh_scene)
        scene = Scene(preset=None)
        scene.add_mesh(icosphere(7), scene.add_lambertian((0.75, 0.65, 0.5)),
                       ((8, 8, 8), (0, 180, 0), (0, 8, 0)))
        scene.add_quad(100, 100, scene.add_lambertian((0.5, 0.5, 0.5)), None)
        scene.add_sphere(3.0, scene.add_emissive((12, 12, 12)),
                         ((1, 1, 1), (0, 0, 0), (12, 25, 12)))
        eye, look = (0.0, 14.0, 28.0), (0.0, 7.0, 0.0)
    eye, look = np.asarray(eye, np.float64), np.asarray(look, np.float64)
    r = create_renderer("wavefront_fused", "cuda")
    r.init(Film(w, h, "cuda"), scene,
           Camera(eye, look - eye, float(w), float(h), 100.0),
           RenderConfig(width=w, height=h, max_depth=depth))
    return r


def _frame_inputs(r, f: int):
    from parallelraytracing_tpu_torch.engines.fused import raygen_ids
    from parallelraytracing_tpu_torch.ops.rays import (frame_stream_seeds,
                                                       sample_key)
    cfg = r.config
    jseed, seed = frame_stream_seeds(sample_key(cfg.seed, f, 0))
    o, d = raygen_ids(r._cam_params, r._ids, r._pixel_seed(jseed), cfg.width,
                      cfg.height, cfg.jitter, cfg.lens, r._qpt(f, 0))
    return o, d, r._ids, seed


def inner(reps: int) -> dict:
    """One tree's run, in this process (the tree is first on sys.path)."""
    import torch
    import parallelraytracing_tpu_torch as pkg
    from parallelraytracing_tpu_torch.engines import wavefront_fused as wf
    launch = wf.segment
    out = dict(tree=str(Path(pkg.__file__).resolve().parent.parent))

    def event():
        return torch.cuda.Event(enable_timing=True)
    for workload in WORKLOADS:
        r = _renderer(workload)
        segs, marks = [], []

        def timed(*a, **kw):  # every segment of frame 0, `reps` launches
            for _ in range(2):
                launch(*a, **kw)
            start, end = event(), event()
            start.record()
            for _ in range(reps):
                launch(*a, **kw)
            end.record()
            end.synchronize()
            segs.append(start.elapsed_time(end) / reps)
            return launch(*a, **kw)

        def marked(*a, **kw):  # a frame as it runs, launches marked
            start, end = event(), event()
            start.record()
            res = launch(*a, **kw)
            end.record()
            marks.append((start, end))
            return res
        sched = tuple(r.segment_lengths())
        wf.segment = timed
        wf.segmented_trace(r._tables, *_frame_inputs(r, 0), r.config,
                           schedule=sched, sort_rays=r.sort_rays)
        wf.segment = marked
        gaps = []
        for f in range(3):
            marks.clear()
            wf.segmented_trace(r._tables, *_frame_inputs(r, f), r.config,
                               schedule=sched, sort_rays=r.sort_rays)
            torch.cuda.synchronize()
            gaps.append([marks[i][1].elapsed_time(marks[i + 1][0])
                         for i in range(len(marks) - 1)])
        wf.segment = launch
        for _ in range(2):
            r.progressive_render()
        start, end = event(), event()
        start.record()
        for _ in range(8):
            r.progressive_render()
        end.record()
        end.synchronize()
        out[workload] = dict(
            schedule=list(sched), segments_ms=segs,
            boundaries_ms=[sum(g[i] for g in gaps) / len(gaps)
                           for i in range(len(gaps[0]))],
            ms_per_frame=start.elapsed_time(end) / 8)
        del r
    return out


def _mean(recs: list) -> dict:
    """The mean of the runs' numbers, list by list."""
    if isinstance(recs[0], dict):
        return {k: _mean([r[k] for r in recs]) for k in recs[0]}
    if isinstance(recs[0], list):
        return [_mean(list(x)) for x in zip(*recs)]
    if isinstance(recs[0], (int, float)):
        return sum(recs) / len(recs)
    return recs[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of runs, each every tree once (default 2)")
    ap.add_argument("--reps", type=int, default=5,
                    help="launches timed per segment (default 5)")
    ap.add_argument("--inner", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.inner:
        print(json.dumps(inner(args.reps)), flush=True)
        return 0
    if not args.trees:
        ap.error("name at least one tree")
    trees = [t.resolve() for t in args.trees]
    build = "from parallelraytracing_tpu_torch.ops import _build; " \
            "_build.build('segment')"
    procs = [subprocess.Popen([sys.executable, "-c", build], env=_env(t))
             for t in trees]
    if any(p.wait() != 0 for p in procs):
        raise SystemExit("segment_ab: a tree's segment library did not build")
    runs = {str(t): [] for t in trees}
    for k in range(args.rounds):
        for t in (trees if k % 2 == 0 else trees[::-1]):
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--inner",
                 "--reps", str(args.reps)], env=_env(t),
                capture_output=True, text=True)
            if res.returncode != 0:  # the tree's run failed: say why
                print(json.dumps(dict(tree=str(t), failed=res.returncode,
                                      stderr=res.stderr[-2000:])),
                      flush=True)
                continue
            rec = json.loads(res.stdout.strip().splitlines()[-1])
            runs[str(t)].append(rec)
            print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "rounds": args.rounds, "reps": args.reps,
                      "trees": {t: {**{w: _mean([r[w] for r in rs])
                                       for w in WORKLOADS},
                                    "ptxas": {w: _ptxas(Path(t), v[3])
                                              for w, v in WORKLOADS.items()}}
                                for t, rs in runs.items() if rs}}))
    return 0 if all(runs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
