"""Time the trace kernel of several trees of the port, in turns, on one card.

    python -m parallelraytracing_tpu_torch.benchmarks.trace_ab TREE [TREE ...]

Each TREE is a directory holding a ``parallelraytracing_tpu_torch/``
package (this checkout's root, or an older or changed copy of the package
unpacked beside it, e.g. ``git archive <commit>
parallelraytracing_tpu_torch``).  Every tree's trace library is built
first, one ``nvcc`` each, all started together; then each round runs
every tree once in a process of its own (the trees in order, then in
reverse, so a drift of the card's clocks falls on both sides), and each
run times, on the headline (RANDOM_BALLS_LARGE, 1920x1080, depth 20, the
fused engine), the trace kernel on the rays of frames 0 and 7 (CUDA
events around ``--reps`` launches after two warm-up launches, through the
engine's ``trace_tables``, so a tree's once-per-scene tables are used as
its engine uses them) and the engine's ms/frame over 8 frames.  Each run
prints one JSON line; the last line is the mean per tree over the rounds,
with the registers, stack frame and spills of the headline's
instantiation from the tree's ptxas log and the card's name and power
limit.  The probe and trace_reference are not run: a tree only needs the
fused engine's API, which every version of the port has.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

#: the headline's instantiation (no triangles, NEE, roulette, instances
#: or scene extensions) in a mangled kernel name
HEADLINE_VARIANT = "ILi0ELb0ELb0ELb0ELb0E"


def _env(tree: Path) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tree) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _ptxas(tree: Path) -> dict:
    """Registers, stack frame and spill stores of the headline's trace
    instantiation, from the newest trace build log of `tree`."""
    logs = sorted((tree / "build" / "kernels").glob("libtrace_*.log"),
                  key=lambda p: p.stat().st_mtime)
    if not logs:
        return {}
    out, inside = {}, False
    for ln in logs[-1].read_text().splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            inside = "trace_kernel" in ln and HEADLINE_VARIANT in ln
        elif inside and "stack frame" in ln:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                          ln)
            out.update(stack=int(m.group(1)), spill_stores=int(m.group(2)))
        elif inside and "Used" in ln and "registers" in ln:
            out["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
            inside = False
    return out


def inner(reps: int) -> dict:
    """One tree's run, in this process (the tree is first on sys.path)."""
    import torch
    from parallelraytracing_tpu_torch import (Film, RenderConfig, Scene,
                                              ScenePreset, create_renderer,
                                              default_camera)
    from parallelraytracing_tpu_torch.engines.fused import raygen_ids
    from parallelraytracing_tpu_torch.engines.tables import trace_tables
    from parallelraytracing_tpu_torch.ops.rays import (frame_stream_seeds,
                                                       sample_key)
    import parallelraytracing_tpu_torch as pkg
    w, h = 1920, 1080
    cfg = RenderConfig(width=w, height=h, max_depth=20)
    film = Film(w, h, "cuda")
    r = create_renderer("fused", "cuda")
    r.init(film, Scene(ScenePreset.RANDOM_BALLS_LARGE), default_camera(w, h),
           cfg)
    out = dict(tree=str(Path(pkg.__file__).resolve().parent.parent))
    for f in (0, 7):
        jseed, seed = frame_stream_seeds(sample_key(cfg.seed, f, 0))
        o, d = raygen_ids(r._cam_params, r._ids, r._pixel_seed(jseed), w, h,
                          cfg.jitter, cfg.lens, r._qpt(f, 0))

        def launch():
            return trace_tables(r._tables, o, d, r._ids, seed, cfg)
        for _ in range(2):
            launch()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        end.synchronize()
        out[f"frame{f}_ms"] = start.elapsed_time(end) / reps
    for _ in range(2):
        r.progressive_render()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(8):
        r.progressive_render()
    end.record()
    end.synchronize()
    out["ms_per_frame"] = start.elapsed_time(end) / 8
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of runs, each every tree once (default 2)")
    ap.add_argument("--reps", type=int, default=10,
                    help="launches timed per frame (default 10)")
    ap.add_argument("--inner", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.inner:
        print(json.dumps(inner(args.reps)), flush=True)
        return 0
    if not args.trees:
        ap.error("name at least one tree")
    trees = [t.resolve() for t in args.trees]
    build = "from parallelraytracing_tpu_torch.ops import _build; " \
            "_build.build('trace')"
    procs = [subprocess.Popen([sys.executable, "-c", build], env=_env(t))
             for t in trees]
    if any(p.wait() != 0 for p in procs):
        raise SystemExit("trace_ab: a tree's trace library did not build")
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
    keys = ("frame0_ms", "frame7_ms", "ms_per_frame")
    print(json.dumps({"card": smi, "rounds": args.rounds, "reps": args.reps,
                      "trees": {t: {**{k: sum(r[k] for r in rs) / len(rs)
                                       for k in keys},
                                    **_ptxas(Path(t))}
                                for t, rs in runs.items() if rs}}))
    return 0 if all(runs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
