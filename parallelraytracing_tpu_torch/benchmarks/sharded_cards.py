"""The sharded engine across the cards of one host, through the CLI under
``torchrun``, against the fused engine in one process.

    python -m parallelraytracing_tpu_torch.benchmarks.sharded_cards --cards 4

For each spp axis asked for, runs ``python -m torch.distributed.run
--standalone --nproc-per-node N -m parallelraytracing_tpu_torch.cli
--engine sharded`` (one card a rank, NCCL; ``PRT_SPP_AXIS``), then the
fused engine in one process with the same scene, size, depth, frames and
seed; rank 0 and the one process write a PFM.  Each run's frames are
timed by the CLI's ``--stats`` (each rank's log kept apart by torchrun's
``--redirects``): a frame's ms on the device's clock (CUDA events around
the frame and its synchronise), frame 0 (the kernels' load and NCCL's
communicators start there) reported apart from the median of the rest.
For spp axis 1 it checks that the sharded PFM is the fused one byte for
byte (the sharded engine's contract: the same image whatever the ranks);
an spp axis of k averages k sample streams a frame, so its image is
another one.  The kernels are built once first, so the ranks do not
wait on one another's build.  ``--device cpu`` runs the same on gloo with
the plain versions (a rehearsal at a small size, no times worth keeping).
The last line is one JSON record.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path


#: the CLI's --stats line of a frame: host ms, then device ms on a card
FRAME = re.compile(r"^frame +\d+ +render +([0-9.]+) ms"
                   r"(?: +device +([0-9.]+) ms)?", re.M)


def _frames(log: str) -> dict:
    """Frame 0's ms and the median ms of the later frames of one CLI log
    (device ms where the card gave them, else host ms)."""
    ms = [float(dev or host) for host, dev in FRAME.findall(log)]
    if len(ms) < 2:
        raise RuntimeError(f"no per-frame lines in the CLI's output:\n"
                           f"{log[-2000:]}")
    return {"frame0_ms": ms[0], "ms": statistics.median(ms[1:])}


def _cli(args, extra, tmp, env=None, ranks=0):
    """One CLI run (under torch.distributed.run with `ranks` processes when
    `ranks`, each rank's output redirected to its own log): a list of
    _frames records, one a rank."""
    cmd = [sys.executable]
    logs = Path(tmp, f"logs{len(list(Path(tmp).glob('logs*')))}")
    if ranks:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(ranks), "--redirects", "3",
                "--log-dir", str(logs)]
    cmd += ["-m", "parallelraytracing_tpu_torch.cli", "--device", args.device,
            "--scene", args.scene, "--width", str(args.width), "--height",
            str(args.height), "--depth", str(args.depth), "--frames",
            str(args.frames), "--stats"] + extra
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          env={**os.environ, **(env or {})},
                          timeout=args.timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    if not ranks:
        return [_frames(proc.stdout)]
    return [_frames(next(logs.glob(f"**/{rank}/stdout.log")).read_text())
            for rank in range(ranks)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=4,
                    help="ranks (one card each with --device cuda)")
    ap.add_argument("--spp-axes", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scene", default="random_balls_large")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--depth", type=int, default=20)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < args.cards:
            print(f"sharded_cards: {torch.cuda.device_count()} cards, "
                  f"{args.cards} asked for", file=sys.stderr)
            return 1
        from parallelraytracing_tpu_torch.ops import _build
        _build.build_all(list(_build.LIBRARIES))
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        print(smi)
    rec = {"cards": args.cards, "size": f"{args.scene} {args.width}x"
           f"{args.height} depth {args.depth}, {args.frames} frames",
           "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        ref = Path(tmp, "fused.pfm")
        run = _cli(args, ["--engine", "fused", "--hdr-out", str(ref),
                          "--out", str(Path(tmp, "fused.png"))], tmp)[0]
        rec["runs"]["fused, 1 process"] = run
        print(f"fused, one process: {run['ms']:.3f} ms a frame (median of "
              f"frames 1-{args.frames - 1}), frame 0 "
              f"{run['frame0_ms']:.3f} ms", flush=True)
        for spp in args.spp_axes:
            pfm = Path(tmp, f"sharded{spp}.pfm")
            ranks = _cli(args, ["--engine", "sharded", "--hdr-out", str(pfm),
                                "--out", str(Path(tmp, f"sharded{spp}.png"))],
                         tmp, env={"PRT_SPP_AXIS": str(spp)}, ranks=args.cards)
            mesh = f"{args.cards // spp}x{spp}"
            run = {"by_rank": ranks, "ms": max(r["ms"] for r in ranks)}
            if spp == 1:
                run["pfm_equal_to_fused"] = pfm.read_bytes() == ref.read_bytes()
            rec["runs"][f"sharded {mesh}"] = run
            print(f"sharded {mesh} over {args.cards} ranks: ms a frame by "
                  f"rank {[round(r['ms'], 3) for r in ranks]}, frame 0 "
                  f"{[round(r['frame0_ms'], 3) for r in ranks]}"
                  + (f"; PFM equal to fused's: {run['pfm_equal_to_fused']}"
                     if spp == 1 else ""), flush=True)
    print(json.dumps(rec))
    bad = [k for k, v in rec["runs"].items()
           if v.get("pfm_equal_to_fused") is False]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
