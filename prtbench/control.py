"""The control of a cell's comparison: the reference put in the
renderer's place, computed a precision below the configuration's
float32 (bfloat16), read by the same numbers as a run.

    python3 -m prtbench.control --workload <name> --frames <n> \\
        --displays <d> --seeds <s> [<s> ...]

For each seed it draws the run's pixels, takes `n` progressive frames at
rest (the displays after evenly spaced frame counts) or `d` orbit
displays and a last frame, computes the reference in float32 and in
bfloat16 on the card (the CPU with ``--device cpu``), and prints the
compared numbers of the bfloat16 image against the float32 one, one JSON
line a seed.  The cell's limits (``checks/<workload>.json``) have to lie
below what it reads.  It needs no window: the frames and displays stand
for a run's.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from prtbench import cell, check, registry
from prtbench.run import ROOT


def control_numbers(plan: dict, seed: int, frames: int, displays: int,
                    device: str = "cuda") -> dict:
    w, h = cell.frame_size(plan)
    pixels = cell.sample_pixels(seed, w, h, plan["sample"]["pixels"])
    dev = torch.device(device)
    orbit = plan["traffic"]["motion"] == "orbit"
    if orbit:
        cams = list(range(1, displays + 1))
        disp_frames = [1] * displays
        last = displays + 1
    else:
        disp_frames = sorted({max(1, round(frames * (i + 1) / displays))
                              for i in range(displays)})
        cams = [0] * len(disp_frames)
        last = 0
    parts = {}
    for name, dtype in (("ref", torch.float32), ("control", torch.bfloat16)):
        parts[name] = cell.reference_share(plan, seed, pixels, frames,
                                           disp_frames, cams, last, w, h, dev,
                                           dtype)
    ref = {**parts["ref"], "pixels": pixels, "sample_count": 0,
           "expected_count": 0}
    return check.numbers([ref], final_hdr=parts["control"]["ref_final"],
                         disp_px=check.tonemap(parts["control"]["ref_disp"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--displays", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    plan = registry.plan(ROOT, args.workload)
    for seed in args.seeds:
        nums = control_numbers(plan, seed, args.frames, args.displays,
                               args.device)
        limits = plan["check"]["limits"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": nums,
                          "fails": [k for k, v in nums.items()
                                    if not v <= limits[k]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
