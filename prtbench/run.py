"""Run one cell of the benchmark once and print its result line.

    python3 -m prtbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s entry)
names a configuration and a traffic mix; the run builds the scene on the
card, warms every shape the window uses, measures for ``--seconds``
(``cell.py``), checks what the timed path produced against the plain
reference (``check.py``) and prints one JSON object as the last line of
standard output: ``correct``, ``attempted`` (frames), ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, ``built_kernels``
(true where this run built the renderer's kernels, a checkout's first
run, whose ``setup_s`` holds the build), and last the compared numbers
beside their limits (``checks``), which also end standard error.  A cell on N chips runs N ranks, one card each, started
here (``python -m prtbench.cell``) over NCCL.

It exits with another code than 0 and prints no result when there is no
CUDA card or fewer than the cell asks for, when the renderer is not in
the checkout, or when a process of the run loaded JAX or the JAX
package.  Kernel builds and caches stay in ``build/`` inside the
checkout.
"""

from __future__ import annotations

import time

T_LAUNCH = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: a rank's time limit: the first run of a cell in a checkout builds
#: the kernels
RANK_TIMEOUT_S = 1100


def cache_env(root: Path) -> dict:
    """Every build and kernel cache inside the checkout, at fixed paths;
    NCCL kept off /dev/shm."""
    build = root / "build"
    return {"TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "TRITON_CACHE_DIR": str(build / "triton"),
            "PYTORCH_KERNEL_CACHE_PATH": str(build / "torch_kernels"),
            "NCCL_SHM_DISABLE": "1"}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(plan: dict, seed: int, seconds: float, trace: bool,
           device: str = "cuda", t_launch: float = T_LAUNCH) -> list:
    """Every rank's raw record: one rank in this process, more as one
    process each (``python -m prtbench.cell``), all waited for."""
    from prtbench import cell
    world = int(plan["workload"]["chips"])
    if world == 1:
        return [cell.run_rank(plan, seed, seconds, trace, device=device,
                              t_launch=t_launch)]
    init = f"tcp://127.0.0.1:{_free_port()}"
    with tempfile.TemporaryDirectory(prefix="prtbench_") as tmp:
        plan_path = Path(tmp, "plan.json")
        plan_path.write_text(json.dumps(plan))
        outs = [Path(tmp, f"rank{r}.pkl") for r in range(world)]
        # one intra-op thread a rank, as torchrun sets for several
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        procs = [subprocess.Popen(
            [sys.executable, "-m", "prtbench.cell", str(plan_path), str(r),
             str(world), init, str(seed), str(seconds), "1" if trace else "0",
             device, str(outs[r]), repr(t_launch)], cwd=str(ROOT), env=env)
            for r in range(world)]
        deadline = time.time() + RANK_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
                if p.returncode != 0:
                    raise RuntimeError(f"rank exited with {p.returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        raws = []
        for out in outs:
            with open(out, "rb") as f:
                raws.append(pickle.load(f))
    return raws


def end_to_end(raws: list, t_launch: float) -> dict:
    """frame_ms, frame_ms_p95 and setup_s of a run."""
    frames = raws[0]["frames"]
    # each frame's interval on the slowest rank
    per_frame = np.max(np.stack([np.asarray(r["intervals_ms"]) for r in raws]),
                       axis=0)
    return {
        "frame_ms": max(r["window_s"] for r in raws) * 1e3 / frames,
        "frame_ms_p95": float(np.percentile(per_frame, 95)),
        "setup_s": raws[0]["t0_wall"] - t_launch,
    }


def kernel_libraries(root: Path = ROOT) -> set:
    """The renderer's built kernel libraries in the checkout (its
    ``build/kernels/`` cache)."""
    return set(Path(root, "build", "kernels").glob("lib*.so"))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.split("\n")[0].strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def result(plan: dict, raws: list, trace: bool, t_launch: float,
           device: str = "cuda", built: bool = False) -> dict:
    """The run's result line (without printing it); `built`: the run
    built kernels, so its ``setup_s`` is a checkout's first."""
    from prtbench import check, registry
    from prtbench.readings import Readings
    judged = check.judge(check.numbers(raws), plan["check"]["limits"])
    units = {m["name"]: m["unit"] for m in plan["end_to_end"] + plan["per_layer"]}
    metrics = {}
    if device == "cuda":
        if trace:
            readings = Readings(raws)
            for m in plan["per_layer"]:
                v = registry.metric_reader(m["name"], Path(plan["base"]))(readings)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        else:
            e2e = end_to_end(raws, t_launch)
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in plan["end_to_end"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": raws[0]["device_name"], "count": len(raws),
           "memory_peak_bytes": max(r["memory_peak"] for r in raws)}
    out = {"correct": all(v["ok"] for v in judged.values()),
           "attempted": raws[0]["frames"], "failed": 0, "metrics": metrics,
           "device": dev}
    traces = [r["trace"] for r in raws]
    if trace and all(t is not None for t in traces):
        dev["busy_s"] = float(np.mean([t["busy_s"] for t in traces]))
        dev["window_s"] = float(np.mean([t["window_s"] for t in traces]))
        out["breakdown"] = {"device_ops": traces[0]["ops"],
                            "idle_gaps": traces[0]["gaps"]}
    if device == "cuda":
        dev["power_limit"] = power_limit()
    out["built_kernels"] = built
    out["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                     for k, v in judged.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.update(cache_env(ROOT))
    from prtbench import cell, registry
    try:
        plan = registry.plan(ROOT, args.workload)
    except (OSError, KeyError) as e:
        print(f"prtbench: {e}", file=sys.stderr)
        return 2
    import torch
    chips = int(plan["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"prtbench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import parallelraytracing_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"prtbench: the renderer is not in this checkout: {e}",
              file=sys.stderr)
        return 2

    libraries = kernel_libraries()
    raws = launch(plan, args.seed, args.seconds, bool(args.trace))
    built = bool(kernel_libraries() - libraries)
    out = result(plan, raws, bool(args.trace), T_LAUNCH, built=built)
    found = sorted(set(cell.forbidden_modules()).union(
        *(r["forbidden"] for r in raws)))
    if found:
        print(f"prtbench: the run loaded {found}", file=sys.stderr)
        return 4
    if built:
        print("prtbench: this run built the kernels: its setup_s is a "
              "checkout's first", file=sys.stderr)
    for r in raws:
        if r["trace"] and r["trace"]["unattributed"]:
            print(f"prtbench rank {r['rank']}: kernels of no layer "
                  f"{r['trace']['unattributed']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
