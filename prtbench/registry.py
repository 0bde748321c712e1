"""Find a cell's parts by the names ``BENCHMARK.json`` gives them.

Each configuration, traffic mix, cell's limits, per-layer metric and
kernel-to-layer map is a file of its own under the benchmark's folder:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``checks/<workload>.json``, ``metrics/<metric>.py`` (a ``read(readings)``
function) and ``layers/*.json``.  A later cell or metric is added by new
files and new entries in ``BENCHMARK.json``; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from prtbench import check

BASE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def layer_maps(base: Path = BASE) -> list:
    """Every ``layers/*.json`` map ({"layer", "patterns"}), by file name.
    Each map claims every kernel its patterns match, whatever the other
    maps claim, so a map that a later PR adds moves no existing layer."""
    return [{**_json(p), "file": p.stem}
            for p in sorted(Path(base, "layers").glob("*.json"))]


def metric_reader(name: str, base: Path = BASE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = Path(base, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"prtbench_metric_{name}",
                                                  path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def plan(root: Path, workload: str, base: Path = BASE) -> dict:
    """Everything one run of cell `workload` reads: its entry, its
    configuration, traffic, limits, the layer maps, and the metrics it
    reports (end-to-end, and per-layer as {name: entry})."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def applies(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return {
        "workload": entry,
        "config": _json(Path(base, "configs", f"{entry['config']}.json")),
        "traffic": _json(Path(base, "traffic", f"{entry['traffic']}.json")),
        "check": _json(Path(base, "checks", f"{workload}.json")),
        "sample": {"pixels": check.PIXELS, "max_paths": check.MAX_PATHS},
        "layers": layer_maps(base),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
        "base": str(base),
    }
