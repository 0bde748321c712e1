"""The harness finds a cell's parts by name, and a new configuration,
traffic mix, cell and per-layer metric are added by new files alone."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

from prtbench import registry, run
from prtbench.readings import Readings


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_every_cell_resolves():
    bench = registry.benchmark(run.ROOT)
    for w in bench["workloads"]:
        plan = registry.plan(run.ROOT, w["name"])
        assert plan["check"]["limits"].keys() == {
            "frames_gap", "hdr_bad_share", "display_bad_share"}
        for m in plan["per_layer"]:
            assert callable(registry.metric_reader(m["name"]))
    names = {c["name"] for c in bench["configs"]}
    assert {w["config"] for w in bench["workloads"]} == names


def test_new_cell_and_metric_by_new_files_alone(tmp_path):
    root = tmp_path / "checkout"
    base = root / "prtbench"
    shutil.copytree(run.ROOT / "prtbench", base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(run.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(base)

    cfg = json.loads((base / "configs" / "random_balls_large.json").read_text())
    cfg["scene"]["generators"][0]["balls"] = 400
    (base / "configs" / "random_balls_medium.json").write_text(json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "rest_1080p.json").read_text())
    traffic["display_ms"] = 1000
    (base / "traffic" / "rest_slow_display.json").write_text(json.dumps(traffic))
    (base / "checks" / "medium_rest.json").write_text(json.dumps(
        {"limits": {"frames_gap": 0, "hdr_bad_share": 0.5,
                    "display_bad_share": 0.5}}))
    (base / "metrics" / "frames_in_slice.py").write_text(
        "def read(r):\n    return float(sum(x['slice_frames'] for x in r.raws))\n")
    (base / "layers" / "probe.json").write_text(json.dumps(
        {"layer": "probe kernel", "patterns": ["probe_kernel"]}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "random_balls_medium", "source": "x",
                             "file": "prtbench/configs/random_balls_medium.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "medium_rest",
                               "config": "random_balls_medium",
                               "traffic": "rest_slow_display", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "frames_in_slice", "unit": "frames",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "frame_ms",
                               "workloads": ["medium_rest"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    plan = registry.plan(root, "medium_rest", base=base)
    assert plan["config"]["scene"]["generators"][0]["balls"] == 400
    assert plan["traffic"]["display_ms"] == 1000
    assert plan["check"]["limits"]["hdr_bad_share"] == 0.5
    assert [m["name"] for m in plan["per_layer"]] == [
        m["name"] for m in bench["per_layer"]
        if "workloads" not in m or "medium_rest" in m["workloads"]]
    assert "probe kernel" in [m["layer"] for m in plan["layers"]]
    read = registry.metric_reader("frames_in_slice", base)
    raws = [{"trace": None, "slice_frames": 7}]
    assert read(Readings(raws)) == 7.0
    # the old cells still resolve, and no file that was there changed
    assert registry.plan(root, "balls_rest_1080p", base=base)["config"] \
        == registry.plan(run.ROOT, "balls_rest_1080p")["config"]
    after = _digests(base)
    assert {k: after[k] for k in before} == before
