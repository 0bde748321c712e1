"""On the card: a short run of each one-card cell through the command the
driver runs, and the control at the cell's own size.  Skipped without a
CUDA card (``card`` decides when the test runs)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from prtbench import control, registry, run
from prtbench.tests.prtbench_fixtures import card  # noqa: F401

ONE_CARD = ["balls_rest_1080p", "icosphere_rest_1080p", "balls_orbit_360p",
            "cornell_nee_rest_1080p", "balls_nee_rest_1080p",
            "instanced_tlas_rest_1080p"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CARD)
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_is_correct(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "-m", "prtbench.run", "--workload", workload,
         "--seed", str(2**31 + 99), "--seconds", "3", "--trace", str(trace)],
        cwd=str(run.ROOT), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    plan = registry.plan(run.ROOT, workload)
    names = [m["name"] for m in (plan["per_layer"] if trace
                                 else plan["end_to_end"])]
    assert set(line["metrics"]) <= set(names)
    if not trace:
        assert set(line["metrics"]) == set(names)
    assert list(line)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CARD)
def test_control_fails_at_the_cells_size(card, workload):
    plan = registry.plan(run.ROOT, workload)
    limits = plan["check"]["limits"]
    for seed in (11, 12, 13):
        nums = control.control_numbers(plan, seed, frames=400, displays=8)
        assert any(v > limits[k] for k, v in nums.items()), nums
