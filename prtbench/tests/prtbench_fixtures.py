"""Shared helpers and fixtures of the benchmark's own tests, run from the
root of the checkout: ``python -m pytest prtbench/tests -q``.  A test
module imports the fixtures it uses."""

from __future__ import annotations

import copy

import pytest
import torch

from prtbench import registry, run


def small_plan(workload: str, pixels: int = 64, level: int = 2) -> dict:
    """`workload`'s plan at a size the CPU renders in well under a second
    a frame: 48x27 (96x54 before a preview's scale), depth 4, the mesh a
    level-`level` icosphere, displays every 100 ms."""
    plan = copy.deepcopy(registry.plan(run.ROOT, workload))
    scale = int(plan["traffic"].get("scale", 1))
    plan["config"]["render"].update(width=48 * scale, height=27 * scale,
                                    max_depth=4)
    for o in plan["config"]["scene"].get("objects", []):
        if o["kind"] == "mesh":
            o["mesh"] = {"icosphere": level}
    plan["sample"] = {"pixels": pixels, "max_paths": 50 * pixels}
    plan["traffic"]["display_ms"] = 100
    return plan


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    """Skip unless a CUDA card is here (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
