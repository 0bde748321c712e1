"""A run on the CPU at a tiny size, with the timed path sound and with it
broken underneath: the check passes the first and fails each fault; and
the control (the reference in bfloat16) fails the cell's limits.  The
card's look is skipped: ``run.launch`` and ``run.result`` are driven
with ``device="cpu"``."""

from __future__ import annotations

import os
import sys
import textwrap

import pytest

from prtbench import control, run
from prtbench.tests.prtbench_fixtures import _few_threads, small_plan  # noqa: F401

SEED = 2**31 + 4242


def _run(plan, seconds=1.0):
    raws = run.launch(plan, SEED, seconds, False, device="cpu")
    assert all(r["forbidden"] == [] for r in raws)
    return run.result(plan, raws, False, run.T_LAUNCH, device="cpu")


def _half(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0.0
    return out


def _altered(out):
    return out.roll(1, dims=1)


#: the one-card cells (the four-card one runs below, over gloo)
ONE_CARD = ["balls_rest_1080p", "icosphere_rest_1080p", "balls_orbit_360p",
            "cornell_nee_rest_1080p", "balls_nee_rest_1080p",
            "instanced_tlas_rest_1080p"]


@pytest.mark.parametrize("workload", ONE_CARD)
def test_sound_run_is_correct(workload):
    out = _run(small_plan(workload))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["metrics"] == {}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("workload", ONE_CARD)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    from parallelraytracing_tpu_torch.engines.base import Renderer
    from parallelraytracing_tpu_torch.engines.fused import FusedRenderer
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        WavefrontFusedRenderer
    plan = small_plan(workload)
    if fault == "state_unchanged":
        monkeypatch.setattr(Renderer, "progressive_render", lambda self: None)
    else:
        wrap = _half if fault == "half_batch" else _altered
        for cls in (FusedRenderer, WavefrontFusedRenderer):
            orig = cls.render_sample_buffer
            monkeypatch.setattr(cls, "render_sample_buffer",
                                lambda self, f, orig=orig: wrap(orig(self, f)))
    out = _run(plan)
    assert not out["correct"], out["checks"]


def _four_ranks(plan, tmp_path, patch=""):
    """The cell over four gloo ranks; `patch` runs in each rank first."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent(patch))
    env = {"PYTHONPATH": os.pathsep.join([str(tmp_path), str(run.ROOT)]
                                         + sys.path[1:2])}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return _run(plan, seconds=2.0)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def test_four_ranks_sound_and_without_the_gather(tmp_path):
    plan = small_plan("balls_4card_rest_1080p")
    out = _four_ranks(plan, tmp_path)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
    out = _four_ranks(plan, tmp_path, """
        from parallelraytracing_tpu_torch.engines.sharded import ShardedRenderer
        ShardedRenderer.gather_film = lambda self: None
        """)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", ONE_CARD + ["balls_4card_rest_1080p"])
def test_control_fails_the_limits(workload):
    plan = small_plan(workload, pixels=256)
    nums = control.control_numbers(plan, SEED, frames=12, displays=3,
                                   device="cpu")
    limits = plan["check"]["limits"]
    assert any(v > limits[k] for k, v in nums.items()), nums
