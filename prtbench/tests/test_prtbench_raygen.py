"""The raygen layer's map claims the raygen kernel's profiler name, and
no other map does; its reader gives the kernel's ms a frame, and nothing
on a slice without the kernel."""

from __future__ import annotations

import json

import pytest

from prtbench import registry, tracefile
from prtbench.readings import Readings

#: the kernel's name as torch.profiler records it on the card
RAYGEN = "(anonymous namespace)::raygen_kernel((anonymous namespace)::RaygenArgs)"


def test_the_map_claims_the_raygen_kernel():
    assert tracefile.classify(RAYGEN, registry.layer_maps()) == ["raygen"]
    for other in ("void at::native::vectorized_elementwise_kernel<4>(int)",
                  "void (anonymous namespace)::trace_kernel<0, false, false, "
                  "false, false>(PrtScene, (anonymous namespace)::TraceArgs)"):
        assert "raygen" not in tracefile.classify(other,
                                                  registry.layer_maps())


@pytest.mark.parametrize("with_kernel", [True, False])
def test_raygen_kernel_ms_reads_the_layer(tmp_path, with_kernel):
    events = [("prtbench.frame", "user_annotation", 0, 1000),
              ("void at::native::elementwise_kernel<128, 2>(int)", "kernel",
               100, 50)]
    if with_kernel:
        events.append((RAYGEN, "kernel", 20, 30))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "ts": ts, "dur": dur, "name": name, "cat": cat}
        for name, cat, ts, dur in events]}))
    red = tracefile.reduce(str(path), registry.layer_maps())
    read = registry.metric_reader("raygen_kernel_ms")
    got = read(Readings([{"trace": red, "slice_frames": 2}]))
    if with_kernel:
        assert got == pytest.approx(0.015)
        assert red["layer_s"]["torch ops"] == pytest.approx(50e-6)
    else:
        assert got is None
