"""The stream route's layer map claims the segment kernel's kTriStream
instantiations by their profiler name, and no other kernel; its two
readers give that kernel's ms a frame and its share of the frame's
roofline, and nothing on a slice without it."""

from __future__ import annotations

import json

import pytest

from prtbench import registry, roofline, tracefile
from prtbench.readings import Readings

#: the kTriStream segment kernel's name as torch.profiler records it on
#: the card (icosphere_l7_540p's traced run, NVIDIA H100 80GB HBM3)
STREAM = ("void (anonymous namespace)::segment_kernel<2, false, false, "
          "false, false>(PrtScene, (anonymous namespace)::SegmentArgs)")
#: the dense triangle layout's and the sphere scene's instantiations
DENSE = ("void (anonymous namespace)::segment_kernel<1, false, false, "
         "false, false>(PrtScene, (anonymous namespace)::SegmentArgs)")
TRACE = ("void (anonymous namespace)::trace_kernel<0, false, false, false, "
         "false>(PrtScene, (anonymous namespace)::TraceArgs)")
TRACE_STREAM = ("void (anonymous namespace)::trace_kernel<2, false, false, "
                "false, false>(PrtScene, (anonymous namespace)::TraceArgs)")


def test_the_map_claims_only_the_stream_instantiations():
    maps = registry.layer_maps()
    assert "stream route" in tracefile.classify(STREAM, maps)
    for kind in ("true", "false"):  # with NEE too
        assert "stream route" in tracefile.classify(
            STREAM.replace("<2, false", f"<2, {kind}"), maps)
    for other in (DENSE, TRACE, TRACE_STREAM,
                  "void at::native::vectorized_elementwise_kernel<4>(int)"):
        assert "stream route" not in tracefile.classify(other, maps)
    # the segment route's map still claims every instantiation
    assert "segment route" in tracefile.classify(STREAM, maps)


def _raws(tmp_path, with_kernel: bool) -> list:
    events = [("prtbench.frame", "user_annotation", 0, 1000),
              (DENSE if not with_kernel else STREAM, "kernel", 100, 400)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "ts": ts, "dur": dur, "name": name, "cat": cat}
        for name, cat, ts, dur in events]}))
    red = tracefile.reduce(str(path), registry.layer_maps())
    counts = {"segments": 300, "sphere": 10, "quad": 100, "triangle": 150,
              "scatter": 200, "shadow": 0}
    return [{"trace": red, "slice_frames": 4, "counts": counts,
             "paths": 100, "width": 960, "height": 540,
             "scene_bytes": 24_000_000}]


@pytest.mark.parametrize("with_kernel", [True, False])
def test_the_readers_read_the_layer(tmp_path, with_kernel):
    raws = _raws(tmp_path, with_kernel)
    ms = registry.metric_reader("stream_segment_ms")(Readings(raws))
    pct = registry.metric_reader("stream_roofline")(Readings(raws))
    if not with_kernel:
        assert ms is None and pct is None
        return
    assert ms == pytest.approx(0.1)  # 400 us over 4 frames
    r0 = raws[0]
    floor = roofline.frame_floor(r0["counts"], r0["paths"], 960 * 540,
                                 r0["scene_bytes"])
    seconds, bound = roofline.floor_seconds(floor)
    assert bound == "bytes"
    assert pct == pytest.approx(100.0 * seconds / 1e-4)
    assert 0.0 < pct <= 100.0


def test_the_readers_read_nothing_without_a_slice():
    raws = [{"trace": None, "slice_frames": 0}]
    for name in ("stream_segment_ms", "stream_roofline"):
        assert registry.metric_reader(name)(Readings(raws)) is None
