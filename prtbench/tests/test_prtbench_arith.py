"""The harness's arithmetic on synthetic inputs: the profiled slice's
busy time, gaps and layers, the tail over all frames, and the roofline's
floor."""

from __future__ import annotations

import json

import numpy as np
import pytest

from prtbench import registry, roofline, run, tracefile
from prtbench.readings import Readings


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "ts": ts, "dur": dur, "name": name, "cat": cat}
        for name, cat, ts, dur in events]}))
    return str(path)


def test_slice_reduction(tmp_path):
    path = _trace(tmp_path, [
        ("prtbench.frame", "user_annotation", 0, 400),
        ("prtbench.display", "user_annotation", 400, 600),
        ("aten::add", "cpu_op", 100, 100),
        ("cudaLaunchKernel", "cuda_runtime", 10, 5),
        ("cudaLaunchKernel", "cuda_runtime", 300, 5),
        ("cudaLaunchKernel", "cuda_runtime", 2000, 5),      # outside
        ("void trace_kernel<0, false>(PrtScene, TraceArgs)", "kernel", 20, 80),
        ("void at::native::elementwise_kernel<128, 2>(int)", "kernel", 60,
         90),                                               # overlaps
        ("void mystery_kernel()", "kernel", 30, 30),        # no layer's
        ("ncclDevKernel_AllGather_RING_LL", "kernel", 500, 100),
        ("Memcpy DtoH", "gpu_memcpy", 980, 100),            # clipped at 1000
    ])
    red = tracefile.reduce(path, registry.layer_maps())
    assert red["window_s"] == pytest.approx(1000e-6)
    # union: [20, 150) + [500, 600) + [980, 1000)
    assert red["busy_s"] == pytest.approx(250e-6)
    assert red["busy_without"]["collectives"] == pytest.approx(150e-6)
    assert red["launches"] == 2
    assert red["layer_s"]["trace kernel"] == pytest.approx(80e-6)
    assert red["layer_s"]["torch ops"] == pytest.approx(110e-6)
    assert red["layer_s"]["collectives"] == pytest.approx(100e-6)
    assert red["layer_s"]["unattributed"] == pytest.approx(30e-6)
    assert red["unattributed"] == [["void mystery_kernel()",
                                    pytest.approx(30e-6)]]
    # the longest gap [600, 980) starts inside the display span
    assert red["gaps"][0] == ["prtbench.display", pytest.approx(380e-6)]
    # [150, 500) starts inside aten::add, the innermost host event there
    assert red["gaps"][1] == ["aten::add", pytest.approx(350e-6)]


def test_added_layer_map_moves_no_layer(tmp_path):
    path = _trace(tmp_path, [
        ("prtbench.frame", "user_annotation", 0, 1000),
        ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::CUDAFunctor_add<float> >(int)", "kernel", 100, 200),
        ("void at::native::index_elementwise_kernel<128, 4>(int)", "kernel",
         400, 100),
        ("void (anonymous namespace)::trace_kernel<0>(PrtScene)", "kernel",
         600, 300),
    ])
    maps = registry.layer_maps()
    before = tracefile.reduce(path, maps)["layer_s"]
    finer = {"layer": "film add", "patterns": ["CUDAFunctor_add"],
             "file": "film_add"}
    after = tracefile.reduce(path, maps + [finer])["layer_s"]
    assert {k: after[k] for k in before} == before
    assert before["torch ops"] == pytest.approx(300e-6)
    assert after["film add"] == pytest.approx(200e-6)


def test_gaps_and_busy_fill_the_window(tmp_path):
    rng = np.random.default_rng(0)
    evs = [("prtbench.frame", "user_annotation", 0, 10000)]
    for s in rng.uniform(0, 10000, 50):
        evs.append(("k", "kernel", float(s), float(rng.uniform(1, 300))))
    red = tracefile.reduce(_trace(tmp_path, evs), registry.layer_maps(), top=100)
    assert red["busy_s"] + sum(g for _, g in red["gaps"]) == pytest.approx(0.01)


def test_tail_covers_every_frame_and_the_slowest_rank():
    fast = [1.0] * 100
    slow = [1.0] * 94 + [9.0] * 6       # six stalls in a hundred frames
    raws = [{"frames": 100, "window_s": 0.12, "t0_wall": 10.0,
             "intervals_ms": fast},
            {"frames": 100, "window_s": 0.15, "t0_wall": 10.5,
             "intervals_ms": slow}]
    e2e = run.end_to_end(raws, t_launch=2.0)
    assert e2e["frame_ms"] == pytest.approx(1.5)
    assert e2e["frame_ms_p95"] == pytest.approx(9.0)
    assert e2e["setup_s"] == pytest.approx(8.0)
    assert run.end_to_end(raws[:1], 2.0)["frame_ms_p95"] == pytest.approx(1.0)


def test_floor_and_binding_bound():
    counts = {"segments": 300, "sphere": 100, "quad": 50, "triangle": 0,
              "scatter": 120}
    floor = roofline.frame_floor(counts, paths=100, rays_per_frame=1000,
                                 scene_bytes=500, cards=4)
    ops = 10 * (100 * 21 + 50 * 42 + 120 * 52)
    assert floor == {"ops": ops, "bytes": 1000 * 40 + 4 * 500}
    seconds, bound = roofline.floor_seconds(floor)
    assert bound == "bytes"
    assert seconds == pytest.approx(42000 / 3.35e12)
    big = roofline.frame_floor({**counts, "sphere": 10**9}, 1, 1, 0)
    assert roofline.floor_seconds(big)[1] == "operations"


def test_roofline_share_never_passes_100_when_the_kernel_is_at_the_floor():
    counts = {"segments": 10, "sphere": 10, "quad": 0, "triangle": 0,
              "scatter": 10}
    raw = {"counts": counts, "paths": 10, "width": 100, "height": 10,
           "scene_bytes": 0, "slice_frames": 4, "slice_displays": 1,
           "host_s": [], "trace": None}
    floor_s, _ = roofline.floor_seconds(
        roofline.frame_floor(counts, 10, 1000, 0))
    raw["trace"] = {"layer_s": {"trace kernel": 4 * floor_s}, "launches": 4,
                    "busy_s": 1.0, "window_s": 2.0, "busy_without": {}}
    r = Readings([raw])
    assert r.roofline_pct("trace kernel") == pytest.approx(100.0)
    assert r.roofline_pct("segment route") is None
    assert r.idle_pct() == pytest.approx(50.0)
    assert r.gather_ms() is None and r.rank_skew_pct() is None
