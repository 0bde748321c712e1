"""The program's spans (``utils/profiling.annotate``) on the CPU: off,
recorded into a ``FrameTimer`` (``record_into``) and under the profiler.

- with nothing listening a span is one shared null context;
- the films of ``fused``, ``wavefront_fused`` and ``sharded`` (1x1) are
  bit-equal with the spans off, recorded and profiled: a span times the
  work and changes none of it;
- a recorder counts each stage of a frame as often as the frame runs it
  (``wavefront_fused``'s segments and re-sorts by its schedule, the
  sharded engine's two seed spans, one ``prt.seed_block`` for frames of
  one seed block), the camera move's spans, and the
  children's host time sums to no more than ``prt.frame``'s;
- the profiler's Chrome trace holds the stages inside ``prt.frame``, and
  ``device_busy`` gives each span its idle time and the device time it
  launched (a hand-written trace with correlation ids and nested spans);
- ``FrameTimer.take()`` keeps every call past the 100-entry ring and
  starts again from zero;
- the CLI's ``--stats`` prints a row for each span of the frame.
"""

import json

import numpy as np
import pytest
import torch

from torch_meshes import make_mesh, write_ply  # one thread a worker

import parallelraytracing_tpu_torch as T
from parallelraytracing_tpu_torch import cli
from parallelraytracing_tpu_torch.core.mesh import subdivide
from parallelraytracing_tpu_torch.core.scene import ply_showcase_scene
from parallelraytracing_tpu_torch.utils import profiling
from parallelraytracing_tpu_torch.utils.timing import HISTORY, FrameTimer

W, H, DEPTH, FRAMES = 16, 12, 3, 3
STAGES = ("prt.seeds", "prt.raygen", "prt.trace", "prt.film_add")


@pytest.fixture(autouse=True)
def detached():
    """No recorder outlives a test."""
    profiling.record_into(None)
    yield
    profiling.record_into(None)


def _renderer(engine, scene=None, depth=DEPTH, eye=(5.0, 5.0, 8.0),
              look=(0.0, 0.0, 0.0)):
    scene = scene or T.Scene(T.ScenePreset.RANDOM_BALLS_LARGE)
    eye, look = np.asarray(eye), np.asarray(look)
    cfg = T.RenderConfig(width=W, height=H, max_depth=depth, seed=5)
    film = T.Film(W, H, "cpu")
    r = T.create_renderer(engine, "cpu")
    r.init(film, scene, T.Camera(eye, look - eye, float(W), float(H), 100.0),
           cfg)
    return r, film


def _frames(r, n=FRAMES):
    for _ in range(n):
        r.progressive_render()


def _heavy_scene(tmp_path):
    """The showcase around a 1280-triangle icosphere: above TRI_HEAVY, so
    wavefront_fused runs its growing schedule."""
    ply = write_ply(tmp_path / "ico3.ply", subdivide(make_mesh("ico2"), 1))
    return ply_showcase_scene(ply)


def test_annotate_with_nothing_listening_is_the_shared_null_context():
    a, b = profiling.annotate("prt.frame"), profiling.annotate("prt.seeds")
    assert a is b is profiling._NULL
    with a:
        with b:  # reentrant: the spans nest
            pass
    profiling.record_into(FrameTimer(None))
    assert profiling.annotate("prt.frame") is not profiling._NULL
    profiling.record_into(None)
    assert profiling.annotate("prt.frame") is profiling._NULL


@pytest.mark.parametrize("engine", ["fused", "wavefront_fused", "sharded"])
def test_films_bit_equal_off_recorded_and_profiled(tmp_path, engine):
    films = []
    for mode in ("off", "recorded", "profiled"):
        r, film = _renderer(engine)
        timer = FrameTimer(None)
        if mode == "recorded":
            profiling.record_into(timer)
        if mode == "profiled":
            with profiling.trace(str(tmp_path / engine)):
                _frames(r)
        else:
            _frames(r)
        profiling.record_into(None)
        assert (timer.totals() != {}) == (mode == "recorded")
        films.append((film.accum.clone(), film.weights.clone()))
    for acc, w in films[1:]:
        assert torch.equal(acc, films[0][0]) and torch.equal(w, films[0][1])


def test_recorder_counts_each_stage_of_a_fused_frame():
    r, _ = _renderer("fused")
    timer = FrameTimer(None)
    profiling.record_into(timer)
    _frames(r)
    totals = timer.take()
    assert set(totals) == {"prt.frame", "prt.seed_block", *STAGES}
    # the frames' seeds come from one block, filled inside the first's
    assert totals.pop("prt.seed_block")[1] == 1
    assert all(calls == FRAMES for _, calls in totals.values())
    children = sum(totals[name][0] for name in STAGES)
    assert 0.0 < children <= totals["prt.frame"][0]


def test_recorder_counts_segments_and_resorts_by_the_schedule(tmp_path):
    scene, eye, look = _heavy_scene(tmp_path)
    r, _ = _renderer("wavefront_fused", scene, depth=12, eye=eye, look=look)
    lens = r.segment_lengths()
    assert lens == [2, 4, 6]  # the growing schedule of a 12-bounce frame
    timer = FrameTimer(None)
    profiling.record_into(timer)
    _frames(r, 2)
    calls = {name: n for name, (_, n) in timer.totals().items()}
    assert calls == {"prt.frame": 2, "prt.seeds": 2, "prt.seed_block": 1,
                     "prt.raygen": 2, "prt.segment": 2 * len(lens),
                     "prt.resort": 2 * (len(lens) - 1), "prt.film_add": 2}


def test_recorder_counts_the_sharded_seeds_and_the_camera_move():
    r, film = _renderer("sharded")
    timer = FrameTimer(None)
    profiling.record_into(timer)
    for k in range(2):  # the viewer's move: camera, film clear, frame
        eye = np.array([5.0 + k, 5.0, 8.0])
        r.set_camera(T.Camera(eye, -eye, float(W), float(H), 100.0))
        film.clear()
        r.reset_progressive()
        r.progressive_render()
    calls = {name: n for name, (_, n) in timer.totals().items()}
    # the sample's seeds in the engine (one block: every frame is frame
    # 0), the frame's seeds in the mesh's frame
    assert calls == {"prt.set_camera": 2, "prt.film_clear": 2, "prt.frame": 2,
                     "prt.seeds": 4, "prt.seed_block": 1, "prt.raygen": 2,
                     "prt.trace": 2, "prt.film_add": 2}


def test_chrome_trace_holds_the_stages_inside_the_frame(tmp_path):
    r, film = _renderer("fused")
    timer = FrameTimer(None)
    profiling.record_into(timer)  # the recorder and the profiler at once
    with profiling.trace(str(tmp_path / "prof")) as path:
        _frames(r)
        film.display_numpy()
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith("prt.")]
    frames = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e["name"] == "prt.frame"]
    assert len(frames) == FRAMES
    for e in events:
        if e["name"] in STAGES:
            assert any(s <= e["ts"] and e["ts"] + e["dur"] <= t
                       for s, t in frames), e
    spans = profiling.device_busy(path)["spans"]
    for name in ("prt.frame", *STAGES):
        assert spans[name]["calls"] == FRAMES
        assert spans[name]["calls"] == timer.totals()[name][1]
    assert spans["prt.display"]["calls"] == 1
    # no device on the CPU: every span's time is idle time, none launched
    assert spans["prt.frame"]["idle"] == pytest.approx(
        spans["prt.frame"]["host"])
    assert all(s["device"] == 0.0 for s in spans.values())


def test_span_times_idle_and_launched_device_time(tmp_path):
    """Nested spans: the frame holds every idle microsecond inside it, the
    seeds and the raygen theirs; a kernel counts for the innermost span
    that launched it, a kernel launched outside every span for none."""
    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    ev = [x("user_annotation", "prt.frame", 0, 100),
          x("user_annotation", "prt.seeds", 0, 10),
          x("user_annotation", "prt.raygen", 10, 20),
          x("user_annotation", "prt.frame", 110, 40),
          x("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),   # raygen
          x("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=2),   # frame
          x("cuda_runtime", "cudaMemcpyAsync", 105, 1, corr=3),   # outside
          x("cuda_runtime", "cudaLaunchKernel", 120, 1, corr=4),  # frame 2
          x("kernel", "raygen_k", 15, 10, corr=1),
          x("kernel", "trace_k", 42, 48, corr=2),
          x("gpu_memcpy", "copy", 106, 4, corr=3),
          x("kernel", "trace_k", 125, 20, corr=4)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    busy = profiling.device_busy(str(path), ["prt.frame", "prt.seeds",
                                             "prt.raygen"])
    assert busy["window"] == 150.0 and busy["busy"] == 10 + 48 + 4 + 20
    spans = busy["spans"]
    # idle: 0..15, 25..42, 90..106, 110..125, 145..150
    assert spans["prt.frame"] == {"calls": 2, "host": 140.0,
                                  "idle": 15 + 17 + 10 + 15 + 5,
                                  "device": 48.0 + 20.0}
    assert spans["prt.seeds"] == {"calls": 1, "host": 10.0, "idle": 10.0,
                                  "device": 0.0}
    assert spans["prt.raygen"] == {"calls": 1, "host": 20.0,
                                   "idle": 5.0 + 5.0, "device": 10.0}
    assert spans["prt.frame"]["idle"] <= busy["window"] - busy["busy"]


def test_frame_timer_take_keeps_every_call_past_the_ring(monkeypatch):
    import time
    clock = iter(range(10_000))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    timer = FrameTimer(None)
    n = 2 * HISTORY + 50
    for _ in range(n):
        with timer.stage("prt.seeds"):
            pass
    assert len(timer.history("prt.seeds")) == HISTORY
    assert timer.totals() == {"prt.seeds": (float(n), n)}  # 1 s a call
    assert timer.take() == {"prt.seeds": (float(n), n)}
    assert timer.totals() == {} and timer.take() == {}
    assert len(timer.history("prt.seeds")) == HISTORY  # the rings stay
    with timer.stage("prt.seeds"):
        pass
    assert timer.totals() == {"prt.seeds": (1.0, 1)}


def test_cli_stats_prints_a_row_for_each_span(tmp_path, capsys):
    out = tmp_path / "f.png"
    rc = cli.main(["--device", "cpu", "--width", str(W), "--height", str(H),
                   "--depth", "2", "--frames", "2", "--stats", "--out",
                   str(out)])
    assert rc == 0 and out.is_file()
    printed = capsys.readouterr().out.splitlines()
    rows = {line.split()[0]: line for line in printed
            if line.startswith(("prt.", "render", "tonemap"))}
    for name in ("render", "tonemap", "prt.frame", *STAGES, "prt.display"):
        assert name in rows, (name, printed)
    assert rows["prt.frame"].split()[-1] == "(2)"
    assert "(host time only: no CUDA device)" in printed
    assert profiling._recorder is None
