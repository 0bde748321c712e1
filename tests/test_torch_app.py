"""The port's app layer against the JAX package's on the CPU: the orbit
camera, ``Film.resize``, ``RenderConfig.replace``, the frame timer, the
profiler's trace, and the interactive viewer (``ViewerState`` and its
HTTP routes).

Tolerances:
- the camera: bit-equal vectors, view-projection matrix and host rays
  after the same calls (both packages compute the same float64 numpy
  steps), with and without smoothing;
- ``FrameTimer`` under one patched clock: the same histories and means
  exactly; the port's CPU summary is the JAX summary plus one line that
  says the device time was not recorded;
- ``ViewerState`` with the megakernel engine on MATERIAL_TEST at 16x8,
  depth 2, preview scale 1, display interval 0: after the same control
  messages and steps, the same camera bit for bit and the films bit-equal
  (the port's megakernel renders the JAX one's bits on MATERIAL_TEST,
  tests/test_torch_megakernel.py); the engine switch clears the film in
  both; unknown engines and malformed messages change nothing; the
  denoised display is (H, W, 4) uint8;
- the HTTP routes on 127.0.0.1, port 0: the page, ``/stats`` with the
  JAX viewer's keys, ``/frame.png`` decoding to the film's display, a
  ``/control`` message applied, a malformed one ignored, 404 elsewhere.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core.camera import Camera as JCamera  # noqa: E402
from parallelraytracing_tpu.utils import timing as jtiming  # noqa: E402
from parallelraytracing_tpu.viewer import app as japp  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch.core.camera import Camera as TCamera  # noqa: E402
from parallelraytracing_tpu_torch.utils import png  # noqa: E402
from parallelraytracing_tpu_torch.utils import profiling as tprof  # noqa: E402
from parallelraytracing_tpu_torch.utils import timing as ttiming  # noqa: E402
from parallelraytracing_tpu_torch.viewer import app as tapp  # noqa: E402

# the JAX viewer's engines dispatch synchronously (tests/test_torch_reset.py)
jax.config.update("jax_cpu_enable_async_dispatch", False)

W, H = 16, 8
VECTORS = ("position", "front", "right", "up")

#: control messages and the frame steps after them (dt in seconds)
SCRIPT = [({"kind": "rotate", "dx": 6.0, "dy": -3.0}, 0.016),
          ({"kind": "translate", "dx": 2.0, "dy": 1.0}, 0.02),
          ({"kind": "zoom", "dy": -40.0}, 0.016),
          (None, 0.016),
          ({"kind": "rotate", "dx": -2.5, "dy": 1.5}, 0.05),
          (None, 0.016), (None, 0.016)]


# --------------------------------------------------------------- camera

def _cameras():
    eye = np.array([5.0, 5.0, 8.0])
    return (JCamera(eye, -eye, 64.0, 48.0, 100.0),
            TCamera(eye, -eye, 64.0, 48.0, 100.0))


def _same_camera(a, b):
    for f in VECTORS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("smoothing", [False, True])
def test_camera_controls_bit_equal(smoothing):
    jc, tc = _cameras()
    for c in (jc, tc):
        c.enable_smoothing = smoothing
    calls = [("rotate", (12.0, -7.5)), ("update", (0.016,)),
             ("translate", (0.3, -0.2)), ("zoom", (0.5,)),
             ("update", (0.033,)), ("update", (0.1,)),
             ("rotate", (-3.0, 40.0)), ("translate", (1e-5, 0.0)),
             ("update", (0.016,)), ("update", (0.016,))]
    for name, args in calls:
        rj = getattr(jc, name)(*args)
        rt = getattr(tc, name)(*args)
        assert rj == rt, name
        _same_camera(jc, tc)
    np.testing.assert_array_equal(jc.get_view_projection(),
                                  tc.get_view_projection())
    np.testing.assert_array_equal(jc.ray_params(), tc.ray_params())
    for px, py in ((0.0, 0.0), (31.5, 20.25), (63.9, 47.9)):
        for a, b in zip(jc.get_camera_ray(px, py), tc.get_camera_ray(px, py)):
            np.testing.assert_array_equal(a, b)


def test_camera_update_at_rest_does_not_move():
    jc, tc = _cameras()
    assert not jc.update(0.016) and not tc.update(0.016)
    tc.translate(5e-5, 0.0)  # under the 1e-4 velocity threshold
    assert not tc.update(0.016)
    _same_camera(jc, tc)


# ------------------------------------------------------ film and config

def test_film_resize_and_config_replace():
    film = T.Film(8, 6, "cpu")
    film.set_layout((np.arange(48)[::-1].copy(), 48))
    film.add_sample_buffer(torch.ones(48, 3))
    film.resize(5, 4)
    assert (film.width, film.height, film.sample_count) == (5, 4, 0)
    assert film.accum.shape == (4, 5, 3) and film.weights.shape == (4, 5)
    assert film.device == torch.device("cpu") and film._layout_inv is None
    assert float(film.accum.abs().sum()) == 0.0
    jfilm = J.Film(8, 6)
    jfilm.resize(5, 4)
    np.testing.assert_array_equal(np.asarray(jfilm.accum), film.accum.numpy())
    np.testing.assert_array_equal(np.asarray(jfilm.weights),
                                  film.weights.numpy())

    cfg = T.RenderConfig(width=64, height=48, nee=True)
    new = cfg.replace(width=21, height=7)
    assert (new.width, new.height, new.nee, cfg.width) == (21, 7, True, 64)
    jnew = J.RenderConfig(width=64, height=48, nee=True).replace(width=21,
                                                                 height=7)
    for f in ("width", "height", "nee", "max_depth", "seed", "t_min"):
        assert getattr(jnew, f) == getattr(new, f), f


# ----------------------------------------------------- timer and meter

class _Clock:
    """A perf_counter that advances by a fixed sequence of steps."""

    def __init__(self):
        self.t = 100.0
        self.steps = [0.004, 0.0125, 0.001, 0.25, 0.0333, 0.002]
        self.i = 0

    def __call__(self):
        self.t += self.steps[self.i % len(self.steps)]
        self.i += 1
        return self.t


def test_frame_timer_matches_jax(monkeypatch):
    timers = []
    for mod in (jtiming, ttiming):
        monkeypatch.setattr(time, "perf_counter", _Clock())
        timer = mod.FrameTimer() if mod is jtiming else mod.FrameTimer("cpu")
        for i in range(105):  # past the 100-entry ring
            for name in ("render", "tonemap") if i % 3 else ("render",):
                with timer.stage(name):
                    pass
        timers.append(timer)
    jt, tt = timers
    for name in ("render", "tonemap", "absent"):
        assert jt.history(name) == tt.history(name)
        assert jt.last(name) == tt.last(name) and jt.mean(name) == tt.mean(name)
    assert len(tt.history("render")) == ttiming.HISTORY == 100
    assert tt.device_history("render") is None and tt.device_mean("render") is None
    assert tt.summary() == jt.summary() + "\n(host time only: no CUDA device)"


def test_profiler_trace_has_annotation(tmp_path):
    with tprof.trace(str(tmp_path / "prof")) as path:
        with tprof.annotate("frame_stage"):
            torch.ones(64, 64).sum()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == "frame_stage"]
    assert len(spans) == 1 and spans[0]["dur"] > 0
    busy = tprof.device_busy(path, ["frame_stage"])
    assert busy["busy"] == 0.0 and busy["idle_share"] == 1.0
    assert busy["kernels"] == 0 and busy["window"] > 0
    assert busy["gaps"][0]["length"] == pytest.approx(busy["window"])


# --------------------------------------------------------------- viewer

def _viewers(engine="megakernel"):
    cfg = dict(width=W, height=H, max_depth=2, seed=1)
    eye = np.array([5.0, 5.0, 8.0])
    js = japp.ViewerState(J.Scene(J.ScenePreset.MATERIAL_TEST),
                          JCamera(eye, -eye, float(W), float(H), 100.0),
                          J.RenderConfig(**cfg), engine, preview_scale=1,
                          display_interval_ms=0.0)
    ts = tapp.ViewerState(T.Scene(T.ScenePreset.MATERIAL_TEST),
                          TCamera(eye, -eye, float(W), float(H), 100.0),
                          T.RenderConfig(**cfg), engine, "cpu",
                          preview_scale=1, display_interval_ms=0.0)
    return js, ts


def _close(js, ts):
    js.stop = True
    ts.close()


def _film(state):
    return np.asarray(state.film.hdr_average())


def test_viewer_steps_match_jax():
    js, ts = _viewers()
    try:
        for msg, dt in SCRIPT:
            for s in (js, ts):
                if msg is not None:
                    s.control(dict(msg))
                s._step(dt)
            _same_camera(js.camera, ts.camera)
            assert js.film.sample_count == ts.film.sample_count
            np.testing.assert_array_equal(_film(js), _film(ts))
        assert ts.frame == js.frame == len(SCRIPT)
        # at rest after the last move: the film refined since the move
        assert ts.film.sample_count == 3
        assert set(ts.history) == set(js.history)
        assert all(len(v) == len(SCRIPT) for v in ts.history.values())
        assert ts.engines == T.available_engines()
    finally:
        _close(js, ts)


def test_viewer_engine_switch_and_bad_messages():
    js, ts = _viewers()
    try:
        for s in (js, ts):
            s._step(0.016)
            s._step(0.016)
            assert s.film.sample_count == 2
            for bad in ({"kind": "engine", "name": "no_such_engine"},
                        {"kind": "warp", "dx": 3}, {}, {"kind": "engine"}):
                s.control(bad)
            assert s.switch_to is None and not s.denoise
            s._step(0.016)
            assert s.film.sample_count == 3
            s.control({"kind": "engine", "name": "bvh"})
            s._step(0.016)
            assert s.engine_name == "bvh" and s.film.sample_count == 1
            assert set(s.renderer_cache) == {"megakernel", "bvh"}
        # bvh and the megakernel draw the same streams: back to the
        # megakernel from the cache, the films stay equal across packages
        for s in (js, ts):
            s.control({"kind": "engine", "name": "megakernel"})
            s._step(0.016)
            s._step(0.016)
        np.testing.assert_array_equal(_film(js), _film(ts))
        assert ts.film.sample_count == 2
    finally:
        _close(js, ts)


def test_viewer_denoised_display_and_preview():
    _, ts = _viewers()
    try:
        ts.control({"kind": "denoise", "on": True})
        ts._step(0.016)
        assert ts.denoise
        buf = ts._encode_buf
        assert buf.shape == (H, W, 4) and buf.dtype == np.uint8
        assert (buf[..., 3] == 255).all()
    finally:
        ts.close()
    eye = np.array([5.0, 5.0, 8.0])
    state = tapp.ViewerState(T.Scene(T.ScenePreset.MATERIAL_TEST),
                             TCamera(eye, -eye, 48.0, 24.0, 100.0),
                             T.RenderConfig(width=48, height=24, max_depth=2),
                             "megakernel", "cpu", preview_scale=3,
                             display_interval_ms=0.0)
    try:
        assert (state.preview_film.width, state.preview_film.height) == (16, 8)
        state._step(0.016)
        state.control({"kind": "rotate", "dx": 4.0})
        state._step(0.016)
        assert state.previewing and state.preview_film.sample_count == 1
        assert state._encode_buf.shape == (8, 16, 4)
        state._step(0.016)  # at rest: back to the full-size film
        assert not state.previewing and state.film.sample_count == 1
    finally:
        state.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.read()


def _serve(state):
    server = ThreadingHTTPServer(("127.0.0.1", 0), state_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def state_handler(state):
    mod = japp if isinstance(state, japp.ViewerState) else tapp
    return mod.make_handler(state)


def test_http_routes_round_trip():
    js, ts = _viewers()
    try:
        stats = {}
        for s in (js, ts):
            s._step(0.016)
            deadline = time.time() + 30
            while not s.png_cache and time.time() < deadline:
                time.sleep(0.01)
            server, thread, base = _serve(s)
            try:
                code, page = _get(base + "/")
                assert code == 200 and f'width="{W}"' in page.decode()
                code, body = _get(base + "/stats")
                stats[s is ts] = json.loads(body)
                code, body = _get(base + "/frame.png?f=1")
                np.testing.assert_array_equal(png.decode_png(body),
                                              np.asarray(s.film.display_numpy()))
                assert _post(base + "/control", json.dumps(
                    {"kind": "rotate", "dx": 8.0, "dy": 0.0}).encode())[0] == 200
                assert np.abs(s.camera._rotation_velocity).sum() > 0
                assert _post(base + "/control", b"{not json")[0] == 200
                if s is ts:  # the JAX handler does not guard a non-object
                    assert _post(base + "/control", b"[1, 2]")[0] == 200
                with pytest.raises(urllib.error.HTTPError) as e:
                    _get(base + "/nope")
                assert e.value.code == 404
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=10)
        jst, tst = stats[False], stats[True]
        assert set(jst) == set(tst)
        assert set(jst["history"]) == set(tst["history"])
        for k in ("frame", "samples", "preview", "engine"):
            assert jst[k] == tst[k], k
        assert tst["engines"] == T.available_engines()
    finally:
        _close(js, ts)


def test_device_busy_union_and_gaps(tmp_path):
    """device_busy on a hand-written trace: overlapping kernels count once,
    copies count, the window is the named spans', gaps are found longest
    first with the span that holds their start."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "seeds", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "raygen", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "user_annotation", "name": "frame", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 12, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 18, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 35, "dur": 3},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 39, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 11, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 17, "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 5, "dur": 1}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    busy = tprof.device_busy(str(path), ["seeds", "raygen"])
    assert busy["window"] == 40.0          # the two named spans: 0..40
    assert busy["busy"] == 16.0 + 3.0 + 1.0  # 12..28, 35..38, 39..40
    assert busy["idle_share"] == pytest.approx(0.5)
    assert busy["kernels"] == 3 and busy["launches"] == 2
    assert [(g["start"], g["length"], g["stage"]) for g in busy["gaps"]] == [
        (0.0, 12.0, "seeds"), (28.0, 7.0, "raygen"), (38.0, 1.0, "raygen")]
    whole = tprof.device_busy(str(path))
    assert whole["window"] == 100.0 and whole["busy"] == 16.0 + 3.0 + 50.0
