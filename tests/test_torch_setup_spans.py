"""The set-up's spans and the stream tables' counters on the CPU.

- ``prt.build_tables`` (engines/tables.build_scene_tables) and, on the
  stream route, ``prt.pack_stream`` inside it (ops/pack.pack_scene_tables:
  the chunk-aligned top tree and the chunks' mini-trees) fire once each
  at a renderer's set-up, in that order, and never in a frame;
- on the dense route only ``prt.build_tables`` fires;
- under the profiler the Chrome trace holds ``prt.pack_stream`` inside
  ``prt.build_tables``;
- with nothing listening both are the shared null context;
- the CLI's ``--stats`` prints both spans' seconds and the stream tables'
  counters, which equal the tables' shapes.

The stream scene is tests/test_torch_stream.py's (``stream_scene`` around
the level-2 icosahedron, 320 triangles) at threshold 64 and chunks of 32
slots, the module constants monkeypatched as there."""

import json

import numpy as np
import pytest

from torch_meshes import make_mesh, stream_scene, write_ply  # one thread a worker

import parallelraytracing_tpu_torch as T
from parallelraytracing_tpu_torch import cli
from parallelraytracing_tpu_torch.engines.tables import (build_scene_tables,
                                                         stream_counters)
from parallelraytracing_tpu_torch.ops import pack
from parallelraytracing_tpu_torch.utils import profiling
from parallelraytracing_tpu_torch.utils.timing import FrameTimer

W, H, DEPTH = 16, 12, 3
SETUP = ("prt.build_tables", "prt.pack_stream")
EYE, LOOK = np.array([0.0, 4.0, 10.0]), np.array([0.0, 1.5, 0.0])


class OrderedTimer(FrameTimer):
    """A recorder that also keeps the order in which stages start."""

    def __init__(self):
        super().__init__(None)
        self.started = []

    def stage(self, name):
        self.started.append(name)
        return super().stage(name)


@pytest.fixture(autouse=True)
def detached():
    profiling.record_into(None)
    yield
    profiling.record_into(None)


@pytest.fixture
def streamed(monkeypatch):
    monkeypatch.setattr(pack, "STREAM_THRESHOLD", 64)
    monkeypatch.setattr(pack, "STREAM_CHUNK", 32)


def _renderer(scene, engine="wavefront_fused"):
    cfg = T.RenderConfig(width=W, height=H, max_depth=DEPTH, seed=9)
    film = T.Film(W, H, "cpu")
    r = T.create_renderer(engine, "cpu")
    r.init(film, scene, T.Camera(EYE, LOOK - EYE, float(W), float(H), 100.0),
           cfg)
    return r


@pytest.mark.parametrize("engine", ["wavefront_fused", "fused"])
def test_setup_spans_fire_once_in_order_and_never_in_a_frame(streamed,
                                                             engine):
    timer = OrderedTimer()
    profiling.record_into(timer)
    r = _renderer(stream_scene(T.Scene, make_mesh("ico2")), engine)
    assert r._tables.stream is not None
    assert [n for n in timer.started if n in SETUP] == list(SETUP)
    calls = {name: n for name, (_, n) in timer.take().items()}
    assert calls["prt.build_tables"] == calls["prt.pack_stream"] == 1
    for _ in range(2):
        r.progressive_render()
    calls = {name: n for name, (_, n) in timer.totals().items()}
    assert calls["prt.frame"] == 2
    assert not set(SETUP) & set(calls)


def test_dense_route_fires_only_the_table_build():
    timer = OrderedTimer()
    profiling.record_into(timer)
    r = _renderer(stream_scene(T.Scene, make_mesh("ico2")))
    assert r._tables.stream is None
    assert [n for n in timer.started if n in SETUP] == ["prt.build_tables"]


def test_profiler_trace_holds_the_pack_inside_the_build(streamed, tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as path:
        _renderer(stream_scene(T.Scene, make_mesh("ico2")))
    with open(path) as f:
        spans = {e["name"]: (e["ts"], e["ts"] + e["dur"])
                 for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation" and e["name"] in SETUP}
    (b0, b1), (p0, p1) = spans["prt.build_tables"], spans["prt.pack_stream"]
    assert b0 <= p0 and p1 <= b1


def test_setup_spans_with_nothing_listening_are_the_null_context():
    for name in SETUP:
        assert profiling.annotate(name) is profiling._NULL


def test_cli_stats_prints_the_setup_spans_and_the_stream_counters(
        streamed, tmp_path, capsys):
    mesh = make_mesh("ico2")
    ply = write_ply(tmp_path / "ico2.ply", mesh)
    rc = cli.main(["--device", "cpu", "--ply", ply, "--width", str(W),
                   "--height", str(H), "--depth", "2", "--frames", "1",
                   "--stats", "--out", str(tmp_path / "f.png")])
    assert rc == 0
    printed = capsys.readouterr().out.splitlines()
    setup = next(line for line in printed if line.startswith("set-up: "))
    for name in SETUP:
        assert f"{name} " in setup and setup.split(name)[1].split()[1] == "s"
    line = next(line for line in printed if line.startswith("stream: "))
    got = {k: int(v) for k, v in (f.split("=") for f in line.split()[1:])}

    from parallelraytracing_tpu_torch.core.scene import ply_showcase_scene
    tables, _ = build_scene_tables(ply_showcase_scene(ply)[0], "cpu")
    s = tables.stream
    assert got == stream_counters(tables)
    assert got["triangles"] == len(mesh.indices) // 3 == 320
    assert got["slots"] == tables.tri.shape[1] == got["chunks"] * 32
    assert got["top_nodes"] == tables.tri_cl.shape[1]
    assert got["mini_columns"] == s.mini.shape[1] == got["chunks"] * s.node_rows
    assert got["table_bytes"] == 4 * (tables.tri.numel() + tables.tri_cl.numel()
                                      + s.mini.numel())
    assert profiling._recorder is None
