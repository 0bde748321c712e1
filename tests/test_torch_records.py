"""The kernels' 16-byte records of the scene tables (ops/pack.py).

The CUDA kernels read every table through ``PrtScene`` as records of
whole float4s (``pack_records``): a column of the JAX package's (C, N)
layout becomes one record, its values exact copies in the words
``record_rows`` names, zero in the pad words.  Here, on the CPU, for
every table kind of eight scenes (the headline RANDOM_BALLS_LARGE,
CORNELL, a level-2 icosphere mesh, the instanced tlas fixture,
texture_demo, textured instances, and the stream route at a low
threshold, plain and textured): record j holds column j's bits, the pad
words are zero, every record is 16-byte aligned, and the records unpack
to the column tables bit for bit.  A fused renderer makes the records
once, at init, and never per frame.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from torch_meshes import (bench_image, make_mesh, stream_scene,  # noqa: E402
                          textured_instance_scene, tlas_scene)

from parallelraytracing_tpu_torch import (Film, RenderConfig, Scene,  # noqa: E402
                                          ScenePreset, create_renderer,
                                          default_camera)
from parallelraytracing_tpu_torch.engines.tables import build_scene_tables  # noqa: E402
from parallelraytracing_tpu_torch.ops import pack  # noqa: E402
from parallelraytracing_tpu_torch.ops.trace import scene_arg  # noqa: E402

#: the stream route's knobs for the streamed fixtures (tests/test_torch_
#: stream.py's: ico2's 320 triangles in chunks of 32)
THRESHOLD, CHUNK = 64, 32


def _scene(name: str):
    if name in ("headline", "cornell", "texture_demo"):
        preset = {"headline": "random_balls_large"}.get(name, name)
        return Scene(ScenePreset(preset))
    ico1, ico2 = make_mesh("ico1"), make_mesh("ico2")
    return {"ico2": lambda: stream_scene(Scene, ico2),
            "tlas": lambda: tlas_scene(Scene, ico2),
            "textured_instances": lambda: textured_instance_scene(
                Scene, ico1, ico2, bench_image()),
            "stream": lambda: stream_scene(Scene, ico2),
            "stream_textured": lambda: stream_scene(Scene, ico2,
                                                    bench_image())}[name]()


FIXTURES = ("headline", "cornell", "ico2", "tlas", "texture_demo",
            "textured_instances", "stream", "stream_textured")


@functools.lru_cache(maxsize=None)
def _tables(name: str):
    """The scene's SceneTables on the CPU (NEE on where it has lights),
    the streamed fixtures packed at THRESHOLD / CHUNK."""
    old = pack.STREAM_THRESHOLD, pack.STREAM_CHUNK
    if name.startswith("stream"):
        pack.STREAM_THRESHOLD, pack.STREAM_CHUNK = THRESHOLD, CHUNK
    try:
        t, _ = build_scene_tables(_scene(name), "cpu", nee=True)
    finally:
        pack.STREAM_THRESHOLD, pack.STREAM_CHUNK = old
    assert (t.stream is not None) == name.startswith("stream")
    return t


def _columns(t) -> dict:
    return pack.record_columns(t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl,
                               t.tri_cl, t.mats, lights=t.lights, inst=t.inst,
                               stream=t.stream)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _unpack(records, kind: str, n_rows: int):
    """The (n_rows, N) column table read back from `records`: each row
    from the word ``record_rows`` puts it in (rows the kind leaves out
    stay zero)."""
    out = records.new_zeros((n_rows, records.shape[0]))
    for k, r in enumerate(pack.record_rows(kind, n_rows)):
        if r >= 0:
            out[r] = records[:, k]
    return out


@pytest.mark.parametrize("field,kind", pack.RECORD_KINDS)
@pytest.mark.parametrize("fixture", FIXTURES)
def test_records_hold_the_columns(fixture, field, kind):
    """Record j of each table is column j: its words the rows
    ``record_rows`` names, bit for bit, zero pad words, whole float4s,
    16-byte aligned; the records unpack to the column table.  A table the
    scene lacks (instances, mini-trees) has no records."""
    t = _tables(fixture)
    col, rec = _columns(t).get(field), getattr(t.records, field)
    if col is None:
        assert rec is None
        return
    n_rows, n = int(col.shape[0]), int(col.shape[1])
    rows = pack.record_rows(kind, n_rows)
    assert rec.dtype == torch.float32 and rec.is_contiguous()
    assert tuple(rec.shape) == (n, len(rows)) and len(rows) % 4 == 0
    assert rec.data_ptr() % 16 == 0 and (rec.shape[1] * 4) % 16 == 0
    for k, r in enumerate(rows):
        if r >= 0:
            assert torch.equal(_bits(rec[:, k]), _bits(col[r])), (k, r)
        else:
            assert not _bits(rec[:, k]).any(), k
    covered = sorted(r for r in rows if r >= 0)
    back = _unpack(rec, kind, n_rows)
    assert torch.equal(_bits(back[covered]), _bits(col[covered]))
    # a triangle table is split into its hit record and its tail: together
    # they hold every row once
    other = {"tri": "tri_tail", "tri_tail": "tri", "itri": "itri_tail",
             "itri_tail": "tri"}.get(field)
    if other is not None:
        rest = [r for r in pack.record_rows(other, n_rows) if r >= 0]
        assert sorted(covered + rest) == list(range(n_rows))
    else:
        assert covered == list(range(n_rows))


def test_record_kinds_cover_the_row_counts():
    """The row counts the kernels take: tri 27 or 33, itri 25 or 31, a
    tree 8 or a box table 6; any other table is refused."""
    for n in (pack.TRI_ROWS, pack.TRI_UV_ROWS):
        assert len(pack.record_rows("tri_tail", n)) == (12 if n == 27 else 20)
    for n in (pack.ITRI_ROWS, pack.ITRI_UV_ROWS):
        assert len(pack.record_rows("itri_tail", n)) == (12 if n == 25 else 16)
    assert pack.record_rows("node", 8) == (0, 1, 2, 6, 3, 4, 5, 7)
    assert pack.record_rows("node", 6) == (0, 1, 2, -1, 3, 4, 5, -1)
    for kind, n in (("tri", 26), ("tri_tail", 26), ("node", 7), ("sph", 5),
                    ("quad", 13),
                    ("mats", 6), ("lights", 27), ("inst", 25)):
        with pytest.raises(ValueError, match="record"):
            pack.record_rows(kind, n)


def test_scene_arg_takes_or_makes_records(monkeypatch):
    """The wrapper's scene struct points at the tables' own records when
    it is given them (no packing) and makes them when it is not (one
    pack a table); records that do not match the tables are refused."""
    t = _tables("tlas")
    calls = []
    real = pack.pack_records
    monkeypatch.setattr(pack, "pack_records",
                        lambda *a: calls.append(a[1]) or real(*a))
    tabs = (t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl, t.tri_cl, t.mats)
    kw = dict(t_min=1e-3, t_max=1e16, sky=t.sky, tri_live=t.tri_live,
              nee=t.nee, lights=t.lights, inst=t.inst)
    cpu = torch.device("cpu")
    s = scene_arg(cpu, *tabs, **kw, records=t.records)
    assert not calls
    assert s.sph == t.records.sph.data_ptr() and s.records is t.records
    assert s.itri_tail == t.records.itri_tail.data_ptr()
    assert (s.tri_tail_w, s.itri_tail_w) == (3, 3)
    s = scene_arg(cpu, *tabs, **kw)
    assert len(calls) == len([f for f, _ in pack.RECORD_KINDS
                              if getattr(t.records, f) is not None])
    assert s.records is not t.records
    assert torch.equal(s.records.inst, t.records.inst)
    bad = dataclasses.replace(t.records, sph=t.records.sph[:-1])
    with pytest.raises(ValueError, match="records.sph"):
        scene_arg(cpu, *tabs, **kw, records=bad)


def test_fused_renderer_packs_records_once(monkeypatch):
    """A fused renderer on the CPU makes its scene's records once, at
    init, and never again over its frames."""
    calls = []
    real = pack.pack_records
    monkeypatch.setattr(pack, "pack_records",
                        lambda *a: calls.append(a[1]) or real(*a))
    w, h = 32, 18
    film = Film(w, h, "cpu")
    r = create_renderer("fused", "cpu")
    r.init(film, Scene(ScenePreset.RANDOM_BALLS_LARGE), default_camera(w, h),
           RenderConfig(width=w, height=h, max_depth=3))
    at_init = len(calls)
    assert r._tables.records is not None
    assert at_init == len([f for f, _ in pack.RECORD_KINDS
                           if getattr(r._tables.records, f) is not None])
    for _ in range(2):
        r.progressive_render()
    assert len(calls) == at_init and film.sample_count == 2
