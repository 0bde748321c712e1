"""The port's stream route for big meshes against the JAX package's
streamed big-mesh layout (``_sah_threaded_tree(..., align=)``,
``_mini_threaded_tree``, ``_assemble_stream_blocks``, the ``tri_stream``
branch of ``pallas_trace`` and ``pallas_segment`` in Pallas interpret
mode).

The scene is tests/test_stream.py's (tests/torch_meshes.stream_scene)
around the icosahedron at level 2 (320 triangles), streamed at threshold
64 in chunks of 32 slots, both packages' module constants monkeypatched
alike (nothing in the JAX package is edited).  The JAX package stores a chunk's
triangles 4 (2 with texture coordinates) to a 128-lane row; the port
stores plain columns, so the tests unpack the JAX rows.  On the CPU the
port's trace and segment run their plain versions, a brute-force fold
over every slot column.  Each test states its tolerance."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
import parallelraytracing_tpu.ops.pallas_trace as pt  # noqa: E402
from parallelraytracing_tpu.core.camera import Camera as JaxCamera  # noqa: E402
from parallelraytracing_tpu.engines.tables import \
    build_scene_tables as jax_engine_tables  # noqa: E402
from parallelraytracing_tpu.engines.tables import \
    trace_tables as jax_trace_tables  # noqa: E402
from parallelraytracing_tpu.ops.rays import \
    generate_camera_rays_ids as jax_rays  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch import cli, convert  # noqa: E402
from parallelraytracing_tpu_torch.core.mesh import subdivide  # noqa: E402
from parallelraytracing_tpu_torch.engines.tables import build_scene_tables  # noqa: E402
from parallelraytracing_tpu_torch.ops import pack  # noqa: E402
from parallelraytracing_tpu_torch.ops.segment import PLANES, segment_slots  # noqa: E402
from parallelraytracing_tpu_torch.ops.trace import (scene_arg, trace,  # noqa: E402
                                                    trace_reference)
from parallelraytracing_tpu_torch.utils.png import read_png  # noqa: E402
from torch_meshes import bench_image, make_mesh, stream_scene, write_ply  # noqa: E402

THRESHOLD, CHUNK = 64, 32
W = H = 32  # 1024 rays: one 8x128 Pallas tile
SEED = 424242
EYE, DIR = np.array([0.0, 4.0, 10.0]), np.array([0.0, -2.5, -10.0])
#: the table cases: (chunk, node_rows, image); "fat" forces node_rows so
#: small that a full chunk's mini-tree cannot fit and takes the chained
#: fat leaves
CASES = {"plain": (CHUNK, None, False), "textured": (CHUNK, None, True),
         "fat": (64, 2, False)}


def _port_stream(monkeypatch, chunk=CHUNK):
    monkeypatch.setattr(pack, "STREAM_THRESHOLD", THRESHOLD)
    monkeypatch.setattr(pack, "STREAM_CHUNK", chunk)


def _jax_stream(monkeypatch, chunk=CHUNK, node_rows=None):
    monkeypatch.setattr(pt, "STREAM_THRESHOLD", THRESHOLD)
    monkeypatch.setattr(pt, "STREAM_CHUNK", chunk)
    monkeypatch.setattr(pt, "STREAM_NODE_ROWS", node_rows or 0)
    _port_stream(monkeypatch, chunk)


def _random_boxes(seed, n, n_invalid=0):
    rng = np.random.default_rng(seed)
    c = rng.random((n, 3)) * 10
    size = rng.uniform(0.05, 0.5, (n, 3))
    mn, mx = c - size, c + size
    mn[:n_invalid], mx[:n_invalid] = 1.0, -1.0  # inverted: invalid
    return mn, mx


# --------------------------------------------------------------- packer

@pytest.mark.parametrize("tau", [0.0, pack.COLLAPSE_TAU])
def test_aligned_tree_equals_jax(tau):
    """Tolerance 0: the chunk-aligned top tree of 500 random boxes (10
    invalid) and its permutation equal the JAX package's; its leaves
    round-trip as tests/test_stream.py checks them (lo chunk-aligned,
    span <= chunk, every valid box in exactly one leaf run)."""
    mn, mx = _random_boxes(3, 500, 10)
    perm, tree = pack._sah_threaded_tree(mn, mx, CHUNK, tau, align=CHUNK)
    jperm, jtree = pt._sah_threaded_tree(mn, mx, CHUNK, align=CHUNK,
                                         collapse_tau=tau)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(tree, jtree)
    mult = 1 << pack.stream_shift(CHUNK)
    assert mult == 64
    leaves = tree[7][tree[7] >= 0].astype(np.int64)
    spans, los = leaves % mult, (leaves // mult) * CHUNK
    assert (spans <= CHUNK).all() and (spans > 0).all()
    covered = [int(p) for lo, sp in zip(los, spans) for p in perm[lo:lo + sp]]
    assert min(covered) >= 0 and sorted(covered) == list(range(10, 500))


@pytest.mark.parametrize("group", [1, 2, 4])
def test_mini_tree_equals_jax(group):
    """Tolerance 0: the full-sweep SAH mini-tree over 30 boxes (a group
    remainder padded with -1), leaves of 8 slots, equals the JAX
    package's; group > 1 leaves are group-aligned slot ranges."""
    mn, mx = _random_boxes(7, 30)
    perm, tab = pack._mini_threaded_tree(mn, mx, 8, group)
    jperm, jtab = pt._mini_threaded_tree(mn, mx, 8, group=group)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(tab, jtab)
    enc = tab[7][tab[7] >= 0].astype(np.int64)
    assert ((enc >> 6) % group == 0).all() and ((enc & 63) <= 8).all()
    assert sorted(perm[perm >= 0].tolist()) == list(range(30))


def _unpack_blocks(blocks, n_attr, chunk, pack_, node_rows):
    """The JAX package's blocks read slot by slot: slot s of chunk c at
    row c * block + s // pack, lanes (s % pack) * 128 / pack + k."""
    stride, rows = 128 // pack_, chunk // pack_
    block = rows + node_rows
    n_chunks = blocks.shape[0] // block
    slots = np.zeros((n_attr, n_chunks * chunk), np.float32)
    mini = np.zeros((8, n_chunks * node_rows), np.float32)
    for c in range(n_chunks):
        for s in range(chunk):
            row = blocks[c * block + s // pack_]
            slots[:, c * chunk + s] = row[(s % pack_) * stride:
                                          (s % pack_) * stride + n_attr]
        mini[:, c * node_rows:(c + 1) * node_rows] = \
            blocks[c * block + rows:(c + 1) * block, :8].T
    return slots, mini


def _both_packs(monkeypatch, case):
    chunk, node_rows, textured = CASES[case]
    _jax_stream(monkeypatch, chunk, node_rows)
    image = bench_image() if textured else None
    jt = pt.pack_scene_tables(stream_scene(J.Scene, make_mesh("ico2"),
                                           image).build(), eye=None)
    host = stream_scene(T.Scene, make_mesh("ico2"), image).build(
        "cpu").numpy()
    tabs = pack.pack_scene_tables(host, node_rows=node_rows)
    return jt, tabs


@pytest.mark.parametrize("case", list(CASES))
def test_stream_tables_equal_jax(monkeypatch, case):
    """Tolerance 0: on the stream route the top tree, the triangle slots
    and the mini-trees equal the JAX package's blocks unpacked (27 rows
    in groups of 4; 33 with texture coordinates, in groups of 2; chained
    fat leaves when no mini-tree fits), and the other tables its dense
    ones."""
    jt, tabs = _both_packs(monkeypatch, case)
    chunk, node_rows, textured = CASES[case]
    st = tabs.stream
    n_attr = 33 if textured else 27
    assert tabs[2].shape[0] == n_attr and len(tabs) == 7
    assert (st.chunk, st.node_rows) == (chunk, node_rows or 16)
    assert tuple(jt[9:]) == (chunk, 2 if textured else 4, st.node_rows)
    for i in (0, 1, 3, 4, 5, 6):  # tri_cl (5) is the top tree
        assert tabs[i].shape == jt[i].shape, i
        np.testing.assert_array_equal(tabs[i], jt[i], err_msg=str(i))
    slots, mini = _unpack_blocks(np.asarray(jt[2]), n_attr, *jt[9:])
    np.testing.assert_array_equal(tabs[2], slots)
    np.testing.assert_array_equal(st.mini, mini)
    # every triangle in exactly one slot, the rest zero columns
    live = tabs[2][0:3].any(0)
    assert live.sum() == len(set(tabs[2][17][live].tolist())) == 320
    assert not tabs[2][:, ~live].any()
    enc = st.mini[7][st.mini[7] >= 0].astype(np.int64)
    fat = (enc & 63) > 4 * pack.STREAM_SUB
    assert fat.any() == (case == "fat")


@pytest.mark.parametrize("case", ["plain", "textured"])
def test_convert_carries_jax_blocks(monkeypatch, case):
    """Tolerance 0: convert.stream_from_blocks turns the JAX package's
    blocks into the port's own slots and StreamTables, and
    tables_from_numpy carries them to a device; a table of torn blocks is
    refused."""
    jt, tabs = _both_packs(monkeypatch, case)
    n_attr = tabs[2].shape[0]
    slots, st = convert.stream_from_blocks(jt[2], n_attr, *jt[9:])
    np.testing.assert_array_equal(slots, tabs[2])
    np.testing.assert_array_equal(st.mini, tabs.stream.mini)
    assert (st.chunk, st.node_rows, st.shift) == (
        tabs.stream.chunk, tabs.stream.node_rows, 6)
    t = convert.tables_from_numpy(*jt[:2], slots, *jt[3:7], (0.5, 0.7, 1.0),
                                  "cpu", stream=st)
    assert t.tri_live and torch.equal(t.stream.mini,
                                      torch.from_numpy(tabs.stream.mini))
    with pytest.raises(ValueError, match="blocks"):
        convert.stream_from_blocks(jt[2][:-1], n_attr, *jt[9:])


def test_stream_tables_are_validated(monkeypatch):
    """The wrappers refuse stream tables whose shapes disagree (a chunk
    that does not divide the slots, a mini-tree table off its node_rows
    stride) and pack the kernels' scene struct with the mini-trees,
    chunk, node_rows and shift."""
    _port_stream(monkeypatch)
    t, _ = build_scene_tables(stream_scene(T.Scene, make_mesh("ico2")), "cpu")
    st = t.stream
    tabs = (t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl, t.tri_cl, t.mats)
    kw = dict(t_min=1e-3, t_max=1e16, sky=t.sky, tri_live=t.tri_live)
    s = scene_arg(torch.device("cpu"), *tabs, **kw, stream=st,
                  records=t.records)
    assert s.mini == t.records.mini.data_ptr()
    assert s.n_mini == st.mini.shape[1]
    assert (s.chunk, s.node_rows, s.stream_shift) == (CHUNK, 16, 6)
    assert s.n_tri == t.tri.shape[1] == st.mini.shape[1] // 16 * CHUNK
    assert scene_arg(torch.device("cpu"), *tabs, **kw).mini is None
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, -1.0, 0.0]] * 2)
    bad = [pack.StreamTables(st.mini, CHUNK + 1, 16),
           pack.StreamTables(st.mini[:, :-1].contiguous(), CHUNK, 16)]
    for b in bad:
        with pytest.raises(ValueError, match="stream tables"):
            trace_reference(o, d, torch.zeros(2, dtype=torch.int32), 1,
                            *tabs, max_depth=1, **kw, stream=b)
        with pytest.raises(ValueError, match="stream tables"):
            scene_arg(torch.device("cpu"), *tabs, **kw, stream=b)


# ------------------------------------------- trace and segment vs Pallas

def _jax_setup(monkeypatch, depth):
    """(JAX engine tables streamed, port tables streamed, camera rays
    without jitter, pixel ids, JAX config)."""
    _jax_stream(monkeypatch)
    cfg = J.RenderConfig(width=W, height=H, max_depth=depth, jitter=False)
    jt, _ = jax_engine_tables(stream_scene(J.Scene, make_mesh("ico2")), cfg)
    assert (jt.tri_stream, jt.tri_pack, jt.tri_snode) == (CHUNK, 4, 16)
    t, _ = build_scene_tables(stream_scene(T.Scene, make_mesh("ico2")), "cpu")
    assert t.stream is not None
    cam = JaxCamera(EYE, DIR, float(W), float(H), 100.0)
    ids = np.random.default_rng(5).permutation(W * H).astype(np.int32)
    o, d = jax_rays(jnp.asarray(cam.ray_params()), W, H, jnp.asarray(ids),
                    None, False, pix_seed=jnp.uint32(987))
    return jt, t, np.array(o), np.array(d), ids, cfg


def test_trace_depth1_matches_pallas_stream(monkeypatch):
    """Depth 1, no jitter: the plain trace on the port's stream tables
    and pallas_trace on the JAX package's streamed blocks (interpret)
    give every ray's radiance within 1e-5 absolute."""
    jt, t, o, d, ids, cfg = _jax_setup(monkeypatch, 1)
    ref = np.asarray(jax_trace_tables(
        jt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ids, jnp.float32),
        jnp.asarray([SEED], jnp.int32), 8, cfg, interpret=True))
    got = trace(torch.from_numpy(o), torch.from_numpy(d),
                torch.from_numpy(ids), SEED, t.sph, t.quad, t.tri, t.sph_cl,
                t.quad_cl, t.tri_cl, t.mats, max_depth=1, t_min=cfg.t_min,
                t_max=cfg.t_max, sky=t.sky, tri_live=t.tri_live,
                stream=t.stream).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert (ref[:, 0] != ref[0, 0]).any()  # hits and misses both


def test_segment_matches_pallas_segment_stream(monkeypatch):
    """One 1-bounce segment from the camera rays, every slot live: the
    plain segment on the port's stream tables and pallas_segment on the
    JAX package's streamed blocks (interpret) agree on all 13 planes
    within 1e-5 absolute per slot, the alive plane exactly."""
    jt, t, o, d, ids, cfg = _jax_setup(monkeypatch, 1)
    r = W * H
    state = np.concatenate([o.T, d.T, np.ones((3, r)), np.zeros((3, r)),
                            np.ones((1, r))]).astype(np.float32)
    planes, alive = pt.pallas_segment(
        jnp.asarray(ids, jnp.float32), tuple(jnp.asarray(p) for p in state),
        jt.sph, jt.quad, jt.tri, jt.sph_cl, jt.quad_cl, jt.tri_cl, jt.mats,
        jt.lights, jnp.asarray([SEED, 0, r], jnp.int32), 8, 1, cfg.t_min,
        cfg.t_max, jt.sky, interpret=True, vmem_kinds=jt.vmem_kinds,
        tri_stream=jt.tri_stream, tri_pack=jt.tri_pack,
        tri_snode=jt.tri_snode)
    ref = np.stack([np.asarray(p) for p in planes] + [np.asarray(alive)])
    got = segment_slots(
        torch.from_numpy(ids), torch.from_numpy(state),
        torch.tensor([SEED, 0, r], dtype=torch.int32), t.sph, t.quad, t.tri,
        t.sph_cl, t.quad_cl, t.tri_cl, t.mats, n_bounces=1, t_min=cfg.t_min,
        t_max=cfg.t_max, sky=t.sky, tri_live=t.tri_live,
        stream=t.stream).numpy()
    assert got.shape == ref.shape == (PLANES, r)
    np.testing.assert_array_equal(got[12], ref[12])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert 0 < got[12].sum() < r  # some paths end, some go on


# ------------------------------------------------------ the port's films

def _film(engine, nee):
    cfg = T.RenderConfig(width=32, height=24, max_depth=6, seed=0, nee=nee)
    film = T.Film(32, 24, "cpu")
    r = T.create_renderer(engine, "cpu")
    r.init(film, stream_scene(T.Scene, make_mesh("ico2")),
           T.Camera(EYE, DIR, 32.0, 24.0, 100.0), cfg)
    for _ in range(2):
        r.progressive_render()
    return r, film.hdr_average()


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("engine", ["fused", "wavefront_fused"])
def test_stream_film_equals_dense(monkeypatch, engine, nee):
    """Tolerance 0, the reference's contract (tests/test_stream.py): the
    streamed film of 2 frames at 32x24, depth 6, equals the dense one bit
    for bit (the fold's (t, ordinal) minimum does not depend on the
    layout; pad slots are never hit)."""
    r_d, img_d = _film(engine, nee)
    _port_stream(monkeypatch)
    r_s, img_s = _film(engine, nee)
    assert r_s._tables.stream.chunk == CHUNK and r_d._tables.stream is None
    assert r_s._tables.nee == r_d._tables.nee == nee
    assert torch.equal(img_s, img_d) and img_s.mean() > 0


def test_cli_renders_level6_ply_streamed(tmp_path, capsys):
    """A --ply of 81,920 triangles (the icosahedron at level 6, above the
    default threshold of 24,576) renders through the stream route on the
    CPU; the header names the chunk."""
    mesh = subdivide(make_mesh("ico2"), 4)
    out = tmp_path / "big.png"
    rc = cli.main(["--device", "cpu", "--ply",
                   write_ply(tmp_path / "ico6.ply", mesh), "--width", "16",
                   "--height", "16", "--frames", "1", "--depth", "2",
                   "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "engine=wavefront_fused " in text and "wrote" in text
    assert f"stream_chunk={pack.STREAM_CHUNK} " in text
    img = read_png(str(out))
    assert img.shape == (16, 16, 4) and img[..., :3].std() > 0
