"""The port's mesh path against the JAX package: PLY loader, mesh scenes,
packed triangle tables, the triangle body of the trace, and the CLI.

The meshes are those of tests/torch_meshes.py, written as ascii or binary
PLY with numpy: a tetrahedron (a tiny triangle kind, a plain loop), an
octahedron (the linear scan) and the icosahedron at level 2 (the
threaded SAH tree).

Each test states its tolerance.  On the CPU the port's ``trace`` runs its
plain PyTorch version; ``pallas_trace`` runs in Pallas interpret mode."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core import mesh as jmesh  # noqa: E402
from parallelraytracing_tpu.core.camera import Camera as JaxCamera  # noqa: E402
from parallelraytracing_tpu.core.scene import \
    ply_showcase_scene as jax_showcase  # noqa: E402
from parallelraytracing_tpu.engines.tables import \
    build_scene_tables as jax_engine_tables  # noqa: E402
from parallelraytracing_tpu.ops.pallas_trace import (pack_lights_table,  # noqa: E402
                                                     pallas_trace)
from parallelraytracing_tpu.ops.pallas_trace import \
    pack_scene_tables as jax_pack  # noqa: E402
from parallelraytracing_tpu.ops.rays import \
    generate_camera_rays_ids as jax_rays  # noqa: E402

from parallelraytracing_tpu_torch import cli, convert  # noqa: E402
from parallelraytracing_tpu_torch.core import mesh as tmesh  # noqa: E402
from parallelraytracing_tpu_torch.core.scene import SceneData, ply_showcase_scene  # noqa: E402
from parallelraytracing_tpu_torch.engines.tables import build_scene_tables  # noqa: E402
from parallelraytracing_tpu_torch.ops.pack import pack_scene_tables, scene_bbox  # noqa: E402
from parallelraytracing_tpu_torch.ops.trace import trace  # noqa: E402
from parallelraytracing_tpu_torch.utils.png import read_png  # noqa: E402
from torch_meshes import (ICO_F, ICO_V, MESHES, make_mesh, mesh_ply,  # noqa: E402
                          write_ply)

FIELDS = [f.name for f in dataclasses.fields(SceneData)]
W = H = 32  # 1024 rays: one 8x128 Pallas tile
SEED = 424242


# --------------------------------------------------------------- loader

@pytest.mark.parametrize("fmt", ["ascii", "binary"])
@pytest.mark.parametrize("normals", [False, True])
def test_load_ply_matches_jax(tmp_path, fmt, normals):
    """Tolerance 0: the same numpy parse and the same float32 arrays."""
    m = make_mesh("ico2")
    m.compute_vertex_normals()
    path = write_ply(tmp_path / "m.ply", m, fmt, normals)
    got = tmesh.load_ply(path)
    ref = jmesh.load_ply(path, prefer_native=False)
    for f in ("vertices", "indices", "normals"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert got.texcoords is None and ref.texcoords is None


@pytest.mark.parametrize("level", [1, 3])
def test_subdivide_and_normals_match_jax(level):
    """Tolerance 0: the same float64 host arithmetic rounded to float32."""
    v = np.asarray(ICO_V, np.float32)
    f = np.asarray(ICO_F, np.uint32).reshape(-1)
    n = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    got = tmesh.subdivide(tmesh.Mesh(v, f, n), level)
    ref = jmesh.subdivide(jmesh.Mesh(v, f, n), level)
    got.compute_vertex_normals()
    ref.compute_vertex_normals()
    for name in ("vertices", "indices", "normals"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))


# ------------------------------------------------------ scene and tables

def _scenes(path):
    got, eye, look = ply_showcase_scene(path)
    ref, jeye, jlook = jax_showcase(path)
    assert (eye, look) == (jeye, jlook)
    return got, ref


@pytest.mark.parametrize("name", list(MESHES))
def test_showcase_scene_data_equals_jax(tmp_path, name):
    """Tolerance 0: add_mesh bakes with the same float64 host math."""
    got, ref = _scenes(mesh_ply(tmp_path, name))
    a = got.build("cpu").numpy()
    sd = ref.build()
    for f in FIELDS:
        if getattr(sd, f) is None:  # an extension field the scene leaves unused
            assert a[f] is None, f
            continue
        b = np.asarray(getattr(sd, f))
        assert a[f].dtype == b.dtype, f
        np.testing.assert_array_equal(a[f], b, err_msg=f)
    assert a["tri_valid"].sum() == len(got._tri) == len(ref._tri)


@pytest.mark.parametrize("name,level", [("ico2", 2), ("ico4", 4)])
def test_triangle_tables_equal_jax(tmp_path, name, level):
    """Tolerance 0: the triangle and tree tables of the showcase scene
    equal ``pack_scene_tables(..., eye=None)``'s raw output, and the scene
    box equals the JAX engine tables' ``bb``."""
    m = tmesh.subdivide(make_mesh("ico2"), level - 2)
    got, ref = _scenes(write_ply(tmp_path / f"{name}.ply", m))
    sd = ref.build()
    want = jax_pack(sd, eye=None)[:7]
    host = got.build("cpu").numpy()
    tabs = pack_scene_tables(host)
    names = ["sph", "quad", "tri", "sph_cl", "quad_cl", "tri_cl", "mats"]
    for n, a, b in zip(names, want, tabs):
        assert a.dtype == b.dtype and a.shape == b.shape, n
        np.testing.assert_array_equal(b, a, err_msg=n)
    assert tabs[2].shape == (27, 20 * 4 ** level) and tabs[5].shape[0] == 8
    if level == 2:
        jt, _ = jax_engine_tables(ref, J.RenderConfig(width=8, height=8))
        assert scene_bbox(host) == jt.bb


@pytest.mark.parametrize("name,cl_shape", [("tetra", (6, 2)), ("octa", (6, 3)),
                                           ("ico2", None)])
def test_each_walk_gets_its_table(tmp_path, name, cl_shape):
    """The three meshes exercise the three walks: a tiny kind's (6, 2)
    table is never walked, the octahedron's 2 clusters of TRI_CLUSTER are
    a linear (6, 3) table, and 320 triangles make an (8, M) tree."""
    got, _ = _scenes(mesh_ply(tmp_path, name))
    t, _ = build_scene_tables(got, "cpu")
    assert t.tri_live
    if cl_shape is None:
        assert t.tri_cl.shape[0] == 8
    else:
        assert tuple(t.tri_cl.shape) == cl_shape


@pytest.mark.parametrize("name", list(MESHES))
def test_kernel_scene_struct_takes_each_walk(tmp_path, name):
    """The table set validates each kind's linear table with its own
    cluster size when it is made: the octahedron's (6, 3) table passes
    with TRI_CLUSTER and would be refused under the sphere/quad CLUSTER;
    a table of the wrong width is refused.  The kernels' scene struct
    (ops/trace.scene_struct) carries the triangle kind's walk."""
    from parallelraytracing_tpu_torch import RenderConfig
    from parallelraytracing_tpu_torch.ops.pack import CLUSTER, TRI_CLUSTER
    from parallelraytracing_tpu_torch.ops.trace import scene_struct
    got, _ = _scenes(mesh_ply(tmp_path, name))
    t, _ = build_scene_tables(got, "cpu")
    cfg = RenderConfig()
    s = scene_struct(t, cfg)
    assert (s.n_tri, s.tri_csize, s.csize) == (t.tri.shape[1], TRI_CLUSTER,
                                               CLUSTER)
    assert (s.tri_cl_rows, s.tri_cl_cols) == tuple(t.tri_cl.shape)
    if t.tri_cl.shape[0] == 6:
        bad = torch.zeros((6, t.tri_cl.shape[1] + 1))
        with pytest.raises(ValueError, match="tri_cl"):
            dataclasses.replace(t, tri_cl=bad)
    assert scene_struct(dataclasses.replace(t, tri_live=False),
                        cfg).n_tri == 0


# ----------------------------------------------- trace vs pallas_trace

def _trace_both(path, depth, jitter):
    """(pallas_trace radiance, port trace radiance) of the same camera
    rays through the JAX package's raw packed tables."""
    ref_scene, eye, look = jax_showcase(path)
    sd = ref_scene.build()
    raw = jax_pack(sd, eye=None)[:7]
    eye, look = np.asarray(eye), np.asarray(look)
    cam = JaxCamera(eye, look - eye, float(W), float(H), 100.0)
    cfg = J.RenderConfig(width=W, height=H, max_depth=depth, jitter=jitter)
    ids = np.random.default_rng(5).permutation(W * H).astype(np.int32)
    o, d = jax_rays(jnp.asarray(cam.ray_params()), W, H, jnp.asarray(ids),
                    None, jitter, pix_seed=jnp.uint32(987))
    sky = tuple(float(s) for s in np.asarray(sd.sky))
    ref = np.asarray(pallas_trace(
        o, d, jnp.asarray(ids, jnp.float32), *(jnp.asarray(a) for a in raw[:7]),
        jnp.asarray(pack_lights_table(sd)), jnp.asarray([SEED], jnp.int32), 8,
        depth, cfg.t_min, cfg.t_max, sky, interpret=True))
    t = convert.tables_from_numpy(*raw, sky, "cpu")
    got = trace(torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)),
                torch.from_numpy(ids), SEED, t, cfg).numpy()
    return ref, got


@pytest.mark.parametrize("name", list(MESHES))
def test_trace_depth1_matches_pallas(tmp_path, name):
    """Depth 1, no jitter: every ray's radiance within 1e-5 absolute."""
    ref, got = _trace_both(mesh_ply(tmp_path, name), 1, False)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(MESHES))
def test_trace_depth4_jittered_matches_pallas(tmp_path, name):
    """Depth 4 with jitter: >= 98% of rays within 1e-4 and the mean within
    1e-3 relative (XLA and PyTorch round sqrt/sin/cos, and XLA contracts
    multiply-adds, differently; a last-bit difference at a grazing hit
    sends a few paths elsewhere)."""
    ref, got = _trace_both(mesh_ply(tmp_path, name), 4, True)
    close = (np.abs(got - ref).max(1) <= 1e-4).mean()
    assert close >= 0.98, close
    assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


# ------------------------------------------------------------------- CLI

@pytest.mark.parametrize("level,engine", [(2, "fused"), (3, "wavefront_fused")])
def test_cli_renders_ply_and_routes_by_triangles(tmp_path, capsys, level,
                                                 engine):
    """--ply renders the showcase scene to a PNG; auto picks
    wavefront_fused above 512 triangles (1280 at level 3), else fused."""
    m = tmesh.subdivide(make_mesh("ico2"), level - 2)
    out = tmp_path / "mesh.png"
    rc = cli.main(["--device", "cpu", "--ply", write_ply(tmp_path / "m.ply", m),
                   "--width", "16", "--height", "12", "--frames", "1",
                   "--depth", "3", "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and f"engine={engine} " in text and "wrote" in text
    img = read_png(str(out))
    assert img.shape == (12, 16, 4) and img[..., :3].std() > 0
