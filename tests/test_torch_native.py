"""The port's native helpers (native.py: native/src/*.cpp built with g++
into build/native/) against the port's Python builder and reader and the
JAX package's ``native`` module.

Tolerances: exact.  The LBVH arrays of the native build equal the port's
Python builder's and the JAX package's native build's on four scenes (the
spheres and quads of three presets, and the level-3 icosphere's 1,280
triangles); ``load_ply`` of binary and ascii PLYs of the level-2 icosphere written
by ``tests/torch_meshes.write_ply`` returns the Python reader's arrays and
the JAX native reader's; the PNG encoder's bytes decode to its input.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parallelraytracing_tpu import native as jnative  # noqa: E402
from parallelraytracing_tpu.accel import lbvh as jlbvh  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch import native  # noqa: E402
from parallelraytracing_tpu_torch.accel import lbvh  # noqa: E402
from parallelraytracing_tpu_torch.core import mesh as tmesh  # noqa: E402
from parallelraytracing_tpu_torch.utils import png  # noqa: E402
from torch_meshes import make_mesh, write_ply  # noqa: E402

FIELDS = ("node_min", "node_max", "node_kind", "node_idx", "node_miss",
          "node_ord")


def test_builds_into_the_port_build_dir():
    assert native.available(), native.build_log()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    cmd = native.build_log().splitlines()[0]
    assert "-march=x86-64-v2" in cmd and cmd.endswith(".so") and "-lz" in cmd


def _scene(name):
    if name == "ico3":
        s = T.Scene(preset=None)
        s.add_mesh(tmesh.icosphere(3), s.add_lambertian((0.5, 0.5, 0.5)), None)
        s.add_quad(10, 10, s.add_lambertian((0.4, 0.4, 0.4)), None)
        return s.build("cpu")
    return T.Scene(T.ScenePreset(name)).build("cpu")


@pytest.mark.parametrize("name", ["random_balls_large", "cornell",
                                  "material_test", "ico3"])
def test_lbvh_native_equals_python_and_jax(name):
    sd = _scene(name)
    py = lbvh.build_bvh(sd, prefer_native=False)
    nat = lbvh.build_bvh(sd)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(nat, f).numpy(),
                                      getattr(py, f).numpy(), err_msg=f)
    s = sd.numpy()
    mn, mx, _, _ = lbvh.scene_primitive_aabbs(s)
    ours = native.build_lbvh(mn, mx)
    assert jnative.available()
    theirs = jnative.build_lbvh(mn, mx)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_build_threaded_native_equals_python():
    rng = np.random.default_rng(1)
    c = rng.uniform(-50, 50, (3000, 3))
    r = rng.uniform(0.01, 0.5, (3000, 1))
    a = lbvh.build_threaded(c - r, c + r, prefer_native=False)
    b = lbvh.build_threaded(c - r, c + r)
    j = jlbvh.build_threaded(c - r, c + r)
    for x, y, z in zip(a, b, j):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(z))


@pytest.mark.parametrize("fmt,normals", [("binary", False), ("ascii", True)])
def test_load_ply_native_equals_python_and_jax(tmp_path, fmt, normals):
    mesh = make_mesh("ico2")
    if normals:
        mesh.compute_vertex_normals()
    path = write_ply(str(tmp_path / "ico.ply"), mesh, fmt=fmt,
                     normals=normals)
    py = tmesh.load_ply(path, prefer_native=False)
    nat = tmesh.load_ply(path)
    for f in ("vertices", "indices", "normals", "texcoords"):
        a, b = getattr(py, f), getattr(nat, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    theirs = jnative.load_ply(path)
    for a, b in zip(native.load_ply(path), theirs):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_encode_round_trip(channels):
    img = np.random.default_rng(channels).integers(
        0, 256, (37, 53, channels), dtype=np.uint8)
    for level in (1, 6):
        data = native.encode_png(img, level=level)
        np.testing.assert_array_equal(png.decode_png(data), img)
    assert native.encode_png(img, 6) == jnative.encode_png(img, 6)
    with pytest.raises(ValueError):
        native.encode_png(img[..., :2])
