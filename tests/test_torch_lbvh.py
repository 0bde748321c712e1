"""The port's LBVH build (accel/lbvh.py) and refit (accel/refit.py)
against the JAX package's on the CPU.

Tolerances: none, everything is exact.
- The Morton codes, ``_karras_tree``'s children, ``thread_tree``'s slots,
  payloads and escape links, the global ordinals, and every ``BVHData``
  array (boxes bit for bit, kind, idx, ord and miss equal) against both
  JAX builders: ``_build_bvh_python`` and ``build_bvh`` (which takes the
  native C++ builder when ``_native.so`` is built, and the Python one
  otherwise).  On MATERIAL_TEST, CORNELL, RANDOM_BALLS_LARGE, the level-2
  icosphere's scene (tests/torch_meshes.stream_scene) and random spheres
  (n = 1, 2, 7, 300).
- ``build_refit_plan``'s levels equal (values and dtypes); ``leaf_aabbs``
  and ``refit_bvh`` on moved spheres equal bit for bit (0 ulp), and a
  refit of the unmoved random balls equals the build.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.accel import lbvh as jlbvh  # noqa: E402
from parallelraytracing_tpu.accel import refit as jrefit  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch.accel import lbvh, refit  # noqa: E402
from torch_meshes import make_mesh, stream_scene  # noqa: E402

FIELDS = ("node_min", "node_max", "node_kind", "node_idx", "node_miss",
          "node_ord")
SCENES = ["material_test", "cornell", "random_balls_large", "ico2",
          "spheres1", "spheres2", "spheres7", "spheres300"]


def random_spheres(scene_cls, n, seed=0, spread=20.0):
    """tests/test_bvh.py's random sphere scene, in either package."""
    s = scene_cls(preset=None)
    g = np.random.RandomState(seed)
    for _ in range(n):
        mat = s.add_lambertian(g.uniform(0, 1, 3))
        c = g.uniform(-spread, spread, 3)
        s.add_sphere(g.uniform(0.2, 1.5), mat, ((1, 1, 1), (0, 0, 0), c))
    return s


@pytest.fixture(scope="module", params=SCENES)
def scenes(request):
    """(JAX SceneData, port SceneData) of one scene."""
    name = request.param
    if name == "ico2":
        mesh = make_mesh("ico2")
        return (stream_scene(J.Scene, mesh).build(),
                stream_scene(T.Scene, mesh).build("cpu"))
    if name.startswith("spheres"):
        n = int(name[len("spheres"):])
        return (random_spheres(J.Scene, n).build(),
                random_spheres(T.Scene, n).build("cpu"))
    return (J.Scene(J.ScenePreset(name)).build(),
            T.Scene(T.ScenePreset(name)).build("cpu"))


def _equal(jbvh, tbvh):
    for f in FIELDS:
        ref = np.asarray(getattr(jbvh, f))
        got = getattr(tbvh, f).numpy()
        assert got.dtype == ref.dtype, f
        np.testing.assert_array_equal(got, ref, err_msg=f)


def test_bvh_arrays_equal_both_jax_builders(scenes):
    js, ts = scenes
    got = lbvh.build_bvh(ts)
    _equal(jlbvh.build_bvh(js), got)
    _equal(jlbvh._build_bvh_python(js, *jlbvh.scene_primitive_aabbs(js)), got)
    assert got.num_nodes == max(1, 2 * int(
        ts.sph_valid.sum() + ts.quad_valid.sum() + ts.tri_valid.sum()) - 1)


def test_morton_karras_threading_and_ordinals_equal_jax(scenes):
    js, ts = scenes
    jb = jlbvh.scene_primitive_aabbs(js)
    tb = lbvh.scene_primitive_aabbs(ts)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b, a)
    mn, mx, kind, idx = tb
    np.testing.assert_array_equal(lbvh._global_ordinals(ts, kind, idx),
                                  jlbvh._global_ordinals(js, kind, idx))
    n = len(kind)
    if n < 2:
        return
    centroid = (mn + mx) * 0.5
    lo = centroid.min(axis=0)
    pts = (centroid - lo) / np.maximum(centroid.max(axis=0) - lo, 1e-12)
    codes = lbvh.morton3d(pts)
    np.testing.assert_array_equal(codes, jlbvh.morton3d(pts))
    order = np.argsort(codes, kind="stable")
    keys = (codes[order].astype(np.uint64) << np.uint64(31)) \
        | np.arange(n, dtype=np.uint64)
    tree = lbvh._karras_tree(keys)
    for a, b in zip(jlbvh._karras_tree(keys), tree):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jlbvh.thread_tree(*tree, n), lbvh.thread_tree(*tree, n)):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jlbvh.build_threaded(mn, mx), lbvh.build_threaded(mn, mx)):
        np.testing.assert_array_equal(b, a)


def test_refit_plan_levels_equal_jax(scenes):
    js, ts = scenes
    want = jrefit.build_refit_plan(jlbvh.build_bvh(js))
    got = refit.build_refit_plan(lbvh.build_bvh(ts))
    assert len(got.levels) == len(want.levels)
    assert got.quad_pad == want.quad_pad
    for lw, lg in zip(want.levels, got.levels):
        for a, b in zip(lw, lg):
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("preset", ["random_balls_small", "random_balls_large",
                                    "material_test"])
def test_refit_of_moved_spheres_equal_jax(preset):
    js = J.Scene(J.ScenePreset(preset)).build()
    ts = T.Scene(T.ScenePreset(preset)).build("cpu")
    jb, tb = jlbvh.build_bvh(js), lbvh.build_bvh(ts)
    jp, tp = jrefit.build_refit_plan(jb), refit.build_refit_plan(tb)
    off = np.float32([3.0, 1.0, -2.0])
    grow = np.float32(1.25)
    jm = dataclasses.replace(js, sph_center=js.sph_center + jnp.asarray(off),
                             sph_radius=js.sph_radius * grow)
    tm = dataclasses.replace(ts, sph_center=ts.sph_center + torch.from_numpy(off),
                             sph_radius=ts.sph_radius * float(grow))
    for a, b in zip(jrefit.leaf_aabbs(jm, jb.node_kind, jb.node_idx),
                    refit.leaf_aabbs(tm, tb.node_kind, tb.node_idx)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    want, got = jrefit.refit_bvh(jb, jm, jp), refit.refit_bvh(tb, tm, tp)
    _equal(want, got)
    # the moved root holds every moved sphere
    c = tm.sph_center[tm.sph_valid]
    r = tm.sph_radius[tm.sph_valid][:, None]
    assert bool((got.node_min[0] <= (c - r).amin(0)).all())
    assert bool((got.node_max[0] >= (c + r).amax(0)).all())
    if preset.startswith("random_balls"):
        # unmoved: the refit is the build (its quad's box too, at this size)
        same = refit.refit_bvh(tb, ts, tp)
        assert torch.equal(same.node_min, tb.node_min)
        assert torch.equal(same.node_max, tb.node_max)
