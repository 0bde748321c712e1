"""The port's two-level walk (accel/tlas.py) and the `tlas_ref` engine
against the JAX package's on the CPU.

Tolerances:
- ``build_two_level``: every array equal (values and dtypes);
- ``tlas_intersect`` on 4,096 seeded rays: inst and tri exactly, t within
  1e-6 relative, b1 and b2 within 1e-5 (measured: all bit-equal), and
  ``resolve_instanced_hit``'s position and normal within 1e-5, its front
  flag and material exactly;
- a `tlas_ref` frame against the JAX engine's, without and with NEE:
  >= 99.9% of rays within 1e-5 (measured: all, max 2.8e-6);
- a `tlas_ref` frame against the port's megakernel on the same
  transforms baked: HDR RMSE < 1e-3 (tests/test_tlas.py's gate; measured
  0 without NEE);
- the image-texture refusal raises NotImplementedError in both packages.
Scenes: tests/test_tlas.py's layout around the level-2 icosphere, and
two unique meshes instanced twice each (tests/torch_meshes.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.accel import tlas as jtlas  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch.accel import tlas  # noqa: E402
from parallelraytracing_tpu_torch.core.scene import globe_image  # noqa: E402
from torch_meshes import make_mesh, tlas_scene, two_mesh_scene  # noqa: E402

W, H = 32, 24
T_MIN, T_MAX = 1e-3, 1e16
FIELDS = ("t_min", "t_max", "t_miss", "t_inst", "inst_root", "inst_inv",
          "inst_nrm", "inst_mat", "b_min", "b_max", "b_miss", "b_tri", "v0",
          "v1", "v2", "n0", "n1", "n2")


def _scene(cls, name, instanced=True):
    if name == "ico2":
        return tlas_scene(cls, make_mesh("ico2"), instanced)
    return two_mesh_scene(cls, make_mesh("octa"), make_mesh("ico1"), instanced)


@pytest.fixture(scope="module", params=["ico2", "two_meshes"])
def levels(request):
    """(JAX TwoLevelBVH, port TwoLevelBVH, scene name)."""
    _, jtl = _scene(J.Scene, request.param).build_two_level()
    _, ttl = _scene(T.Scene, request.param).build_two_level("cpu")
    return jtl, ttl, request.param


def test_build_two_level_equal_jax(levels):
    jtl, ttl, _ = levels
    for f in FIELDS:
        ref = np.asarray(getattr(jtl, f))
        got = getattr(ttl, f).numpy()
        assert got.dtype == ref.dtype, f
        np.testing.assert_array_equal(got, ref, err_msg=f)
    assert ttl.num_instances == jtl.num_instances
    assert ttl.num_unique_triangles == jtl.num_unique_triangles


def test_tlas_intersect_and_resolve_match_jax(levels):
    jtl, ttl, _ = levels
    g = np.random.default_rng(4)
    n = 4096
    o = g.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ref = [np.asarray(x) for x in jax.jit(jtlas.tlas_intersect,
                                          static_argnums=(3, 4))(
        jtl, jnp.asarray(o), jnp.asarray(d), T_MIN, T_MAX)]
    got = tlas.tlas_intersect(ttl, torch.from_numpy(o), torch.from_numpy(d),
                              T_MIN, T_MAX)
    got = [x.numpy() for x in got]
    hit = ref[0] < 1e38
    assert hit.sum() > 100
    np.testing.assert_array_equal(got[0] < 1e38, hit)
    np.testing.assert_array_equal(got[1][hit], ref[1][hit])
    np.testing.assert_array_equal(got[2][hit], ref[2][hit])
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-6)
    for k in (3, 4):
        np.testing.assert_allclose(got[k][hit], ref[k][hit], rtol=0, atol=1e-5)
    rj = jtlas.resolve_instanced_hit(jtl, jnp.asarray(o), jnp.asarray(d),
                                     *[jnp.asarray(x) for x in ref])
    rt = tlas.resolve_instanced_hit(ttl, torch.from_numpy(o), torch.from_numpy(d),
                                    *[torch.from_numpy(x.copy()) for x in ref])
    for k, tol in ((0, 1e-5), (1, 1e-5)):
        np.testing.assert_allclose(rt[k].numpy()[hit], np.asarray(rj[k])[hit],
                                   rtol=0, atol=tol)
    for k in (2, 3):
        np.testing.assert_array_equal(rt[k].numpy()[hit], np.asarray(rj[k])[hit])


def _render(pkg, engine, scene, cfg):
    dev = () if pkg is J else ("cpu",)
    film = pkg.Film(W, H, *dev)
    r = pkg.create_renderer(engine, *dev)
    cam = jax_camera(W, H) if pkg is J else T.default_camera(W, H)
    r.init(film, scene, cam, pkg.RenderConfig(**cfg))
    r.progressive_render()
    return np.asarray(film.hdr_average()).reshape(-1, 3)


@pytest.mark.parametrize("name", ["ico2", "two_meshes"])
@pytest.mark.parametrize("nee", [False, True])
def test_tlas_ref_frame_matches_jax_and_baked_megakernel(name, nee):
    cfg = dict(width=W, height=H, max_depth=5, seed=5, nee=nee)
    ref = _render(J, "tlas_ref", _scene(J.Scene, name), cfg)
    got = _render(T, "tlas_ref", _scene(T.Scene, name), cfg)
    err = np.abs(got - ref).max(axis=1)
    assert (err <= 1e-5).mean() >= 0.999, err.max()
    baked = _render(T, "megakernel", _scene(T.Scene, name, instanced=False), cfg)
    assert float(np.sqrt(np.mean((got - baked) ** 2))) < 1e-3


def test_tlas_ref_without_instances_is_the_bvh_engine():
    cfg = dict(width=W, height=H, max_depth=4, seed=1)
    np.testing.assert_array_equal(
        _render(T, "tlas_ref", T.Scene(T.ScenePreset.MATERIAL_TEST), cfg),
        _render(T, "bvh", T.Scene(T.ScenePreset.MATERIAL_TEST), cfg))


def test_image_textures_on_instances_refused_by_both():
    cfg = dict(width=W, height=H, max_depth=2)
    for pkg, dev in ((J, ()), (T, ("cpu",))):
        s = pkg.Scene(preset=None)
        mat = s.add_textured_lambertian(s.add_texture(globe_image()))
        s.add_mesh_instances(make_mesh("octa"), mat, [None])
        r = pkg.create_renderer("tlas_ref", *dev)
        cam = jax_camera(W, H) if pkg is J else T.default_camera(W, H)
        with pytest.raises(NotImplementedError, match="image textures"):
            r.init(pkg.Film(W, H, *dev), s, cam, pkg.RenderConfig(**cfg))


def test_registry_has_every_jax_engine_but_sharded():
    """Since the port took ``sharded``, every JAX engine (the name is the
    test's from before)."""
    assert set(T.available_engines()) == set(J.available_engines())


@pytest.mark.parametrize("engine", ["bvh", "wavefront", "wavefront_bvh",
                                    "tlas_ref"])
def test_cli_renders_plain_engine(engine, tmp_path):
    from parallelraytracing_tpu_torch import cli
    out = tmp_path / f"{engine}.png"
    assert cli.main(["--device", "cpu", "--engine", engine, "--scene",
                     "material_test", "--width", "16", "--height", "12",
                     "--depth", "3", "--frames", "1", "--out", str(out)]) == 0
    assert out.stat().st_size > 0


def test_tlas_trace_matches_jax():
    """engines/tlas.tlas_trace on camera rays under one path key, against
    the JAX function (the tolerance of the frames)."""
    from parallelraytracing_tpu.engines import tlas as jeng
    from parallelraytracing_tpu.engines.megakernel import raygen as jraygen
    from parallelraytracing_tpu.accel.lbvh import build_bvh as jbuild

    from parallelraytracing_tpu_torch.accel.lbvh import build_bvh
    from parallelraytracing_tpu_torch.engines.tlas import tlas_trace
    from parallelraytracing_tpu_torch.ops import rng
    cfg = dict(width=W, height=H, max_depth=4, seed=0)
    jb, jtl = _scene(J.Scene, "two_meshes").build_two_level()
    tb, ttl = _scene(T.Scene, "two_meshes").build_two_level("cpu")
    o, d = jraygen(jnp.asarray(jax_camera(W, H).ray_params()),
                   jax.random.PRNGKey(1), W, H, True)
    ref = jeng.tlas_trace(jb, jbuild(jb), jtl, o, d, jax.random.PRNGKey(9),
                          J.RenderConfig(**cfg))
    got = tlas_trace(tb, build_bvh(tb), ttl, torch.from_numpy(np.array(o)),
                     torch.from_numpy(np.array(d)), rng.prng_key(9),
                     T.RenderConfig(**cfg))
    err = np.abs(got.numpy() - np.asarray(ref)).max(axis=1)
    assert (err <= 1e-5).mean() >= 0.999, err.max()
