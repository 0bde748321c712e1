"""The port's last public functions against their JAX counterparts:
``engines/megakernel.render_frame``, ``engines/tracer.count_bounce_rays``,
``core/geometry.transform_vector`` and ``aabb_union``.

Tolerances:
- ``render_frame``: bit-equal to the port's megakernel engine's frame of
  the same key (it is that engine's loop in one call), and on
  MATERIAL_TEST, where the port's megakernel is bit-equal to the JAX one,
  bit-equal to the JAX ``render_frame`` (one sample and two);
- ``count_bounce_rays``: the exact count, on MATERIAL_TEST and CORNELL, a
  frame of 768 rays in tiles of 512 (the last tile padded with dummy rays
  and pro-rated);
- the geometry: exact (the same float64 numpy arithmetic).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core import geometry as jgeo  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402
from parallelraytracing_tpu.engines import megakernel as jmk  # noqa: E402
from parallelraytracing_tpu.engines import tracer as jtracer  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
import torch_meshes  # noqa: E402,F401  (one PyTorch thread a worker)
from parallelraytracing_tpu_torch.core import geometry  # noqa: E402
from parallelraytracing_tpu_torch.engines import megakernel, tracer  # noqa: E402
from parallelraytracing_tpu_torch.ops import rng  # noqa: E402

W, H = 32, 24


@pytest.mark.parametrize("spp", [1, 2])
def test_render_frame_matches_jax_and_the_engine(spp):
    kw = dict(width=W, height=H, max_depth=4, seed=3, samples_per_frame=spp,
              ray_tile=500)
    cfg, jcfg = T.RenderConfig(**kw), J.RenderConfig(**kw)
    scene = T.Scene(T.ScenePreset.MATERIAL_TEST)
    cam = T.default_camera(W, H).ray_params()
    key = rng.fold_in(rng.prng_key(cfg.seed), 1)  # frame 1's key
    got = megakernel.render_frame(scene.build("cpu"), torch.from_numpy(cam),
                                  key, cfg).numpy()
    r = T.create_renderer("megakernel", "cpu")
    r.init(T.Film(W, H, "cpu"), scene, T.default_camera(W, H), cfg)
    np.testing.assert_array_equal(got, r.render_sample_buffer(1).numpy())
    ref = np.asarray(jmk.render_frame(
        J.Scene(J.ScenePreset.MATERIAL_TEST).build(),
        jnp.asarray(jax_camera(W, H).ray_params()),
        jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 1), jcfg))
    assert got.shape == ref.shape == (W * H, 3) and ref.mean() > 0
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("preset", ["material_test", "cornell"])
def test_count_bounce_rays_exact(preset):
    kw = dict(width=W, height=H, max_depth=6, ray_tile=512)
    cfg, jcfg = T.RenderConfig(**kw), J.RenderConfig(**kw)
    got = tracer.count_bounce_rays(
        T.Scene(T.ScenePreset(preset)).build("cpu"),
        torch.from_numpy(T.default_camera(W, H).ray_params()),
        rng.prng_key(9), cfg)
    ref = jtracer.count_bounce_rays(
        J.Scene(J.ScenePreset(preset)).build(),
        jnp.asarray(jax_camera(W, H).ray_params()), jax.random.PRNGKey(9),
        jcfg)
    assert isinstance(got, float) and got >= W * H
    assert got == ref


def test_transform_vector_and_aabb_union_exact():
    g = np.random.default_rng(4)
    for _ in range(8):
        m = jgeo.make_transform(g.uniform(0.2, 3, 3), g.uniform(-180, 180, 3),
                                g.uniform(-5, 5, 3))
        v = g.normal(size=3)
        np.testing.assert_array_equal(geometry.transform_vector(m, v),
                                      jgeo.transform_vector(m, v))
        np.testing.assert_array_equal(geometry.transform_vector(m, list(v)),
                                      jgeo.transform_vector(m, list(v)))
    a, b = g.normal(size=(2, 5, 3)), g.normal(size=(2, 5, 3))
    lo_a, hi_a = np.minimum(*a), np.maximum(*a)
    lo_b, hi_b = np.minimum(*b), np.maximum(*b)
    for got, want in zip(geometry.aabb_union(lo_a, hi_a, lo_b, hi_b),
                         jgeo.aabb_union(lo_a, hi_a, lo_b, hi_b)):
        np.testing.assert_array_equal(got, want)
