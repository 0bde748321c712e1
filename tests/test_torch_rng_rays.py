"""The port's random streams and camera rays against the JAX package's.

PCG words and the threefry-derived frame seeds are integers: bit-equal
(tolerance 0).  Ray origins and directions are float32 from the same
formula; XLA on the CPU contracts multiply-adds into FMAs and rounds its
rsqrt differently, so directions agree within 2e-7 absolute (under two
float32 ulps of a unit vector's largest component)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402
from parallelraytracing_tpu.ops.pallas_trace import _pcg_hash, _uniform01  # noqa: E402
from parallelraytracing_tpu.ops.rays import \
    frame_stream_seeds as jax_frame_stream_seeds  # noqa: E402
from parallelraytracing_tpu.ops.rays import \
    generate_camera_rays_ids as jax_rays  # noqa: E402

from parallelraytracing_tpu_torch.core.camera import default_camera  # noqa: E402
from parallelraytracing_tpu_torch.ops import rays, rng  # noqa: E402

WORDS = np.random.default_rng(7).integers(0, 2**32, 4096, dtype=np.uint64
                                          ).astype(np.uint32)


def test_pcg_hash_bit_equal():
    ref = np.asarray(_pcg_hash(jnp.asarray(WORDS))).astype(np.int64)
    got = rng.pcg_hash(torch.from_numpy(WORDS.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("salt", range(1, 8))
def test_uniform01_bit_equal(salt):
    ref = np.asarray(_uniform01(jnp.asarray(WORDS), salt))
    got = rng.uniform01(torch.from_numpy(WORDS.astype(np.int64)), salt).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 1337])
def test_frame_stream_seeds_bit_equal(seed):
    for frame in (0, 1, 77):
        for sample in (0, 1):
            key = jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(seed), jnp.uint32(frame)),
                jnp.uint32(sample))
            jseed, path_seed = jax_frame_stream_seeds(key)
            got = rays.frame_stream_seeds(rays.sample_key(seed, frame, sample))
            assert got == (int(jseed), int(path_seed)), (seed, frame, sample)


@pytest.mark.parametrize("jitter", [True, False])
def test_camera_rays_match_jax(jitter):
    w, h = 96, 54
    params = jax_camera(w, h).ray_params()
    np.testing.assert_array_equal(default_camera(w, h).ray_params(), params)
    ids = np.random.default_rng(3).permutation(w * h).astype(np.int32)
    jo, jd = jax_rays(jnp.asarray(params), w, h, jnp.asarray(ids), None, jitter,
                      pix_seed=jnp.uint32(2024))
    o, d = rays.generate_camera_rays_ids(torch.from_numpy(params), w, h,
                                         torch.from_numpy(ids), jitter,
                                         pix_seed=2024)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=2e-7)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=2e-7)


def test_lens_and_qmc_raygen_raise():
    p = torch.from_numpy(default_camera(8, 8).ray_params())
    ids = torch.arange(64, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        rays.generate_camera_rays_ids(p, 8, 8, ids, False, lens=(0.1, 5.0))
    with pytest.raises(NotImplementedError):
        rays.generate_camera_rays_ids(p, 8, 8, ids, False, qpt=np.zeros(4))
