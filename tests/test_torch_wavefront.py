"""The port's `wavefront` and `wavefront_bvh` engines against the JAX
package's on the CPU, and `wavefront` against the port's megakernel.

Tolerances:
- a frame of each engine against the JAX engine's, without and with NEE
  and Russian roulette, and with ray tiles smaller than the frame (one
  whole, one padded): every pixel within 1e-5 but at most one of the
  768 (measured: max 2.9e-6).  The one is RANDOM_BALLS_LARGE's pixel 79
  under `wavefront_bvh` where the JAX package runs on an AVX-512 Xeon
  with jax 0.9.0: the JAX raygen's direction differs from the port's in
  the last bit there (XLA's CPU rsqrt and norm round otherwise than
  IEEE float32), and
  the ray grazes sphere 607 at t = 50.43, so its diffuse path leaves
  the JAX one at bounce 3 (tests/test_torch_bvh.py's docstring has the
  measurement).  Fed the JAX raygen's bits, the frames are bit-equal;
  `wavefront`'s brute force rounds that hit so that it stays;
- `wavefront` against the port's `megakernel` when the frame is one ray
  tile: bit for bit (the JAX docstring's claim: both draw each path's
  numbers at its pixel under the same keys, and each ray's arithmetic is
  the same), on two frames of three scenes with and without NEE and
  roulette.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch.engines import wavefront  # noqa: E402

W, H = 32, 24
CASES = [("material_test", {}), ("cornell", dict(nee=True)),
         ("cornell", dict(russian_roulette_depth=2)),
         ("cornell", dict(nee=True, russian_roulette_depth=2)),
         ("random_balls_large", {}),
         ("material_test", dict(ray_tile=256)),
         ("random_balls_large", dict(ray_tile=500))]


def _render(pkg, engine, preset, cfg, frames=1):
    dev = () if pkg is J else ("cpu",)
    film = pkg.Film(W, H, *dev)
    r = pkg.create_renderer(engine, *dev)
    cam = jax_camera(W, H) if pkg is J else T.default_camera(W, H)
    r.init(film, pkg.Scene(pkg.ScenePreset(preset)), cam, pkg.RenderConfig(**cfg))
    for _ in range(frames):
        r.progressive_render()
    return np.asarray(film.hdr_average()).reshape(-1, 3)


@pytest.mark.parametrize("engine", ["wavefront", "wavefront_bvh"])
@pytest.mark.parametrize("preset,extra", CASES)
def test_frame_matches_jax(engine, preset, extra):
    cfg = dict(width=W, height=H, max_depth=6, seed=3, **extra)
    ref = _render(J, engine, preset, cfg)
    got = _render(T, engine, preset, cfg)
    err = np.abs(got - ref).max(axis=1)
    # at most one pixel of 768 off (the grazing ray of the docstring)
    assert (err > 1e-5).sum() <= 1, np.nonzero(err > 1e-5)[0]


@pytest.mark.parametrize("preset,extra", [
    ("material_test", {}), ("cornell", dict(nee=True, russian_roulette_depth=2)),
    ("random_balls_large", dict(samples_per_frame=2))])
def test_wavefront_bit_equal_megakernel_on_one_tile(preset, extra):
    cfg = dict(width=W, height=H, max_depth=8, seed=7, **extra)
    assert W * H <= T.RenderConfig().ray_tile
    np.testing.assert_array_equal(_render(T, "wavefront", preset, cfg, 2),
                                  _render(T, "megakernel", preset, cfg, 2))


def test_queue_counts_its_ray_segments():
    """The engine's own count: every queued path once per bounce, the
    first bounce's count the frame's rays."""
    wavefront.ray_segments[0] = 0
    _render(T, "wavefront", "material_test",
            dict(width=W, height=H, max_depth=1, seed=0))
    assert wavefront.ray_segments[0] == W * H
    wavefront.ray_segments[0] = 0
    _render(T, "wavefront", "material_test",
            dict(width=W, height=H, max_depth=4, seed=0))
    assert W * H < wavefront.ray_segments[0] < 4 * W * H
