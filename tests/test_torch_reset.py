"""A camera move on both packages: ``set_camera``, ``reset_progressive``
and ``Film.clear`` (the viewer's steps after each move), against a fresh
renderer on the new camera.

Tolerances:
- right after the reset: the adaptive engine's sums _m1, _m2, _n are zero
  and ``frame_index`` is 0, in both packages;
- the frames after it: the film (accum, weights, sample count) and the
  adaptive statistics bit-equal to those of a fresh renderer on the new
  camera, in each package (the same streams: frame keys restart at 0);
- the port against the JAX engine under the same steps: the sample
  counts _n equal, _m1 and _m2 within 1e-5 on >= 99.9% of the slots (the
  fused kernel's tolerance against the JAX kernel, which the adaptive
  statistics sum; tests/test_torch_adaptive.py holds the rest exactly).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402

# JAX's engines dispatch synchronously here: the JAX adaptive engine runs
# the Pallas kernel in interpret mode (see tests/test_torch_slice.py)
jax.config.update("jax_cpu_enable_async_dispatch", False)

W, H = 32, 24
WARMUP, BEFORE, AFTER = 2, 4, 3
CFG = dict(width=W, height=H, max_depth=2, seed=4)
EYE0, EYE1 = (5.0, 5.0, 8.0), (-6.0, 3.0, 7.0)


def _camera(pkg, eye):
    eye = np.asarray(eye, np.float64)
    return pkg.Camera(eye, -eye, float(W), float(H), 100.0)


def _engine(pkg, name, eye):
    dev = () if pkg is J else ("cpu",)
    film = pkg.Film(W, H, *dev)
    r = pkg.create_renderer(name, *dev)
    if name == "adaptive":
        r.warmup = WARMUP
    r.init(film, pkg.Scene(pkg.ScenePreset.MATERIAL_TEST), _camera(pkg, eye),
           pkg.RenderConfig(**CFG))
    return film, r


def _stats(r):
    return [np.array(x)[:W * H] for x in (r._m1, r._m2, r._n)]


def _moved(pkg, name):
    """The engine after BEFORE frames, a camera move, the reset and
    AFTER frames; the statistics right after the reset."""
    film, r = _engine(pkg, name, EYE0)
    for _ in range(BEFORE):
        r.progressive_render()
    r.set_camera(_camera(pkg, EYE1))
    r.reset_progressive()
    film.clear()
    assert r.frame_index == 0 and film.sample_count == 0
    reset = _stats(r) if name == "adaptive" else None
    for _ in range(AFTER):
        r.progressive_render()
    return film, r, reset


@pytest.fixture(scope="module", params=[J, T], ids=["jax", "port"])
def adaptive_moved(request):
    pkg = request.param
    return pkg, _moved(pkg, "adaptive"), _engine(pkg, "adaptive", EYE1)


def test_adaptive_reset_zeroes_statistics(adaptive_moved):
    _, (_, r, reset), _ = adaptive_moved
    for x in reset:
        assert not x.any()
    assert r.frame_index == AFTER


def test_adaptive_after_reset_equals_fresh_renderer(adaptive_moved):
    _, (film, r, _), (ffilm, fresh) = adaptive_moved
    for _ in range(AFTER):
        fresh.progressive_render()
    np.testing.assert_array_equal(np.asarray(film.accum), np.asarray(ffilm.accum))
    np.testing.assert_array_equal(np.asarray(film.weights),
                                  np.asarray(ffilm.weights))
    assert film.sample_count == ffilm.sample_count == AFTER
    for a, b in zip(_stats(r), _stats(fresh)):
        np.testing.assert_array_equal(a, b)
    assert r.frame_index > r.warmup  # the last frame was an adaptive one


def test_adaptive_reset_agrees_with_jax():
    _, jr, _ = _moved(J, "adaptive")
    _, tr, _ = _moved(T, "adaptive")
    jm1, jm2, jn = _stats(jr)
    tm1, tm2, tn = _stats(tr)
    np.testing.assert_array_equal(tn, jn)
    for a, b in ((tm1, jm1), (tm2, jm2)):
        assert (np.abs(a - b) <= 1e-5).mean() >= 0.999, np.abs(a - b).max()


@pytest.mark.parametrize("pkg,name", [(J, "bvh"), (T, "bvh"), (T, "fused"),
                                      (T, "wavefront")])
def test_reset_restarts_the_frame_sequence(pkg, name):
    film, r, _ = _moved(pkg, name)
    ffilm, fresh = _engine(pkg, name, EYE1)
    for _ in range(AFTER):
        fresh.progressive_render()
    np.testing.assert_array_equal(np.asarray(film.accum), np.asarray(ffilm.accum))
    np.testing.assert_array_equal(np.asarray(film.weights),
                                  np.asarray(ffilm.weights))
