"""The adaptive engine and the film's slot accumulation against the JAX
package on the CPU.

The JAX adaptive engine is not rendered here: its frames run the Pallas
kernel in interpret mode, which is why tests/test_adaptive.py is marked
slow.  What both packages compute from the same numbers is held exactly:
the budget in slots, the selected slots from the same statistics (at
frames of two and three JAX tiles of 3,072 slots: below two tiles the
JAX rounding selects every slot), the Morton slot order against the JAX
engine's valid slots, and ``add_sample`` / ``add_sample_slots``.  The
port's own frames are held to the port: the warm-up films bit for bit to
the fused engine's, and an adaptive frame to ``trace_reference`` (the
trace wrapper's CPU path) of the selected ids added by
``add_sample_slots``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402
from parallelraytracing_tpu.engines import adaptive as jadaptive  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch.engines import adaptive  # noqa: E402
from parallelraytracing_tpu_torch.engines.tables import trace_tables  # noqa: E402


def _jax_engine(w, h, budget):
    """A JAX adaptive engine initialized (tables packed, nothing traced)."""
    jr = J.create_renderer("adaptive")
    jr.budget = budget
    jr.init(J.Film(w, h), J.Scene(J.ScenePreset.MATERIAL_TEST),
            jax_camera(w, h), J.RenderConfig(width=w, height=h, max_depth=2))
    return jr


def _port_engine(w, h, depth=2, warmup=4, engine="adaptive", budget=0.5,
                 preset="material_test", seed=5):
    film = T.Film(w, h, "cpu")
    r = T.create_renderer(engine, "cpu")
    if engine == "adaptive":
        r.warmup, r.budget = warmup, budget
    r.init(film, T.Scene(T.ScenePreset(preset)), T.default_camera(w, h),
           T.RenderConfig(width=w, height=h, max_depth=depth, seed=seed))
    return film, r


@pytest.mark.parametrize("w,h,budget", [(96, 64, 0.5), (100, 64, 0.3),
                                        (100, 64, 0.9), (100, 64, 1.0)])
def test_budget_and_selection_equal_jax(w, h, budget):
    jr = _jax_engine(w, h, budget)
    r = w * h
    assert adaptive.budget_slots(r, budget) == jr._budget_slots
    slots = int(jr._ids.shape[0])
    g = np.random.default_rng(int(budget * 10) + w)
    n = g.integers(1, 6, r).astype(np.float32)
    m1 = (g.uniform(0, 2, r) * n).astype(np.float32)
    m2 = (m1 * m1 / n * g.uniform(1, 3, r)).astype(np.float32)
    tie = g.choice(r, r // 8, replace=False)  # equal errors: the lower slot first
    m1[tie], m2[tie], n[tie] = m1[tie[0]], m2[tie[0]], n[tie[0]]
    n[g.choice(r, 16, replace=False)] = 0.0  # slots never sampled

    def pad(x):
        return jnp.asarray(np.concatenate([x, np.zeros(slots - r, np.float32)]))

    want = np.asarray(jadaptive._select_slots(pad(m1), pad(m2), pad(n), jr._valid,
                                              jr._budget_slots))
    got = adaptive.select_slots(torch.from_numpy(m1), torch.from_numpy(m2),
                                torch.from_numpy(n), adaptive.budget_slots(r, budget))
    np.testing.assert_array_equal(got.numpy(), want[want < r])
    assert (want[want >= r] >= r).all()  # the JAX engine's pad slots only


def test_morton_slots_are_the_jax_valid_slots():
    """The port's slots are the JAX engine's first H*W (valid) slots in the
    same order; the JAX layout appends its pad slots after them."""
    w, h = 100, 64
    jr = _jax_engine(w, h, 0.5)
    _, r = _port_engine(w, h)
    ids = np.asarray(jr._ids)
    np.testing.assert_array_equal(r._ids.numpy(), ids[:w * h])
    assert (ids[w * h:] >= w * h).all() and ids.shape[0] % (24 * 128) == 0
    np.testing.assert_array_equal(np.asarray(jr._valid)[:w * h], True)


def test_warmup_frames_equal_fused():
    film, r = _port_engine(32, 24, depth=3, warmup=2)
    ffilm, f = _port_engine(32, 24, depth=3, engine="fused")
    for _ in range(2):
        r.progressive_render()
        f.progressive_render()
    assert torch.equal(film.accum, ffilm.accum)
    assert torch.equal(film.weights, ffilm.weights)
    assert film.sample_count == ffilm.sample_count == 2
    assert torch.equal(r._n, torch.full_like(r._n, 2.0))


def test_adaptive_frame_is_trace_reference_of_the_selection():
    """After a warm-up frame, one adaptive frame at 96x64 (two JAX tiles:
    3,072 of 6,144 slots) adds the radiance of the selected ids, traced by
    the plain version, to exactly those slots and their statistics."""
    film, r = _port_engine(96, 64, warmup=1, preset="cornell")
    r.progressive_render()
    accum, weights = film.accum.clone(), film.weights.clone()
    m1, n = r._m1.clone(), r._n.clone()
    sel = adaptive.select_slots(r._m1, r._m2, r._n, r._budget_slots)
    assert sel.numel() == 3072 and bool((sel[1:] > sel[:-1]).all())
    o, d, s0 = r._sample_rays(r._ids[sel], 1, 0)
    rad = trace_tables(r._tables, o, d, r._ids[sel], s0, r.config)
    r.progressive_render()
    want = T.Film(96, 64, "cpu")
    want.set_layout(r.film_layout())
    want.accum, want.weights = accum, weights
    want.add_sample_slots(sel, rad, 1.0)
    assert torch.equal(film.accum, want.accum)
    assert torch.equal(film.weights, want.weights)
    touched = torch.zeros_like(n, dtype=torch.bool)
    touched[sel] = True
    assert torch.equal(r._n, n + touched.float())
    assert torch.equal(r._m1[~touched], m1[~touched])
    assert torch.equal(r._m1[sel], m1[sel] + adaptive.luma(rad))


@pytest.mark.parametrize("layout", [False, True])
def test_add_sample_slots_and_add_sample_equal_jax(layout):
    w, h = 12, 10
    g = np.random.default_rng(3)
    jf, tf = J.Film(w, h), T.Film(w, h, "cpu")
    if layout:
        inv = g.permutation(w * h).astype(np.int32)
        jf.set_layout((inv, w * h))
        tf.set_layout((inv, w * h))
    for _ in range(3):
        slots = g.integers(0, w * h, 50).astype(np.int32)  # with repeats
        rgb = g.uniform(0, 4, (50, 3)).astype(np.float32)
        jf.add_sample_slots(jnp.asarray(slots), jnp.asarray(rgb), 2.0)
        tf.add_sample_slots(torch.from_numpy(slots), torch.from_numpy(rgb), 2.0)
    for x, y in ((0, 0), (11, 9), (5, 3), (12, 0), (-1, 2)):
        jf.add_sample(x, y, (0.25, 0.5, 1.5), 3.0)
        tf.add_sample(x, y, (0.25, 0.5, 1.5), 3.0)
    np.testing.assert_array_equal(tf.accum.numpy(), np.asarray(jf.accum))
    np.testing.assert_array_equal(tf.weights.numpy(), np.asarray(jf.weights))
    np.testing.assert_array_equal(tf.hdr_average().numpy(),
                                  np.asarray(jf.hdr_average()))
    assert tf.sample_count == jf.sample_count == 3
