"""The trace's probes on the other walks, against the JAX package: the
linear cluster scan, NEE's shadow walks through instanced meshes and the
stream route's two-level walk; and the fused engine's depth_sort (the
cases and tolerances of tests/test_torch_probes.py, whose checks these
are).  On the stream route the JAX kernel defers the fold of a pending
chunk, so its best t can lag the port's and a box can pass for it that
fails for the port: its counters are at least the port's, and the
replay holds the invariants of
tests/test_pallas.py::test_collect_stats_counters."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402
from parallelraytracing_tpu.engines.fused import \
    FusedRenderer as JaxFused  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from test_torch_probes import (DEPTH, _run, check_radiance,  # noqa: E402
                               check_stats_exact, check_stats_nee)


def test_collect_stats_matches_pallas():
    """The octahedron's 8 triangles: the linear scan (a root pretest box
    and 2 cluster boxes)."""
    check_stats_exact("octa")
    assert tuple(_run("octa")["t"].tri_cl.shape) == (6, 3)


def test_collect_stats_with_nee():
    """The instanced scene's shadow walks cross the instances' mesh
    trees; the port's walks stop at an occluder, the JAX kernel's do not."""
    got, want = check_stats_nee("tlas_nee")
    assert got[:, 2].sum() > 0 and (got[:, 0] < want[:, 0]).any()


def test_collect_stats_stream():
    """The stream route (ico2 at threshold 64, chunks of 32): bounces
    equal and every counter at most the JAX kernel's, the replay's
    counters sane (nodes >= leaves, primitives >= leaves, 1 <= bounces <=
    depth) and the slots reached."""
    r = _run("stream")
    got, want = r["stats"][r["sel"]].numpy(), r["jstats"]
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    assert (got <= want).all()
    assert (got[:, 0] >= got[:, 1]).all() and (got[:, 2] >= got[:, 1]).all()
    assert ((got[:, 3] >= 1) & (got[:, 3] <= DEPTH)).all()
    assert got[:, 2].sum() > 0


@pytest.mark.parametrize("name", ["tlas_nee", "stream"])
def test_probes_leave_the_radiance_alone(name):
    check_radiance(name)


# ----------------------------------------------------------- depth_sort

DS_CFG = dict(width=64, height=32, max_depth=5, seed=2)


def _port_renderer(ds: int, camera=None):
    cfg = T.RenderConfig(**DS_CFG)
    film = T.Film(cfg.width, cfg.height, "cpu")
    r = T.create_renderer("fused", "cpu")
    r.depth_sort = ds
    r.init(film, T.Scene(T.ScenePreset.MATERIAL_TEST),
           camera or T.default_camera(cfg.width, cfg.height), cfg)
    return film, r


def _port_film(ds: int):
    film, r = _port_renderer(ds)
    for _ in range(2):
        r.progressive_render()
    return film.hdr_average(), r


def test_depth_sort_is_bit_invariant():
    """tests/test_pallas.py::test_depth_sort_is_bit_invariant on the
    port: depth_sort 1 (global) and 10 (block-local) render the films of
    depth_sort 0 bit for bit."""
    ref, r0 = _port_film(0)
    assert ref.mean() > 0
    for ds in (1, 10):
        film, r = _port_film(ds)
        assert torch.equal(film, ref), ds
        assert not torch.equal(r._ids, r0._ids)
        assert torch.equal(torch.sort(r._ids).values,
                           torch.arange(DS_CFG["width"] * DS_CFG["height"],
                                        dtype=r._ids.dtype))
        assert torch.equal(r._minv[r._ids.long()].long(),
                           torch.arange(r._ids.numel()))


@pytest.mark.parametrize("ds", [1, 10])
def test_depth_sort_order_equals_jax(ds):
    """After the probe frame the port's pixel ids are in the JAX engine's
    order, its pad ids removed."""
    cfg = J.RenderConfig(**DS_CFG)
    jr = JaxFused.__new__(JaxFused)
    jr.rows = 8
    jr.depth_sort = ds
    jr.init(J.Film(cfg.width, cfg.height), J.Scene(J.ScenePreset.MATERIAL_TEST),
            jax_camera(cfg.width, cfg.height), cfg)
    want = np.asarray(jr._ids)
    want = want[want < cfg.width * cfg.height]
    _, r = _port_film(ds)
    np.testing.assert_array_equal(r._ids.numpy(), want)


def test_depth_sort_reprobes_when_the_eye_moves():
    """set_camera with a new eye re-probes: the ids (re-sorted from their
    current order, as the JAX engine re-sorts) equal the JAX engine's after
    the same move, its pad ids removed, and the film, holding a frame from
    the old layout, goes on equal to depth_sort 0's."""
    eye = np.array([3.0, 4.0, 9.0])
    w, h = DS_CFG["width"], DS_CFG["height"]
    films = []
    for ds in (0, 1):
        film, r = _port_renderer(ds)
        r.progressive_render()
        ids = r._ids.clone()
        r.set_camera(T.Camera(eye, -eye, w, h, 100.0))
        r.progressive_render()
        films.append(film.hdr_average())
    assert not torch.equal(r._ids, ids)
    assert torch.equal(r._minv[r._ids.long()].long(),
                       torch.arange(r._ids.numel()))
    assert films[1].mean() > 0 and torch.equal(films[1], films[0])
    cfg = J.RenderConfig(**DS_CFG)
    jr = JaxFused.__new__(JaxFused)
    jr.rows = 8
    jr.depth_sort = 1
    jr.init(J.Film(w, h), J.Scene(J.ScenePreset.MATERIAL_TEST),
            jax_camera(w, h), cfg)
    jr.set_camera(J.Camera(eye, -eye, w, h, 100.0))
    want = np.asarray(jr._ids)
    np.testing.assert_array_equal(r._ids.numpy(), want[want < w * h])
