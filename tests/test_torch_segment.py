"""The port's segment kernel module and wavefront_fused engine against the
JAX package (``pallas_segment`` and ``wavefront_fused`` in Pallas
interpret mode; the port's plain PyTorch versions on the CPU).

The scenes are the mesh showcase scenes of tests/torch_meshes.py: the
octahedron (a linear-scan triangle kind) and the icosahedron at level 2
(320 triangles, the SAH tree).  Each test states its tolerance."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core.camera import Camera as JaxCamera  # noqa: E402
from parallelraytracing_tpu.core.scene import \
    ply_showcase_scene as jax_showcase  # noqa: E402
from parallelraytracing_tpu.engines.tables import \
    build_scene_tables as jax_engine_tables  # noqa: E402
from parallelraytracing_tpu.engines.wavefront_fused import \
    count_frame_rays as jax_count_rays  # noqa: E402
from parallelraytracing_tpu.ops.pallas_trace import (pack_lights_table,  # noqa: E402
                                                     pallas_segment)
from parallelraytracing_tpu.ops.pallas_trace import \
    pack_scene_tables as jax_pack  # noqa: E402
from parallelraytracing_tpu.ops.rays import \
    generate_camera_rays_ids as jax_rays  # noqa: E402

from torch_meshes import make_mesh, mesh_ply, write_ply  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch import convert  # noqa: E402
from parallelraytracing_tpu_torch.core.mesh import subdivide  # noqa: E402
from parallelraytracing_tpu_torch.core.scene import ply_showcase_scene  # noqa: E402
from parallelraytracing_tpu_torch.engines.tables import build_scene_tables  # noqa: E402
from parallelraytracing_tpu_torch.engines.wavefront_fused import (  # noqa: E402
    count_frame_rays, segment_lengths)
from parallelraytracing_tpu_torch.ops.segment import (PLANES, segment,  # noqa: E402
                                                      segment_reference,
                                                      segment_slots)

# Run the JAX package's computations inline in the dispatching thread.
# With asynchronous dispatch a JAX engine dispatches its next operation
# while a Pallas interpret-mode kernel still runs its host callbacks, and
# under load the two threads deadlock (the test then waits until the
# suite's time limit).  The flag is read when the CPU client is made, so
# it is set here, at collection, before any test computes.
jax.config.update("jax_cpu_enable_async_dispatch", False)


W = H = 32  # 1024 slots: one 8x128 Pallas tile
COUNT = 700  # live queue prefix; slots 700.. are dead
SEED = 424242


def _camera_rays(path, w, h, jitter=True):
    scene, eye, look = jax_showcase(path)
    eye, look = np.asarray(eye), np.asarray(look)
    cam = JaxCamera(eye, look - eye, float(w), float(h), 100.0)
    ids = np.random.default_rng(5).permutation(w * h).astype(np.int32)
    o, d = jax_rays(jnp.asarray(cam.ray_params()), w, h, jnp.asarray(ids),
                    None, jitter, pix_seed=jnp.uint32(987))
    return scene, ids, np.array(o), np.array(d)


@pytest.mark.parametrize("name", ["octa", "ico2"])
def test_segment_matches_pallas_segment(tmp_path, name):
    """One 2-bounce segment from camera rays, queue prefix COUNT of 1024,
    starting throughput and radiance random (radiance rides the state).
    Alive is equal on >= 99.5% of slots; every other plane agrees within
    1e-4 on >= 99% of slots (last-bit rounding differences of XLA and
    PyTorch can send a path elsewhere); dead slots (>= COUNT) keep their
    12 planes bit for bit, with alive 0, in both packages."""
    scene, ids, o, d = _camera_rays(mesh_ply(tmp_path, name), W, H)
    sd = scene.build()
    raw = jax_pack(sd, eye=None)[:7]
    sky = tuple(float(s) for s in np.asarray(sd.sky))
    rng = np.random.default_rng(9)
    r = W * H
    state = np.concatenate([o.T, d.T, rng.uniform(0.5, 1.0, (3, r)),
                            rng.uniform(0.0, 1.0, (3, r)),
                            np.ones((1, r))]).astype(np.float32)
    cfg = J.RenderConfig(width=W, height=H)
    planes, alive = pallas_segment(
        jnp.asarray(ids, jnp.float32), tuple(jnp.asarray(p) for p in state),
        *(jnp.asarray(a) for a in raw), jnp.asarray(pack_lights_table(sd)),
        jnp.asarray([SEED, 0, COUNT], jnp.int32), 8, 2, cfg.t_min, cfg.t_max,
        sky, interpret=True)
    ref = np.stack([np.asarray(p) for p in planes] + [np.asarray(alive)])

    t = convert.tables_from_numpy(*raw, sky, "cpu")
    got = segment_slots(
        torch.from_numpy(ids), torch.from_numpy(state),
        torch.tensor([SEED, 0, COUNT], dtype=torch.int32), t, cfg,
        n_bounces=2).numpy()
    assert got.shape == ref.shape == (PLANES, r)
    live = slice(0, COUNT)
    assert (got[12, live] == ref[12, live]).mean() >= 0.995
    for k in range(12):
        close = (np.abs(got[k, live] - ref[k, live]) <= 1e-4).mean()
        assert close >= 0.99, (k, close)
    assert 0 < got[12, live].sum() < COUNT  # some paths end, some go on
    for out in (got, ref):
        np.testing.assert_array_equal(out[:12, COUNT:], state[:12, COUNT:])
        assert not out[12, COUNT:].any()


def _render(engine, path, w, h, depth, frames=2, **attrs):
    scene, eye, look = ply_showcase_scene(path)
    eye, look = np.asarray(eye), np.asarray(look)
    cfg = T.RenderConfig(width=w, height=h, max_depth=depth, seed=3)
    film = T.Film(w, h, "cpu")
    r = T.create_renderer(engine, "cpu")
    for k, v in attrs.items():
        setattr(r, k, v)
    r.init(film, scene, T.Camera(eye, look - eye, float(w), float(h), 100.0),
           cfg)
    for _ in range(frames):
        r.progressive_render()
    return film.hdr_average().numpy(), r


@pytest.mark.parametrize("attrs", [
    dict(sort_rays="origin"), dict(sort_rays=""), dict(schedule=(2,)),
    dict(schedule=(1, 2, 4)), dict(segment=3, segment_first=1)])
def test_wavefront_fused_is_bit_invariant(tmp_path, attrs):
    """Tolerance 0: the film does not depend on the sort key or the
    segment schedule, and equals the fused engine's film (streams keyed on
    pixel and absolute depth; one shared bounce).  The reference run is
    the octant sort over the schedule (2, 4, d-6) = (2, 4, 2)."""
    path = mesh_ply(tmp_path, "ico2")
    ref, r = _render("wavefront_fused", path, 16, 12, 8, schedule=(2, 4, 2))
    assert r.segment_lengths() == [2, 4, 2]
    got, _ = _render("wavefront_fused", path, 16, 12, 8, **attrs)
    fused, _ = _render("fused", path, 16, 12, 8)
    assert np.array_equal(got, ref)
    assert np.array_equal(fused, ref)
    assert ref.mean() > 0


def test_wavefront_fused_film_matches_jax(tmp_path):
    """The slice end to end: JAX wavefront_fused (rows 8, Pallas interpret)
    and the port's on the showcase scene at 32x24, depth 4, 2 frames; >= 98%
    of pixels within 1e-4 and the mean within 1e-3 relative (the form of
    tests/test_torch_slice.py)."""
    path = mesh_ply(tmp_path, "octa")
    jscene, eye, look = jax_showcase(path)
    eye, look = np.asarray(eye), np.asarray(look)
    jcfg = J.RenderConfig(width=32, height=24, max_depth=4, seed=3)
    jfilm = J.Film(32, 24)
    jr = J.create_renderer("wavefront_fused")
    jr.rows = 8
    jr.init(jfilm, jscene, JaxCamera(eye, look - eye, 32.0, 24.0, 100.0), jcfg)
    for _ in range(2):
        jr.progressive_render()
    ref = np.asarray(jfilm.hdr_average())
    got, r = _render("wavefront_fused", path, 32, 24, 4)
    assert r.segment_lengths() == [3, 1]  # the JAX default, segment 3
    close = (np.abs(got - ref).max(-1) <= 1e-4).mean()
    assert close >= 0.98, close
    assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


def test_count_frame_rays_matches_jax(tmp_path):
    """Rays entering each bounce, summed over depth 3 at 32x24: within
    0.5% of the JAX count (a last-bit difference can end a path a bounce
    earlier or later)."""
    path = mesh_ply(tmp_path, "octa")
    scene, ids, o, d = _camera_rays(path, 32, 24)
    cfg = J.RenderConfig(width=32, height=24, max_depth=3)
    jt, _ = jax_engine_tables(scene, cfg)
    want = int(jax_count_rays(jt, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(ids, jnp.float32),
                              jnp.asarray([SEED], jnp.int32), 8, cfg,
                              interpret=True))
    tscene, _, _ = ply_showcase_scene(path)
    t, _ = build_scene_tables(tscene, "cpu")
    got = count_frame_rays(t, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(ids), SEED,
                           T.RenderConfig(width=32, height=24, max_depth=3))
    assert got >= 32 * 24 and abs(got - want) <= 0.005 * want, (got, want)


def test_schedule_defaults(tmp_path):
    """The JAX package's schedule rules: above 512 triangles a depth-20
    frame runs (2, 4, 14); a knob set before init wins."""
    assert segment_lengths(20, 3) == [3] * 6 + [2]
    assert segment_lengths(20, 5, schedule=(2, 4, 14)) == [2, 4, 14]
    assert segment_lengths(8, 3, schedule=(1, 2)) == [1, 2, 2, 2, 1]
    assert segment_lengths(6, 3, first_segment=1) == [1, 3, 2]
    heavy = write_ply(tmp_path / "ico3.ply", subdivide(make_mesh("ico2"), 1))
    scene, eye, look = ply_showcase_scene(heavy)
    assert len(scene._tri) == 1280
    for attrs, want in ((dict(), [2, 4, 14]), (dict(segment=4), [4] * 5)):
        r = T.create_renderer("wavefront_fused", "cpu")
        for k, v in attrs.items():
            setattr(r, k, v)
        r.init(T.Film(8, 8, "cpu"), scene, T.default_camera(8, 8),
               T.RenderConfig(width=8, height=8))
        assert r.segment_lengths() == want


def test_wavefront_fused_runs_nee_and_rr(tmp_path):
    """NEE and Russian roulette run in wavefront_fused on the CPU and give
    the fused engine's film, bit for bit (the showcase scene's sphere
    light; the tetrahedron is a tiny triangle kind); each changes the
    film.  Both versions of the segment take them; NEE without a light
    table raises."""
    path = mesh_ply(tmp_path, "tetra")
    films = {}
    for cfg_kw in (dict(), dict(nee=True), dict(russian_roulette_depth=2),
                   dict(nee=True, russian_roulette_depth=2)):
        scene, eye, look = ply_showcase_scene(path)
        eye, look = np.asarray(eye), np.asarray(look)
        got = []
        for engine in ("wavefront_fused", "fused"):
            film = T.Film(16, 12, "cpu")
            r = T.create_renderer(engine, "cpu")
            r.init(film, scene, T.Camera(eye, look - eye, 16.0, 12.0, 100.0),
                   T.RenderConfig(width=16, height=12, max_depth=6, seed=3,
                                  **cfg_kw))
            assert r._tables.nee == cfg_kw.get("nee", False)
            r.progressive_render()
            got.append(film.hdr_average())
        assert torch.equal(*got)
        films[tuple(cfg_kw)] = got[0]
    base = films[()]
    assert all(not torch.equal(base, f) for k, f in films.items() if k)
    t = r._tables  # the last renderer's: NEE on
    assert t.nee and t.tri_live
    args = (torch.zeros(4, dtype=torch.int32), torch.zeros((PLANES, 4)),
            torch.tensor([4], dtype=torch.int32), torch.zeros((4, 3)))
    kw = dict(seed=1, depth0=0, n_bounces=1)
    cfg = T.RenderConfig(max_depth=6, t_min=1e-3, t_max=1e16)
    for fn in (segment, segment_reference):
        assert fn(*args, dataclasses.replace(t, nee=False), cfg,
                  **kw)[0].shape == (PLANES, 4)
        assert fn(*args, t, cfg.replace(russian_roulette_depth=2),
                  **kw)[0].shape == (PLANES, 4)
    with pytest.raises(ValueError, match="light table"):
        dataclasses.replace(t, lights=t.lights[:-1].contiguous())


def test_schedule_follows_the_scene_on_reinit(tmp_path):
    """Re-initialising a renderer re-derives the scene's default schedule;
    a knob the user set between inits wins over it."""
    heavy, _, _ = ply_showcase_scene(
        write_ply(tmp_path / "ico3.ply", subdivide(make_mesh("ico2"), 1)))
    light, _, _ = ply_showcase_scene(mesh_ply(tmp_path, "octa"))
    cfg = T.RenderConfig(width=8, height=8)
    r = T.create_renderer("wavefront_fused", "cpu")
    for scene, attrs, want in ((heavy, {}, [2, 4, 14]),
                               (light, {}, [3] * 6 + [2]),
                               (heavy, dict(segment=4), [4] * 5)):
        for k, v in attrs.items():
            setattr(r, k, v)
        r.init(T.Film(8, 8, "cpu"), scene, T.default_camera(8, 8), cfg)
        assert r.segment_lengths() == want
