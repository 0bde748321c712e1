"""The port's threaded BVH walk (accel/traverse.py) and the `bvh` engine
against the JAX package's on the CPU.

Tolerances:
- ``bvh_intersect_scene`` on 2,048 seeded rays (camera rays, random rays,
  and rays from the spheres' centres): kind, idx and front exactly, t
  within 1e-6 relative, the normal within 1e-5 (as
  tests/test_torch_megakernel.py holds ``intersect_scene``: the inline
  tests fuse their multiply-adds as XLA's CPU backend does; measured, t is
  bit-equal on every scene but the icosphere's, whose one sphere is off by
  under 1e-6 relative on 8 of 4,096 rays).
- The same rays against the port's brute-force ``intersect_scene``: hit,
  kind, idx and front exactly, t within 3e-4 relative (tests/test_bvh.py's
  bound on random rays: the two tests associate the sphere's quadratic
  differently; measured up to 1.1e-4 on a grazing ray of light_test), and
  within 2e-3 relative on the rays from the spheres' centres: the brute
  force expands |o - c|^2 as |o|^2 - 2 o.c + |c|^2, which cancels when o
  is the centre of a sphere far from the origin (measured 1.2e-3 on the
  random balls, whose radius-0.2 spheres lie ~10 units out).
- A `bvh` frame against the JAX `bvh` frame: every pixel within 1e-5
  but at most one of the 768 (measured: max 1.2e-6 with NEE).  The one
  is RANDOM_BALLS_LARGE's pixel 79 where the JAX package runs on an
  AVX-512 Xeon with jax 0.9.0 (measured there): the JAX raygen
  normalises through XLA's CPU ``rsqrt`` and ``jnp.linalg.norm``, which
  round otherwise than IEEE ``1 / sqrt`` and a sum of squares (the rsqrt
  alone on 388 of the 768 rays), so 683 of the 768 camera directions
  differ from the port's in the last bit; the port's equal float32 IEEE
  arithmetic bit for bit, as the CUDA kernels compute.
  Pixel 79's ray grazes sphere 607 at t = 50.43, where b^2 - c cancels
  (2600.70 - 2600.38), so 1 ulp of direction moves t by 3.4e-4 and the
  diffuse path leaves the JAX one at bounce 3 (3.5e-3 in the pixel).
  Its direction is the nearer of the two to the float64 value (1.9e-8
  against 5.0e-8); over the frame neither side is nearer (250 rays
  against 261).  Fed the JAX raygen's bits, the port's frame is
  bit-equal at all 768 pixels.  Against the port's
  megakernel frame, tests/test_bvh.py's bound: < 1% of pixels off by more
  than 1e-3, the means within 1e-3 relative (measured: equal).
- The animated engine at 32x24, depth 3 (tests/test_refit_live.py's
  scene): with ``refit=True`` within 1e-6 of a rebuild on the moved scene
  (measured: equal); with ``refit=False`` off by more than 0.1 somewhere.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.accel import lbvh as jlbvh  # noqa: E402
from parallelraytracing_tpu.accel import traverse as jtraverse  # noqa: E402
from parallelraytracing_tpu.core.camera import Camera as JCamera  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402
from parallelraytracing_tpu.ops import rays as jrays  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch.accel import lbvh, traverse  # noqa: E402
from parallelraytracing_tpu_torch.ops import intersect  # noqa: E402
from torch_meshes import make_mesh, stream_scene  # noqa: E402

T_MIN, T_MAX = 1e-3, 1e16
W, H = 32, 24
SCENES = ["material_test", "cornell", "default", "light_test",
          "random_balls_large", "texture_demo", "ico2"]

_jit_walk = jax.jit(jtraverse.bvh_intersect_scene, static_argnums=(4, 5))


def _scenes(name):
    if name == "ico2":
        mesh = make_mesh("ico2")
        return (stream_scene(J.Scene, mesh).build(),
                stream_scene(T.Scene, mesh).build("cpu"))
    return (J.Scene(J.ScenePreset(name)).build(),
            T.Scene(T.ScenePreset(name)).build("cpu"))


def _rays(scene, seed=1, n=2048):
    """W x H camera rays, random rays, and rays from the spheres' centres
    (their hits are back faces)."""
    g = np.random.default_rng(seed)
    o, d = jrays.generate_camera_rays(
        jnp.asarray(jax_camera(W, H).ray_params()), W, H, None, False)
    m = n - W * H
    ro = g.uniform(-6, 6, (m, 3)).astype(np.float32)
    ro[:, 1] = np.abs(ro[:, 1]) + 0.5
    c = scene.sph_center.numpy()[scene.sph_valid.numpy()][:64]
    ro[:len(c)] = c
    rd = g.normal(size=(m, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return (np.concatenate([np.asarray(o), ro]),
            np.concatenate([np.asarray(d), rd]))


@pytest.fixture(scope="module", params=SCENES)
def walked(request):
    """(port SceneData, o, d, JAX walk's hits, port walk's hits)."""
    js, ts = _scenes(request.param)
    o, d = _rays(ts)
    ref = _jit_walk(js, jlbvh.build_bvh(js), jnp.asarray(o), jnp.asarray(d),
                    T_MIN, T_MAX)
    got = traverse.bvh_intersect_scene(ts, lbvh.build_bvh(ts),
                                       torch.from_numpy(o),
                                       torch.from_numpy(d), T_MIN, T_MAX)
    return ts, o, d, ref, got


def test_walk_matches_jax(walked):
    _, _, _, ref, got = walked
    for f in ("kind", "idx", "front", "hit"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    rt, gt = np.asarray(ref.t), got.t.numpy()
    hit = np.isfinite(rt)
    assert np.array_equal(hit, np.isfinite(gt))
    err = np.abs(gt[hit] - rt[hit]) / np.abs(rt[hit])
    assert err.max(initial=0.0) <= 1e-6, err.max()
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(ref.normal),
                               rtol=0, atol=1e-5)
    assert got.hit.any()


def test_walk_matches_brute_force(walked):
    ts, o, d, _, got = walked
    bf = intersect.intersect_scene(ts, torch.from_numpy(o), torch.from_numpy(d),
                                   T_MIN, T_MAX, 64)
    for f in ("kind", "idx", "front", "hit"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(bf, f).numpy(), err_msg=f)
    inside = np.zeros(len(o), bool)  # the rays from the spheres' centres
    inside[W * H:W * H + min(64, int(ts.sph_valid.sum()))] = True
    for rows, rtol in ((~inside, 3e-4), (inside, 2e-3)):
        h = bf.hit.numpy() & rows
        np.testing.assert_allclose(got.t.numpy()[h], bf.t.numpy()[h],
                                   rtol=rtol)


def test_walk_counts_rounds_and_steps():
    """Each round is one host read; its steps are SUBSTEPS box tests."""
    _, ts = _scenes("random_balls_large")
    o, d = _rays(ts)
    traverse.walk_counts.update(walks=0, rounds=0, steps=0)
    traverse.bvh_intersect_scene(ts, lbvh.build_bvh(ts), torch.from_numpy(o),
                                 torch.from_numpy(d), T_MIN, T_MAX)
    c = traverse.walk_counts
    assert c["walks"] == 1 and c["rounds"] > 1
    assert c["steps"] == c["rounds"] * traverse.SUBSTEPS


def _render(pkg, engine, preset, cfg, frames=1):
    dev = () if pkg is J else ("cpu",)
    film = pkg.Film(W, H, *dev)
    r = pkg.create_renderer(engine, *dev)
    cam = jax_camera(W, H) if pkg is J else T.default_camera(W, H)
    r.init(film, pkg.Scene(pkg.ScenePreset(preset)), cam, pkg.RenderConfig(**cfg))
    for _ in range(frames):
        r.progressive_render()
    return np.asarray(film.hdr_average()).reshape(-1, 3)


FRAMES = [("material_test", {}), ("cornell", dict(nee=True)),
          ("cornell", dict(russian_roulette_depth=2)),
          ("random_balls_large", {})]


@pytest.mark.parametrize("preset,extra", FRAMES)
def test_bvh_frame_matches_jax(preset, extra):
    cfg = dict(width=W, height=H, max_depth=6, seed=3, **extra)
    ref = _render(J, "bvh", preset, cfg)
    got = _render(T, "bvh", preset, cfg)
    err = np.abs(got - ref).max(axis=1)
    # at most one pixel of 768 off (the grazing ray of the docstring)
    assert (err > 1e-5).sum() <= 1, np.nonzero(err > 1e-5)[0]


def test_bvh_trace_matches_jax():
    """engines/bvh.bvh_trace on camera rays under one path key, tiled (a
    ray tile of 256 of the 768 rays), against the JAX function."""
    from parallelraytracing_tpu.engines import bvh as jbvh
    from parallelraytracing_tpu.engines.megakernel import raygen as jraygen

    from parallelraytracing_tpu_torch.engines.bvh import bvh_trace
    from parallelraytracing_tpu_torch.ops import rng
    cfg = dict(width=W, height=H, max_depth=5, seed=0, ray_tile=256)
    js, ts = _scenes("random_balls_large")
    o, d = jraygen(jnp.asarray(jax_camera(W, H).ray_params()),
                   jax.random.PRNGKey(1), W, H, True)
    ref = jbvh.bvh_trace(js, jlbvh.build_bvh(js), o, d, jax.random.PRNGKey(5),
                         J.RenderConfig(**cfg))
    got = bvh_trace(ts, lbvh.build_bvh(ts), torch.from_numpy(np.array(o)),
                    torch.from_numpy(np.array(d)), rng.prng_key(5),
                    T.RenderConfig(**cfg))
    err = np.abs(got.numpy() - np.asarray(ref)).max(axis=1)
    assert (err <= 1e-5).mean() >= 0.999, err.max()


@pytest.mark.parametrize("preset", ["material_test", "random_balls_large"])
def test_bvh_frame_near_megakernel(preset):
    cfg = dict(width=W, height=H, max_depth=6, seed=2)
    mk = _render(T, "megakernel", preset, cfg)
    bvh = _render(T, "bvh", preset, cfg)
    assert (np.abs(mk - bvh).max(axis=1) > 1e-3).mean() < 0.01
    np.testing.assert_allclose(mk.mean(), bvh.mean(), rtol=1e-3)


# --------------------------------------------------------- animated refit

ANIM = dict(width=W, height=H, max_depth=3, seed=2)


def _anim_scene():
    """tests/test_refit_live.py's scene: two spheres over a ground quad."""
    s = T.Scene(preset=None)
    s.add_sphere(1.5, s.add_lambertian((0.9, 0.1, 0.1)),
                 ((1, 1, 1), (0, 0, 0), (-6, 1.5, 0)))
    s.add_sphere(1.0, s.add_lambertian((0.1, 0.1, 0.9)),
                 ((1, 1, 1), (0, 0, 0), (3, 1, -2)))
    s.add_quad(40, 40, s.add_lambertian((0.6, 0.6, 0.6)), None)
    return s


def _animate(scene, frame):
    """The red sphere 2.5 units along +x per frame."""
    dx = torch.zeros_like(scene.sph_center)
    dx[0, 0] = 2.5 * frame
    return dataclasses.replace(scene, sph_center=scene.sph_center + dx)


def _anim_camera():
    eye = np.array([0.0, 10.0, 18.0])
    return T.Camera(eye, np.array([0.0, 1.0, 0.0]) - eye, float(W), float(H),
                    100.0)


def _anim_render(refit, frame, rebuilt=False):
    film = T.Film(W, H, "cpu")
    r = T.create_renderer("bvh", "cpu")
    if not rebuilt:
        r.animate, r.refit = _animate, refit
    r.init(film, _anim_scene(), _anim_camera(), T.RenderConfig(**ANIM))
    if rebuilt:  # the moved scene and a tree built on it
        from parallelraytracing_tpu_torch.engines.bvh import make_bvh_intersector
        r._scene_data = _animate(r._scene_data, frame)
        r._bvh = lbvh.build_bvh(r._scene_data)
        r._intersect = make_bvh_intersector(r._bvh, r.config)
    r._frame_index = frame
    r.progressive_render()
    return film.hdr_average().numpy()


def test_animated_refit_matches_rebuild_and_stale_breaks():
    frame = 3  # the red sphere 7.5 units from where the tree was built
    oracle = _anim_render(None, frame, rebuilt=True)
    np.testing.assert_allclose(_anim_render(True, frame), oracle, rtol=0,
                               atol=1e-6)
    assert np.abs(_anim_render(False, frame) - oracle).max() > 0.1


def test_jax_animated_frame_matches_port():
    """The JAX engine's animate hook on the same scene and frame."""
    def j_animate(scene, frame):
        dx = jnp.zeros_like(scene.sph_center)
        dx = dx.at[0, 0].set(2.5 * frame.astype(jnp.float32))
        return dataclasses.replace(scene, sph_center=scene.sph_center + dx)

    s = J.Scene(preset=None)
    s.add_sphere(1.5, s.add_lambertian((0.9, 0.1, 0.1)),
                 ((1, 1, 1), (0, 0, 0), (-6, 1.5, 0)))
    s.add_sphere(1.0, s.add_lambertian((0.1, 0.1, 0.9)),
                 ((1, 1, 1), (0, 0, 0), (3, 1, -2)))
    s.add_quad(40, 40, s.add_lambertian((0.6, 0.6, 0.6)), None)
    eye = np.array([0.0, 10.0, 18.0])
    film = J.Film(W, H)
    r = J.create_renderer("bvh")
    r.animate = j_animate
    r.init(film, s, JCamera(eye, np.array([0.0, 1.0, 0.0]) - eye, float(W),
                            float(H), 100.0), J.RenderConfig(**ANIM))
    r._frame_index = 2
    r.progressive_render()
    ref = np.asarray(film.hdr_average()).reshape(-1, 3)
    got = _anim_render(True, 2).reshape(-1, 3)
    assert (np.abs(got - ref).max(axis=1) <= 1e-5).mean() >= 0.999


def test_walk_rounds_tool_counts_on_cpu(capsys):
    """benchmarks/walk_rounds.py on the CPU: its frames' counts, and more
    steps a round giving fewer rounds; SUBSTEPS restored."""
    import json

    from parallelraytracing_tpu_torch.benchmarks import walk_rounds
    kept = traverse.SUBSTEPS
    assert walk_rounds.main(["--device", "cpu", "--steps", "2", "8"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    two, eight = out["sweep"]
    assert two["steps"] == 2 * two["rounds"] and two["rounds"] > eight["rounds"]
    assert traverse.SUBSTEPS == kept
