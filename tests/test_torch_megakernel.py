"""The megakernel engine and the modules it stands on, against the JAX
package's jnp code on the CPU.

Tolerances:
- threefry: ``random_bits`` and ``uniform`` bit for bit, and ``fold_in``
  / ``split`` of key tensors exactly.  ``normal`` copies XLA's float32
  ``erf_inv`` polynomial and its log1p and log; about 15 draws in a
  million differ by 1-2 ulps (a last-ulp difference of XLA's CPU log),
  so the test holds at most 1e-4 of draws to 2 ulps and the rest exact.
- ``intersect_scene``: kind and idx exactly, t and pos within 1e-6
  relative (the port fuses the multiply-adds of its dot and cross products
  as XLA's CPU backend does; without that a grazing sphere hit's t moved
  by up to 1e-4 relative), the normal within 1e-5: XLA fuses o + t d in
  some of its fusions and not in others, so the hit point can differ by an
  ulp, and a sphere's normal divides it by the radius (0.2 on the random
  balls: up to 4.8e-6 measured).
- ``scatter``, ``sample_light``, ``sky_radiance`` within 1e-6 and the
  full-frame raygen within 2e-7 (as tests/test_torch_rng_rays holds the
  pixel-keyed raygen; a lens's origin, the eye moved on the aperture,
  within 2e-7 relative: an ulp of a coordinate near 5).
- ``trace_paths`` and a ``megakernel`` frame: >= 99.9% of rays within
  1e-5.  MATERIAL_TEST, CORNELL with NEE and with roulette agree on every
  ray (max 3.6e-7).  On sky_demo the rays that see the sun of power 256
  move by up to 2.4e-4 (7.4e-5 relative): a last-bit difference of a
  reflected direction (XLA's rsqrt and fused multiply-adds against the
  port's) multiplied 256-fold, as Queue 3 records for the kernels: there
  98.6% of rays are within 1e-5 and all within 1e-4 relative, the bound
  tests/test_torch_textures.py holds them to.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402
from parallelraytracing_tpu.engines import tracer as jtracer  # noqa: E402
from parallelraytracing_tpu.ops import intersect as jint  # noqa: E402
from parallelraytracing_tpu.ops import materials as jmat  # noqa: E402
from parallelraytracing_tpu.ops import nee as jnee  # noqa: E402
from parallelraytracing_tpu.ops import rays as jrays  # noqa: E402
from parallelraytracing_tpu.ops import sky as jsky  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch.engines import tracer  # noqa: E402
from parallelraytracing_tpu_torch.ops import intersect, materials, nee, rays, rng  # noqa: E402
from parallelraytracing_tpu_torch.ops import sky  # noqa: E402
from torch_meshes import make_mesh, stream_scene  # noqa: E402

W, H = 32, 24
SCENES = ["default", "light_test", "material_test", "cornell",
          "random_balls_small", "random_balls_medium", "random_balls_large",
          "texture_demo", "sky_demo", "ico2"]


def _scenes(name):
    """(JAX SceneData, port SceneData) of a preset or the level-2
    icosphere's scene (tests/torch_meshes.stream_scene)."""
    if name == "ico2":
        mesh = make_mesh("ico2")
        return (stream_scene(J.Scene, mesh).build(),
                stream_scene(T.Scene, mesh).build("cpu"))
    return (J.Scene(J.ScenePreset(name)).build(),
            T.Scene(T.ScenePreset(name)).build("cpu"))


def _rays(seed, n=W * H):
    """Camera rays of the default camera plus random rays from a numpy
    seed (origins in a box around the scenes, unit directions)."""
    g = np.random.default_rng(seed)
    o, d = jrays.generate_camera_rays(jnp.asarray(jax_camera(W, H).ray_params()),
                                      W, H, None, False)
    ro = g.uniform(-6, 6, (n, 3)).astype(np.float32)
    ro[:, 1] = np.abs(ro[:, 1]) + 0.5
    rd = g.normal(size=(n, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return (np.concatenate([np.asarray(o), ro]),
            np.concatenate([np.asarray(d), rd]))


def _close(got, ref, rtol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got)), what
    err = np.abs(got[fin] - ref[fin]) / np.maximum(np.abs(ref[fin]), 1.0)
    assert err.max(initial=0.0) <= rtol, (what, err.max())


_jit_intersect = jax.jit(jint.intersect_scene, static_argnums=(3, 4, 5))


# --------------------------------------------------------------- threefry

@pytest.mark.parametrize("seed", [0, 7, 1337])
def test_threefry_keys_bits_and_uniform_bit_equal(seed):
    key = jax.random.PRNGKey(seed)
    host = rng.prng_key(seed)
    kt = torch.tensor(host)
    data = np.random.default_rng(seed).integers(0, 2**32, 64, dtype=np.uint64)
    ref = np.stack([np.asarray(jax.random.fold_in(key, int(x))) for x in data[:8]])
    got = rng.fold_in_t(kt, torch.from_numpy(data[:8].astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    ref = np.asarray(jax.random.split(key, 3)).astype(np.int64)
    np.testing.assert_array_equal(torch.stack(rng.split_t(kt, 3)).numpy(), ref)
    for shape in [(5,), (3, 7), (2, 33, 3)]:
        ref = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(rng.random_bits(host, shape).numpy(), ref)
        ref = np.asarray(jax.random.uniform(key, shape))
        got = rng.uniform(host, shape).numpy()
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_normal_within_stated_ulps():
    key = jax.random.PRNGKey(42)
    ref = np.asarray(jax.random.normal(key, (1 << 18,)))
    got = rng.normal(rng.prng_key(42), (1 << 18,)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - ref.view(np.int32).astype(np.int64))
    assert (ulps != 0).mean() <= 1e-4, (ulps != 0).sum()
    assert ulps.max() <= 2
    ref = np.asarray(jmat.random_unit_vectors(jax.random.PRNGKey(3), 4096))
    got = materials.random_unit_vectors(rng.prng_key(3), 4096).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ----------------------------------------------------------- intersection

@pytest.mark.parametrize("name", SCENES)
def test_intersect_scene_matches_jax(name):
    js, ts = _scenes(name)
    o, d = _rays(1)
    ref = _jit_intersect(js, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e16, 256)
    got = intersect.intersect_scene(ts, torch.from_numpy(o), torch.from_numpy(d),
                                    1e-3, 1e16, 256)
    np.testing.assert_array_equal(got.kind.numpy(), np.asarray(ref.kind))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(ref.mat))
    np.testing.assert_array_equal(got.front.numpy(), np.asarray(ref.front))
    assert np.asarray(ref.hit).mean() > 0.2
    for f, tol in (("t", 1e-6), ("pos", 1e-6), ("normal", 1e-5)):
        _close(getattr(got, f).numpy(), getattr(ref, f), tol, f)
    if ref.uv is not None:
        _close(got.uv.numpy(), ref.uv, 1e-6, "uv")


def test_intersect_chunks_and_ties():
    """A chunk smaller than the kinds (several chunks, a padded last one)
    gives the same hits; two coincident spheres tie at equal t and the
    lower ordinal wins, as in the JAX fold."""
    js, ts = _scenes("random_balls_small")
    o, d = _rays(2, 256)
    ref = _jit_intersect(js, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e16, 7)
    got = intersect.intersect_scene(ts, torch.from_numpy(o), torch.from_numpy(d),
                                    1e-3, 1e16, 7)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    scenes = []
    for cls in (J.Scene, T.Scene):
        s = cls(preset=None)
        m = s.add_lambertian((0.5, 0.5, 0.5))
        for _ in range(3):
            s.add_sphere(1.0, m, ((1, 1, 1), (0, 0, 0), (0, 0, -5)))
        scenes.append(s)
    o = np.zeros((4, 3), np.float32)
    d = np.tile(np.array([[0, 0, -1]], np.float32), (4, 1))
    ref = _jit_intersect(scenes[0].build(), jnp.asarray(o), jnp.asarray(d),
                         1e-3, 1e16, 2)
    got = intersect.intersect_scene(scenes[1].build("cpu"), torch.from_numpy(o),
                                    torch.from_numpy(d), 1e-3, 1e16, 2)
    assert (got.idx.numpy() == 0).all()
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))


# ------------------------------------------------ sky, BSDFs, light sampling

@pytest.mark.parametrize("name", ["material_test", "sky_demo"])
def test_sky_radiance_matches_jax(name):
    js, ts = _scenes(name)
    d = np.random.default_rng(5).normal(size=(512, 3)).astype(np.float32) * 3
    ref = np.asarray(jsky.sky_radiance(js, jnp.asarray(d)))
    got = sky.sky_radiance(ts, torch.from_numpy(d)).numpy()
    _close(got, ref, 1e-6, "sky")


@pytest.mark.parametrize("name", ["material_test", "texture_demo", "ico2"])
def test_scatter_matches_jax(name):
    js, ts = _scenes(name)
    o, d = _rays(3)
    jh = _jit_intersect(js, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e16, 256)
    th = intersect.intersect_scene(ts, torch.from_numpy(o), torch.from_numpy(d),
                                   1e-3, 1e16, 256)
    # the port's hits, given to both (the intersection test holds them)
    jh = jint.HitRecord(*[jnp.asarray(getattr(th, f).numpy())
                          if getattr(th, f) is not None else None
                          for f in ("t", "hit", "pos", "normal", "front", "mat",
                                    "kind", "idx", "uv")])
    g = np.random.default_rng(4)
    unit = g.normal(size=o.shape)
    unit = (unit / np.linalg.norm(unit, axis=1, keepdims=True)).astype(np.float32)
    uni = g.uniform(size=o.shape[0]).astype(np.float32)
    ref = jax.jit(jmat.scatter)(js, jnp.asarray(d), jh, jnp.asarray(unit),
                                jnp.asarray(uni))
    got = materials.scatter(ts, torch.from_numpy(d), th, torch.from_numpy(unit),
                            torch.from_numpy(uni))
    _close(got[0].numpy(), ref[0], 1e-6, "dir")
    _close(got[1].numpy(), ref[1], 1e-6, "attenuation")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    _close(materials.surface_albedo(ts, th).numpy(),
           jmat.surface_albedo(js, jh), 1e-6, "albedo")
    _close(materials.emitted(ts, th.mat).numpy(), jmat.emitted(js, jh.mat), 0,
           "emitted")


@pytest.mark.parametrize("name", ["cornell", "random_balls_large"])
def test_sample_light_matches_jax(name):
    js, ts = _scenes(name)
    jl = jnee.extract_lights(js)
    tl = nee.extract_lights(ts.numpy()).to("cpu")
    g = np.random.default_rng(6)
    p = g.uniform(-4, 4, (2048, 3)).astype(np.float32)
    p[:, 1] = np.abs(p[:, 1])
    u3 = g.uniform(size=(2048, 3)).astype(np.float32)
    ref = jax.jit(jnee.sample_light)(jl, jnp.asarray(p), jnp.asarray(u3))
    got = nee.sample_light(tl, torch.from_numpy(p), torch.from_numpy(u3))
    for i in (2, 3, 4):  # valid, kind, idx
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    _close(got[0].numpy(), ref[0], 1e-6, "wi")
    _close(got[5].numpy(), ref[5], 0, "emit")
    pdf, rpdf = got[1].numpy(), np.asarray(ref[1])
    np.testing.assert_allclose(pdf, rpdf, rtol=1e-6)


@pytest.mark.parametrize("lens", [None, (0.2, 6.0)])
def test_full_frame_raygen_matches_jax(lens):
    params = jax_camera(W, H).ray_params()
    key = rng.prng_key(9)
    for jitter in (True, False):
        jo, jd = jrays.generate_camera_rays(jnp.asarray(params), W, H,
                                            jax.random.PRNGKey(9), jitter,
                                            lens=lens)
        o, d = rays.generate_camera_rays(torch.from_numpy(params), W, H, key,
                                         jitter, lens=lens)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-7, atol=2e-7)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=2e-7)
    jo, jd = jrays.generate_camera_rays(jnp.asarray(params), W, H, None, True,
                                        lens=lens, pix_seed=jnp.uint32(77),
                                        qpt=jnp.asarray(rays.halton_qpt(5)))
    o, d = rays.generate_camera_rays(torch.from_numpy(params), W, H, None, True,
                                     lens=lens, pix_seed=77,
                                     qpt=rays.halton_qpt(5))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=2e-7)


# --------------------------------------------------------------- the paths

def _path_check(got, ref, sun=False):
    err = np.abs(got - ref).max(axis=1)
    close = (err <= 1e-5).mean()
    if sun:  # the sun's rays (module doc)
        rel = err / np.maximum(np.abs(ref).max(axis=1), 1e-6)
        assert close >= 0.98 and rel.max() <= 1e-4, (close, rel.max())
    else:
        assert close >= 0.999, (close, err.max())


@pytest.mark.parametrize("name,kw", [
    ("material_test", {}),
    ("cornell", dict(nee=True)),
    ("cornell", dict(russian_roulette_depth=2)),
    ("ico2", dict(nee=True, russian_roulette_depth=1)),
    ("texture_demo", {}),
])
def test_trace_paths_matches_jax(name, kw):
    js, ts = _scenes(name)
    jcfg = J.RenderConfig(width=W, height=H, max_depth=4, **kw)
    cfg = T.RenderConfig(width=W, height=H, max_depth=4, **kw)
    jl = jnee.extract_lights(js) if cfg.nee else None
    tl = nee.extract_lights(ts.numpy()).to("cpu") if cfg.nee else None
    params = jax_camera(W, H).ray_params()
    o, d = rays.generate_camera_rays(torch.from_numpy(params), W, H,
                                     rng.prng_key(1), True)
    ref = np.asarray(jax.jit(jtracer.trace_paths, static_argnums=(4,))(
        js, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jax.random.PRNGKey(2), jcfg, None, jl))
    got = tracer.trace_paths(ts, o, d, rng.prng_key(2), cfg, lights=tl).numpy()
    assert ref.mean() > 0
    _path_check(got, ref)


@pytest.mark.parametrize("name,depth,kw", [
    ("material_test", 4, dict(samples_per_frame=2, ray_tile=500)),
    ("cornell", 4, dict(nee=True)),
    ("cornell", 4, dict(lens_radius=0.1, focus_distance=8.0, qmc=True)),
    ("sky_demo", 2, {}),
])
def test_megakernel_frame_matches_jax(name, depth, kw):
    """One frame of the engine: the tiled streams (several tiles, a short
    last one, under ray_tile=500), two samples a frame, NEE, the lens under
    QMC, and the gradient and sun sky (at depth 2, where a ray sees the sun
    after one bounce; a third bounce compounds the sun's amplification, up
    to 4.5e-3 relative on one ray of 768 at depth 3)."""
    jcfg = J.RenderConfig(width=W, height=H, max_depth=depth, seed=3, **kw)
    cfg = T.RenderConfig(width=W, height=H, max_depth=depth, seed=3, **kw)
    jr = J.create_renderer("megakernel")
    jr.init(J.Film(W, H), J.Scene(J.ScenePreset(name)), jax_camera(W, H), jcfg)
    r = T.create_renderer("megakernel", "cpu")
    r.init(T.Film(W, H, "cpu"), T.Scene(T.ScenePreset(name)),
           T.default_camera(W, H), cfg)
    ref = np.asarray(jr.render_sample_buffer(1))
    got = r.render_sample_buffer(1).numpy()
    assert ref.mean() > 0
    _path_check(got, ref, sun=name == "sky_demo")


def test_tile_streams_are_the_jax_tiling():
    """Tile t of the rays draws under fold_in(key, t) at its place in the
    tile; a single tile under the key itself."""
    keys, tile, index = tracer.tile_streams(rng.prng_key(4), 1100, 500)
    want = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(4), t))
                     for t in range(3)]).astype(np.int64)
    np.testing.assert_array_equal(keys.numpy(), want)
    np.testing.assert_array_equal(tile.numpy(), np.arange(1100) // 500)
    np.testing.assert_array_equal(index.numpy(), np.arange(1100) % 500)
    keys, tile, _ = tracer.tile_streams(rng.prng_key(4), 400, 500)
    np.testing.assert_array_equal(keys.numpy(), [[0, 4]])
    assert int(tile.max()) == 0
