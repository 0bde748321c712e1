"""Next-event estimation (NEE) and Russian roulette (RR) in the port,
against the JAX package (``pallas_trace`` and ``pallas_segment`` in Pallas
interpret mode; the port's plain PyTorch versions on the CPU).

The JAX package's own tables, light table included, go through
``convert.tables_from_numpy`` into the port, with the same rays and seeds,
as in tests/test_torch_trace.py, at 32x32 (one 8x128 Pallas tile).

Tolerances, those of tests/test_torch_trace.py: at depth 1 without
jitter every ray within 1e-5 absolute; at depth 4-6 with jitter >= 98% of
rays within 1e-4 and the mean within 1e-3 relative.  One exception: NEE
on RANDOM_BALLS_LARGE at depth 1, where 28 of the 1024 rays differ from
the interpret-mode kernel by up to 5.5e-4 (2.2e-3 relative).  Their
shading points differ: they hit a sphere far from the eye, where the
discriminant b^2 - c cancels (0.013-0.64 against b^2 of 45-1210), and
XLA's CPU backend contracts the interpret kernel's b, c and b^2 - c into
fused multiply-adds, which the port (the source's order, every step
rounded, as the CUDA kernels) does not: hit points 3e-5 to 2.4e-4 apart,
and a point's direct term moves with it.  The cone's pdf is not the
cause: the JAX code of the light sample, jitted on the port's points,
gives the port's weights within 1e-7 (ROADMAP Queue 3, "Explained").
There every ray agrees within 1e-5 absolute or 5e-3 relative, >= 95%
within 1e-5, and the rays with a direct term are the same rays.
The kernel on the card is held to the plain version at 1e-5 per ray
(chip_smoke.py, tests/test_torch_cuda.py): both round every step."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402
from parallelraytracing_tpu.core.scene import \
    ply_showcase_scene as jax_showcase  # noqa: E402
from parallelraytracing_tpu.engines.tables import \
    build_scene_tables as jax_tables  # noqa: E402
from parallelraytracing_tpu.ops.pallas_trace import \
    pack_lights_table as jax_pack_lights  # noqa: E402
from parallelraytracing_tpu.ops.pallas_trace import (pallas_segment,  # noqa: E402
                                                     pallas_trace)
from parallelraytracing_tpu.ops.rays import \
    generate_camera_rays_ids as jax_rays  # noqa: E402

from torch_meshes import mesh_ply  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch import cli, convert  # noqa: E402
from parallelraytracing_tpu_torch.core.light import (add_quad_light,  # noqa: E402
                                                     add_sphere_light)
from parallelraytracing_tpu_torch.core.scene import ply_showcase_scene  # noqa: E402
from parallelraytracing_tpu_torch.engines.tables import build_scene_tables  # noqa: E402
from parallelraytracing_tpu_torch.engines.wavefront_fused import \
    segmented_trace  # noqa: E402
from parallelraytracing_tpu_torch.ops.nee import extract_lights  # noqa: E402
from parallelraytracing_tpu_torch.ops.pack import pack_lights_table  # noqa: E402
from parallelraytracing_tpu_torch.ops.segment import PLANES, segment_slots  # noqa: E402
from parallelraytracing_tpu_torch.ops.trace import trace  # noqa: E402
from parallelraytracing_tpu_torch.utils.png import read_png  # noqa: E402

W = H = 32  # 1024 rays: one 8x128 Pallas tile
SEED = 424242
COUNT = 700  # live queue prefix of the segment tests


def _port_tables(jt):
    """The JAX engine tables, light table and NEE flag included, as the
    port's SceneTables on the CPU."""
    return convert.tables_from_numpy(
        *(np.asarray(a) for a in (jt.sph, jt.quad, jt.tri, jt.sph_cl,
                                  jt.quad_cl, jt.tri_cl, jt.mats)),
        jt.sky, "cpu", lights=np.asarray(jt.lights), nee=jt.nee)


def _rays(params, jitter):
    ids = np.random.default_rng(5).permutation(W * H).astype(np.int32)
    o, d = jax_rays(jnp.asarray(params), W, H, jnp.asarray(ids), None,
                    jitter, pix_seed=jnp.uint32(987))
    return ids, o, d


def _both(preset, depth, jitter, nee, rr_depth=0):
    cfg = J.RenderConfig(width=W, height=H, max_depth=depth, jitter=jitter,
                         nee=nee, russian_roulette_depth=rr_depth)
    jt, _ = jax_tables(J.Scene(J.ScenePreset(preset)), cfg)
    assert jt.nee == nee
    ids, o, d = _rays(jax_camera(W, H).ray_params(), jitter)
    ref = np.asarray(pallas_trace(
        o, d, jnp.asarray(ids, jnp.float32), jt.sph, jt.quad, jt.tri,
        jt.sph_cl, jt.quad_cl, jt.tri_cl, jt.mats, jt.lights,
        jnp.asarray([SEED], jnp.int32), 8, depth, cfg.t_min, cfg.t_max,
        jt.sky, interpret=True, nee=nee, rr_depth=rr_depth))
    t = _port_tables(jt)

    def port(rr):
        return trace(torch.from_numpy(np.array(o)),
                     torch.from_numpy(np.array(d)), torch.from_numpy(ids),
                     SEED, t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl,
                     t.tri_cl, t.mats, max_depth=depth, t_min=cfg.t_min,
                     t_max=cfg.t_max, sky=t.sky, tri_live=t.tri_live,
                     nee=t.nee, lights=t.lights, rr_depth=rr).numpy()
    return ref, port(rr_depth), port


def _assert_jittered_close(got, ref):
    close = (np.abs(got - ref).max(-1) <= 1e-4).mean()
    assert close >= 0.98, close
    assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


def _scene(name, tmp_path):
    """(port Scene, JAX Scene) of a preset or of the level-1 icosphere's
    showcase scene."""
    if name == "ico1":
        path = mesh_ply(tmp_path, "ico1")
        return ply_showcase_scene(path)[0], jax_showcase(path)[0]
    return T.Scene(T.ScenePreset(name)), J.Scene(J.ScenePreset(name))


@pytest.mark.parametrize("name,n_lights", [
    ("cornell", 1), ("light_test", 11), ("random_balls_large", 8),
    ("ico1", 1)])
def test_light_table_equals_jax(tmp_path, name, n_lights):
    """Tolerance 0: the (28, Nl) light table, rows 18-27 included, equals
    the JAX package's bit for bit, and the tables run NEE."""
    scene, jscene = _scene(name, tmp_path)
    host = scene.build("cpu").numpy()
    got = pack_lights_table(host)
    want = jax_pack_lights(jscene.build())
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (28, n_lights)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert extract_lights(host).count == n_lights
    t, _ = build_scene_tables(scene, "cpu", nee=True)
    assert t.nee and torch.equal(t.lights, torch.from_numpy(want))


def test_no_lights_means_no_nee():
    """A scene without emissive spheres or quads: the (28, 1) zero table,
    NEE off even when asked for (the JAX package's rule), and a render
    with --nee equals one without."""
    scene = T.Scene(T.ScenePreset.MATERIAL_TEST)
    host = scene.build("cpu").numpy()
    assert extract_lights(host) is None
    assert np.array_equal(pack_lights_table(host), np.zeros((28, 1)))
    t, _ = build_scene_tables(scene, "cpu", nee=True)
    assert not t.nee
    films = []
    for nee in (False, True):
        film = T.Film(16, 12, "cpu")
        r = T.create_renderer("fused", "cpu")
        r.init(film, scene, T.default_camera(16, 12),
               T.RenderConfig(width=16, height=12, max_depth=4, nee=nee))
        r.progressive_render()
        films.append(film.hdr_average())
    assert torch.equal(*films)


def test_light_helpers_add_emissive_primitives():
    scene = T.Scene(preset=None)
    scene.add_quad(10, 10, scene.add_lambertian((0.5, 0.5, 0.5)))
    m0 = add_sphere_light(scene, (0, 5, 0), 1.0, (4, 4, 4))
    m1 = add_quad_light(scene, 2, 2, (1, 2, 3),
                        ((1, 1, 1), (180, 0, 0), (0, 8, 0)))
    lights = extract_lights(scene.build("cpu").numpy())
    assert (m0, m1) == (1, 2)
    assert lights.kind.tolist() == [0, 1] and lights.idx.tolist() == [0, 1]
    np.testing.assert_array_equal(lights.emit, [[4, 4, 4], [1, 2, 3]])
    np.testing.assert_allclose(lights.normal[1], [0, -1, 0], atol=1e-6)


@pytest.mark.parametrize("preset", ["cornell", "random_balls_large"])
def test_nee_depth1_matches_pallas(preset):
    ref, got, _ = _both(preset, 1, False, nee=True)
    err = np.abs(got - ref).max(-1)
    if preset == "cornell":  # a quad light: every ray within 1e-5
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:  # sphere lights: the cone pdf's cancellation (module docstring)
        assert (err <= np.maximum(1e-5, 5e-3 * np.abs(ref).max(-1))).all()
        assert (err <= 1e-5).mean() >= 0.95, (err <= 1e-5).mean()
        assert np.array_equal(got > 0, ref > 0)


@pytest.mark.parametrize("preset", ["cornell", "random_balls_large"])
def test_nee_depth4_jittered_matches_pallas(preset):
    ref, got, _ = _both(preset, 4, True, nee=True)
    _assert_jittered_close(got, ref)


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("preset", ["cornell", "random_balls_large"])
def test_russian_roulette_matches_pallas(preset, nee):
    """rr_depth 2 at depth 4: roulette ends paths at bounces 2 and 3 (and
    so changes the image)."""
    ref, got, port = _both(preset, 4, True, nee=nee, rr_depth=2)
    _assert_jittered_close(got, ref)
    assert not np.array_equal(port(0), got)


@pytest.mark.parametrize("name", ["cornell", "octa"])
def test_segment_nee_rr_matches_pallas_segment(tmp_path, name):
    """One 2-bounce segment at absolute depth 2 with NEE and rr_depth 2,
    queue prefix COUNT of 1024, incoming alive 1 or 2 (the no-emit mark of
    an earlier segment), random throughput and radiance: the alive plane
    is equal (0, 1 or 2) on every slot, the 12 other planes agree as the
    depth-4 traces do, and dead slots pass through in both packages."""
    if name == "octa":
        path = mesh_ply(tmp_path, "octa")
        jscene, eye, look = jax_showcase(path)
        eye, look = np.asarray(eye), np.asarray(look)
        params = J.Camera(eye, look - eye, float(W), float(H), 100.0).ray_params()
    else:
        jscene = J.Scene(J.ScenePreset(name))
        params = jax_camera(W, H).ray_params()
    cfg = J.RenderConfig(width=W, height=H, nee=True,
                         russian_roulette_depth=2)
    jt, _ = jax_tables(jscene, cfg)
    assert jt.nee
    ids, o, d = _rays(params, True)
    rng = np.random.default_rng(9)
    r = W * H
    state = np.concatenate([
        np.array(o).T, np.array(d).T, rng.uniform(0.05, 1.0, (3, r)),
        rng.uniform(0.0, 1.0, (3, r)),
        rng.integers(1, 3, (1, r))]).astype(np.float32)
    planes, alive = pallas_segment(
        jnp.asarray(ids, jnp.float32), tuple(jnp.asarray(p) for p in state),
        jt.sph, jt.quad, jt.tri, jt.sph_cl, jt.quad_cl, jt.tri_cl, jt.mats,
        jt.lights, jnp.asarray([SEED, 2, COUNT], jnp.int32), 8, 2, cfg.t_min,
        cfg.t_max, jt.sky, interpret=True, nee=True, rr_depth=2)
    ref = np.stack([np.asarray(p) for p in planes] + [np.asarray(alive)])

    t = _port_tables(jt)
    got = segment_slots(
        torch.from_numpy(ids), torch.from_numpy(state),
        torch.tensor([SEED, 2, COUNT], dtype=torch.int32), t.sph, t.quad,
        t.tri, t.sph_cl, t.quad_cl, t.tri_cl, t.mats, n_bounces=2,
        t_min=cfg.t_min, t_max=cfg.t_max, sky=t.sky, tri_live=t.tri_live,
        rr_depth=2, nee=True, lights=t.lights).numpy()
    assert got.shape == ref.shape == (PLANES, r)
    live = slice(0, COUNT)
    np.testing.assert_array_equal(got[12], ref[12])
    # every surface is Lambertian: a live path leaves marked 2
    assert set(np.unique(got[12, live]).tolist()) == {0.0, 2.0}
    _assert_jittered_close(got[:12, live].T, ref[:12, live].T)
    for out in (got, ref):
        np.testing.assert_array_equal(out[:12, COUNT:], state[:12, COUNT:])
        assert not out[12, COUNT:].any()


@pytest.mark.parametrize("schedule", [(3,), (1, 2, 4)])
def test_segmented_trace_nee_rr_bitmatches_trace(schedule):
    """Tolerance 0: NEE's no-emit mark and roulette cross segment
    boundaries, so the segmented frame is the fused trace's, bit for bit
    (the port's analogue of test_in_kernel_nee_wavefront_fused_bitmatches_fused)."""
    cfg = T.RenderConfig(width=24, height=16, max_depth=8, nee=True,
                         russian_roulette_depth=2)
    t, _ = build_scene_tables(T.Scene(T.ScenePreset.CORNELL), "cpu", nee=True)
    assert t.nee
    r = T.create_renderer("fused", "cpu")
    r.init(T.Film(24, 16, "cpu"), T.Scene(T.ScenePreset.CORNELL),
           T.default_camera(24, 16), cfg)
    from parallelraytracing_tpu_torch.engines.fused import raygen_ids
    from parallelraytracing_tpu_torch.ops.rays import (frame_stream_seeds,
                                                       sample_key)
    jseed, seed = frame_stream_seeds(sample_key(cfg.seed, 0, 0))
    o, d = raygen_ids(r._cam_params, r._ids, jseed, 24, 16, True)
    want = trace(o, d, r._ids, seed, t.sph, t.quad, t.tri, t.sph_cl,
                 t.quad_cl, t.tri_cl, t.mats, max_depth=8, t_min=cfg.t_min,
                 t_max=cfg.t_max, sky=t.sky, tri_live=t.tri_live, nee=True,
                 lights=t.lights, rr_depth=2)
    got = segmented_trace(t, o, d, r._ids, seed, cfg, schedule=schedule)
    assert torch.equal(got[r._ids.long()], want)
    assert want.mean() > 0


def _read_pfm(path):
    with open(path, "rb") as f:
        assert f.readline() == b"PF\n"
        w, h = (int(v) for v in f.readline().split())
        f.readline()
        return np.frombuffer(f.read(), "<f4").reshape(h, w, 3)


def test_cli_renders_nee_rr_clamp(tmp_path, capsys):
    out, hdr = tmp_path / "cornell.png", tmp_path / "cornell.pfm"
    rc = cli.main(["--device", "cpu", "--scene", "cornell", "--nee",
                   "--rr-depth", "3", "--clamp", "2.5", "--width", "16",
                   "--height", "16", "--frames", "2", "--out", str(out),
                   "--hdr-out", str(hdr)])
    assert rc == 0 and "nee=True rr_depth=3" in capsys.readouterr().out
    assert read_png(str(out)).shape == (16, 16, 4)
    img = _read_pfm(hdr)
    assert np.isfinite(img).all() and 0.0 < img.mean() and img.max() <= 2.5
