"""The scene extensions in the port against the JAX package: checker and
image textures, the directional (gradient and sun) sky, textured meshes
and instances, thin-lens and QMC raygen.  The JAX side runs as its own
tests run it on the CPU: ``pallas_trace`` / ``pallas_segment`` in Pallas
interpret mode; the port's side is its plain PyTorch versions on CPU
tensors.

Scenes (tests/torch_meshes.py and the presets): a checker scene (two
checker materials), bench.py's image scene with a textured triangle
added, a textured sphere (texture_demo's globe image), ``sky_demo``,
``texture_demo``, and a scene of textured instances.

Tolerances: scene arrays, packed tables and engine-table specs bit for
bit; traces at depth 1 without jitter every ray within 1e-5 absolute; at
depth 4 with jitter >= 99% of rays within 1e-5 absolute or 1e-4 relative
and the mean within 1e-4 relative (a last-bit difference at a grazing hit
sends a rare path elsewhere, as in tests/test_torch_trace.py; the
relative bound is for rays that see sky_demo's sun, whose power 256
multiplies a last-bit difference of a reflected direction, the JAX
kernel's rsqrt against the port's 1 / sqrt, 256-fold).  The sphere's
image is read at an equirectangular UV that the JAX kernel takes from
polynomials (``vpu_atan2`` / ``vpu_asin``, about 1e-7 rad) and the port
from float64: the texel coordinate moves by about 1e-6 texel, far inside
1e-5 (5.7e-7 measured at depth 1).  The segment: every plane within
1e-5 and the alive plane equal.  Raygen (o, d) within 2e-7 (float32
cos / sin / norm of the two packages), the Halton point and the rotation
seed exactly.  The two engines' films bit for bit."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.engines.tables import \
    build_scene_tables as jax_tables  # noqa: E402
from parallelraytracing_tpu.ops import rays as jrays  # noqa: E402
from parallelraytracing_tpu.ops.pallas_trace import \
    pack_instance_tables as jax_pack_instances  # noqa: E402
from parallelraytracing_tpu.ops.pallas_trace import \
    pack_kernel_textures as jax_pack_textures  # noqa: E402
from parallelraytracing_tpu.ops.pallas_trace import \
    pack_scene_tables as jax_pack  # noqa: E402
from parallelraytracing_tpu.ops.pallas_trace import (pallas_segment,  # noqa: E402
                                                     pallas_trace)

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch import convert  # noqa: E402
from parallelraytracing_tpu_torch.core import mesh as tmesh  # noqa: E402
from parallelraytracing_tpu_torch.core.scene import (SceneData,  # noqa: E402
                                                     globe_image)
from parallelraytracing_tpu_torch.engines.tables import build_scene_tables  # noqa: E402
from parallelraytracing_tpu_torch.ops import rays  # noqa: E402
from parallelraytracing_tpu_torch.ops.pack import (KTEX_MAX,  # noqa: E402
                                                   pack_instance_tables,
                                                   pack_kernel_textures,
                                                   pack_scene_tables)
from parallelraytracing_tpu_torch.ops.segment import PLANES, segment_slots  # noqa: E402
from parallelraytracing_tpu_torch.ops.trace import trace  # noqa: E402
from torch_meshes import (ICO_F, ICO_V, bench_image, checker_scene,  # noqa: E402
                          image_scene, make_mesh, textured_instance_scene,
                          textured_sphere_scene)

FIELDS = [f.name for f in dataclasses.fields(SceneData)]
W, H, ROWS = 32, 16, 4  # 512 rays: one 4x128 Pallas tile
SEED = 31337
#: each scene's camera (eye, look-at); the presets take the CLI's
CAMERAS = {"checker": ((0.0, 4.0, 9.0), (0.0, 1.0, 0.0)),
           "image": ((0.0, 5.0, 10.0), (0.0, 3.0, -2.0)),
           "sphere": ((0.0, 3.0, 6.5), (0.0, 1.6, 0.0)),
           "sky_demo": ((5.0, 5.0, 8.0), (0.0, 0.0, 0.0)),
           "texture_demo": ((5.0, 5.0, 8.0), (0.0, 0.0, 0.0)),
           "instances": ((0.0, 6.0, 14.0), (0.0, 1.0, 0.0))}


def ico20():
    v = np.asarray(ICO_V, np.float64)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    return tmesh.Mesh(v.astype(np.float32),
                      np.asarray(ICO_F, np.uint32).reshape(-1))


def ico80():
    m = make_mesh("ico1")
    m.compute_vertex_normals()
    return m


def make_scene(name, scene_cls, instanced=True):
    """The named scene, built with either package's Scene class."""
    if name == "checker":
        return checker_scene(scene_cls)
    if name == "image":
        return image_scene(scene_cls, bench_image())
    if name == "sphere":
        return textured_sphere_scene(scene_cls, globe_image())
    if name == "instances":
        return textured_instance_scene(scene_cls, ico20(), ico80(),
                                       globe_image(), instanced)
    preset = T.ScenePreset if scene_cls is T.Scene else J.ScenePreset
    return scene_cls(preset(name))


def _camera(cls, name, w=W, h=H):
    eye, look = (np.asarray(v, np.float64) for v in CAMERAS[name])
    return cls(eye, look - eye, float(w), float(h), 100.0)


def _ord_base(host) -> float:
    return float(sum(np.asarray(host[k]).shape[0]
                     for k in ("sph_valid", "quad_valid", "tri_valid")))


# ------------------------------------------------------- scene and tables

@pytest.mark.parametrize("name,bake", [
    ("texture_demo", True), ("sky_demo", True), ("image", True),
    ("instances", True), ("instances", False)])
def test_scene_data_equals_jax(name, bake):
    """Tolerance 0: every SceneData field, the extension fields present
    exactly where the JAX package has them (the baked instances are a
    textured mesh through add_mesh)."""
    got = make_scene(name, T.Scene).build("cpu", bake_instances=bake).numpy()
    want = make_scene(name, J.Scene).build(bake_instances=bake)
    for f in FIELDS:
        b = getattr(want, f)
        if b is None:
            assert got[f] is None, f
            continue
        b = np.asarray(b)
        assert got[f] is not None and got[f].dtype == b.dtype, f
        np.testing.assert_array_equal(got[f], b, err_msg=f)


def test_packed_tables_equal_jax():
    """Tolerance 0: the texel rows and itex spec of pack_kernel_textures,
    the 33-row triangle table of an image scene (rows 27-32 the texture
    coordinates) and the 31-row instanced triangles of with_uv."""
    for name in ("texture_demo", "image"):
        host = make_scene(name, T.Scene).build("cpu").numpy()
        jhost = make_scene(name, J.Scene).build()
        itex, rows = pack_kernel_textures(host)
        jitex, jrows = jax_pack_textures(jhost)
        assert itex == jitex and rows.dtype == np.float32
        np.testing.assert_array_equal(rows, jrows)
        tabs = pack_scene_tables(host)
        jt = jax_pack(jhost)
        assert tabs[2].shape[0] == 33
        for a, b in zip(tabs, jt[:7]):
            np.testing.assert_array_equal(a, np.asarray(b))
    scene, jscene = make_scene("instances", T.Scene), make_scene("instances",
                                                                 J.Scene)
    host = scene.build("cpu", bake_instances=False).numpy()
    got = pack_instance_tables(scene._inst_meshes, scene.instances,
                               _ord_base(host), with_uv=True)
    want = jax_pack_instances(jscene._inst_meshes, jscene.instances,
                              _ord_base(host), with_uv=True)
    assert got[0].shape[0] == 31
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g.view(np.uint32),
                                                     w.view(np.uint32))


@pytest.mark.parametrize("name", ["texture_demo", "sky_demo", "checker",
                                  "instances"])
def test_engine_tables_equal_jax(name):
    """The sky spec, checker and itex specs and every table of
    ``build_scene_tables`` equal the JAX engine tables'."""
    t, _ = build_scene_tables(make_scene(name, T.Scene), "cpu")
    jt, _ = jax_tables(make_scene(name, J.Scene),
                       J.RenderConfig(width=8, height=8))
    assert t.sky == jt.sky and t.checker == jt.checker and t.itex == jt.itex
    assert (t.itex_tab is None) == (jt.itex_tab is None)
    if t.itex_tab is not None:
        np.testing.assert_array_equal(t.itex_tab.numpy(),
                                      np.asarray(jt.itex_tab))
    for a, b in zip((t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl, t.tri_cl,
                     t.mats), (jt.sph, jt.quad, jt.tri, jt.sph_cl,
                               jt.quad_cl, jt.tri_cl, jt.mats)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if name == "instances":
        assert t.inst.itri.shape[0] == 31 and jt.itri_cold is None
        np.testing.assert_array_equal(t.inst.itri.numpy(),
                                      np.asarray(jt.inst[0]))


# ------------------------------------------- trace and segment vs Pallas

def _jax_inputs(name, depth, jitter, nee):
    """(JAX engine tables, port tables from them via convert, config,
    pixel ids, rays)."""
    jscene = make_scene(name, J.Scene)
    cfg = J.RenderConfig(width=W, height=H, max_depth=depth, jitter=jitter,
                         nee=nee)
    jt, _ = jax_tables(jscene, cfg)
    assert jt.nee == nee
    inst = None
    if jt.inst is not None:
        base = jscene.build(bake_instances=False)
        inst = jax_pack_instances(
            jscene._inst_meshes, jscene.instances,
            _ord_base({k: np.asarray(getattr(base, k))
                       for k in ("sph_valid", "quad_valid", "tri_valid")}),
            with_uv=True)
    t = convert.tables_from_numpy(
        *(np.asarray(a) for a in (jt.sph, jt.quad, jt.tri, jt.sph_cl,
                                  jt.quad_cl, jt.tri_cl, jt.mats)),
        jt.sky, "cpu", lights=np.asarray(jt.lights), nee=jt.nee, inst=inst,
        checker=jt.checker, itex=jt.itex,
        itex_tab=None if jt.itex_tab is None else np.asarray(jt.itex_tab))
    cam = _camera(J.Camera, name)
    ids = np.random.default_rng(7).permutation(W * H).astype(np.int32)
    o, d = jrays.generate_camera_rays_ids(
        jnp.asarray(cam.ray_params()), W, H, jnp.asarray(ids), None, jitter,
        pix_seed=jnp.uint32(2024))
    return jt, t, cfg, ids, o, d


def _trace_both(name, depth, jitter, nee):
    jt, t, cfg, ids, o, d = _jax_inputs(name, depth, jitter, nee)
    ref = np.asarray(pallas_trace(
        o, d, jnp.asarray(ids, jnp.float32), jt.sph, jt.quad, jt.tri,
        jt.sph_cl, jt.quad_cl, jt.tri_cl, jt.mats, jt.lights,
        jnp.asarray([SEED], jnp.int32), ROWS, depth, cfg.t_min, cfg.t_max,
        jt.sky, interpret=True, nee=jt.nee, inst=jt.inst,
        itri_vmem=jt.itri_vmem, checker=jt.checker, itex=jt.itex,
        itex_tab=jt.itex_tab))
    got = trace(torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)),
                torch.from_numpy(ids), SEED, t, cfg).numpy()
    return ref, got


#: scene -> NEE at depth 1: NEE makes the first vertex's textured albedo
#: reach the radiance; sky_demo has no light, its depth-1 radiance is the
#: directional sky itself
SCENES = {"checker": True, "image": True, "sphere": True, "sky_demo": False}


@pytest.mark.parametrize("name", list(SCENES))
def test_trace_depth1_matches_pallas(name):
    ref, got = _trace_both(name, 1, False, SCENES[name])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert ref.mean() > 0


@pytest.mark.parametrize("name", list(SCENES))
def test_trace_depth4_jittered_matches_pallas(name):
    ref, got = _trace_both(name, 4, True, False)
    bound = np.maximum(1e-5, 1e-4 * np.abs(ref).max(-1))
    close = (np.abs(got - ref).max(-1) <= bound).mean()
    assert close >= 0.99, close
    assert abs(got.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())


def test_segment_matches_pallas_segment():
    """One 2-bounce segment at absolute depth 1 over the image scene with
    NEE, queue prefix 400 of 512, incoming alive 1 or 2, random
    throughput and radiance: every plane within 1e-5, the alive plane
    equal, dead slots passed through."""
    jt, t, cfg, ids, o, d = _jax_inputs("image", 2, True, True)
    rng = np.random.default_rng(11)
    r, count = W * H, 400
    state = np.concatenate([
        np.array(o).T, np.array(d).T, rng.uniform(0.05, 1.0, (3, r)),
        rng.uniform(0.0, 1.0, (3, r)),
        rng.integers(1, 3, (1, r))]).astype(np.float32)
    planes, alive = pallas_segment(
        jnp.asarray(ids, jnp.float32), tuple(jnp.asarray(p) for p in state),
        jt.sph, jt.quad, jt.tri, jt.sph_cl, jt.quad_cl, jt.tri_cl, jt.mats,
        jt.lights, jnp.asarray([SEED, 1, count], jnp.int32), ROWS, 2,
        cfg.t_min, cfg.t_max, jt.sky, interpret=True, nee=True,
        checker=jt.checker, itex=jt.itex, itex_tab=jt.itex_tab)
    ref = np.stack([np.asarray(p) for p in planes] + [np.asarray(alive)])
    got = segment_slots(
        torch.from_numpy(ids), torch.from_numpy(state),
        torch.tensor([SEED, 1, count], dtype=torch.int32), t, cfg,
        n_bounces=2).numpy()
    assert got.shape == ref.shape == (PLANES, r)
    np.testing.assert_array_equal(got[12], ref[12])
    np.testing.assert_allclose(got[:12, :count], ref[:12, :count], rtol=0,
                               atol=1e-5)
    for out in (got, ref):
        np.testing.assert_array_equal(out[:12, count:], state[:12, count:])


# ------------------------------------------------------------------ raygen

@pytest.mark.parametrize("jitter", [True, False])
@pytest.mark.parametrize("qmc", [False, True])
def test_lens_and_qmc_raygen_match_jax(qmc, jitter):
    """Thin-lens rays (radius 0.3, focus 7) with pixel-keyed aperture
    draws, and with QMC the Halton point of sample 5 under the rotation
    seed: (o, d) within 2e-7 of the JAX package's."""
    w, h = 24, 16
    params = T.default_camera(w, h).ray_params()
    ids = np.random.default_rng(3).permutation(w * h).astype(np.int32)
    seed = rays.qmc_rotation_seed(4) if qmc else 99
    qpt = rays.halton_qpt(5) if qmc else None
    jo, jd = jrays.generate_camera_rays_ids(
        jnp.asarray(params), w, h, jnp.asarray(ids), None, jitter,
        pix_seed=jnp.uint32(seed), lens=(0.3, 7.0),
        qpt=None if qpt is None else jnp.asarray(qpt))
    o, d = rays.generate_camera_rays_ids(
        torch.from_numpy(params), w, h, torch.from_numpy(ids), jitter,
        pix_seed=seed, lens=(0.3, 7.0), qpt=qpt)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=2e-7)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=2e-7)
    assert float(np.abs(np.asarray(jo) - params[:3]).max()) > 0.05  # defocus


def test_halton_point_and_rotation_seed_exact():
    for g in (0, 1, 2, 7, 63, 1000, 123457):
        np.testing.assert_array_equal(rays.halton_qpt(g), jrays.halton_qpt(g))
        assert rays.radical_inverse(g, 3) == jrays.radical_inverse(g, 3)
    for seed in (0, 1, 42, 2**31 - 1):
        assert rays.qmc_rotation_seed(seed) == int(
            jrays.qmc_rotation_seed(seed))


# ----------------------------------------------------------------- engines

def _render(engine, name, cfg_kw, w=24, h=16, frames=2, attrs=()):
    cfg = T.RenderConfig(width=w, height=h, max_depth=5, seed=2, **cfg_kw)
    film = T.Film(w, h, "cpu")
    r = T.create_renderer(engine, "cpu")
    for k, v in dict(attrs).items():
        setattr(r, k, v)
    r.init(film, make_scene(name, T.Scene), _camera(T.Camera, name, w, h),
           cfg)
    for _ in range(frames):
        r.progressive_render()
    return film.hdr_average(), r


@pytest.mark.parametrize("name,cfg_kw", [
    ("texture_demo", dict(lens_radius=0.1, focus_distance=10.0, qmc=True)),
    ("texture_demo", dict(nee=True)), ("sky_demo", dict()),
    ("instances", dict(nee=True, russian_roulette_depth=2))])
def test_engines_bit_equal_on_extensions(name, cfg_kw):
    """Tolerance 0: wavefront_fused (its default schedule and one-bounce
    segments) renders the fused engine's film."""
    ref, r = _render("fused", name, cfg_kw)
    assert r._tables.checker or r._tables.itex or len(r._tables.sky) == 13
    for attrs in ((), (("schedule", (1,)),)):
        film, _ = _render("wavefront_fused", name, cfg_kw, attrs=attrs)
        assert torch.equal(film, ref), attrs
    assert ref.mean() > 0


def test_textures_change_the_image():
    """The texture reaches the film: texture_demo with its textured
    materials turned plain renders a different image, and so does QMC
    against plain jitter (same seed)."""
    ref, r = _render("fused", "texture_demo", {})
    plain = make_scene("texture_demo", T.Scene)
    plain._mat_tex = [0] * len(plain._mat_tex)
    cfg = T.RenderConfig(width=24, height=16, max_depth=5, seed=2)
    p = T.create_renderer("fused", "cpu")
    film = T.Film(24, 16, "cpu")
    p.init(film, plain, _camera(T.Camera, "texture_demo", 24, 16), cfg)
    for _ in range(2):
        p.progressive_render()
    assert not p._tables.itex and not p._tables.checker
    assert float((film.hdr_average() - ref).abs().max()) > 0.05
    qmc, _ = _render("fused", "texture_demo", dict(qmc=True))
    assert not torch.equal(qmc, ref)


def test_texture_above_the_kernel_cap_raises():
    """Images above KTEX_MAX = 128 texels on a side stay refused (the JAX
    kernels' cap, kept for parity), by the packer and the engine tables."""
    s = T.Scene(preset=None)
    big = np.random.default_rng(0).uniform(size=(KTEX_MAX + 1, 8, 3))
    s.add_quad(4, 4, s.add_textured_lambertian(s.add_texture(big)), None)
    with pytest.raises(NotImplementedError, match="128x128"):
        pack_kernel_textures(s.build("cpu").numpy())
    with pytest.raises(NotImplementedError, match="bvh and tlas_ref"):
        build_scene_tables(s, "cpu")


def test_cli_renders_texture_demo_with_lens_and_qmc(tmp_path):
    from parallelraytracing_tpu_torch import cli
    out = tmp_path / "tex.png"
    assert cli.main(["--device", "cpu", "--scene", "texture_demo",
                     "--width", "16", "--height", "12", "--frames", "1",
                     "--depth", "3", "--lens-radius", "0.1",
                     "--focus-distance", "9", "--qmc", "--out",
                     str(out)]) == 0
    assert out.stat().st_size > 0
