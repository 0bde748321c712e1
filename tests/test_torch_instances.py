"""Instancing in the port against the JAX package: ``Scene.add_mesh_instances``,
``pack_instance_tables``, the engine tables, and the instance block of the
trace and segment (``pallas_trace`` / ``pallas_segment`` in Pallas
interpret mode; the port's plain PyTorch versions on the CPU).

Two instanced scenes, both from tests/torch_meshes.py: the layout of
tests/test_tlas.py around the 20-triangle icosahedron (one unique mesh,
four instances), and a scene of two unique meshes (that icosahedron and
the icosahedron at level 1 with smooth normals, 80 triangles, whose tree
has internal nodes), four instances, a flat sphere, a quad light and a
sphere light.

Tolerances: tables and scene arrays bit for bit; traces at depth 1
without jitter every ray within 1e-5 absolute; at depth 4 with jitter
>= 98% of rays within 1e-4 and the mean within 1e-3 relative (the bounds
of tests/test_torch_trace.py; with NEE too: both scenes' lights are near,
so the cone-pdf divergence of ROADMAP Queue 3 does not show); one
segment's alive plane equal on every slot; instanced and baked films
within an HDR RMSE of 1e-3 (the ``tlas_blas`` fidelity gate's bound);
the two engines' films bit for bit."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.engines.tables import \
    build_scene_tables as jax_tables  # noqa: E402
from parallelraytracing_tpu.ops.pallas_trace import \
    pack_instance_tables as jax_pack_instances  # noqa: E402
from parallelraytracing_tpu.ops.pallas_trace import (pallas_segment,  # noqa: E402
                                                     pallas_trace)
from parallelraytracing_tpu.ops.rays import \
    generate_camera_rays_ids as jax_rays  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch import convert  # noqa: E402
from parallelraytracing_tpu_torch.core import mesh as tmesh  # noqa: E402
from parallelraytracing_tpu_torch.core.scene import SceneData  # noqa: E402
from parallelraytracing_tpu_torch.engines.fused import FusedRenderer  # noqa: E402
from parallelraytracing_tpu_torch.engines.tables import build_scene_tables  # noqa: E402
from parallelraytracing_tpu_torch.ops.pack import (instance_ranges,  # noqa: E402
                                                   pack_instance_tables)
from parallelraytracing_tpu_torch.ops.segment import PLANES, segment_slots  # noqa: E402
from parallelraytracing_tpu_torch.ops.trace import (scene_arg, trace,  # noqa: E402
                                                    trace_reference)
from torch_meshes import (ICO_F, ICO_V, make_mesh, tlas_scene,  # noqa: E402
                          two_mesh_scene)

FIELDS = [f.name for f in dataclasses.fields(SceneData)]
W, H, ROWS = 32, 16, 4  # 512 rays: one 4x128 Pallas tile
SEED = 424242
COUNT = 400  # live queue prefix of the segment test
EYE, DIR = np.array([0.0, 6.0, 14.0]), np.array([0.0, -5.0, -14.0])


def ico20():
    """The closed-form icosahedron, vertices on the unit sphere, flat
    normals (the role of the reference's icosahedron.ply)."""
    v = np.asarray(ICO_V, np.float64)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    return tmesh.Mesh(v.astype(np.float32),
                      np.asarray(ICO_F, np.uint32).reshape(-1))


def ico80():
    m = make_mesh("ico1")
    m.compute_vertex_normals()
    return m


def make_scene(name, scene_cls, instanced=True):
    """The named instanced scene, built with either package's Scene."""
    if name == "tlas":
        return tlas_scene(scene_cls, ico20(), instanced)
    return two_mesh_scene(scene_cls, ico20(), ico80(), instanced)


def _ord_base(host) -> float:
    return float(sum(np.asarray(host[k]).shape[0]
                     for k in ("sph_valid", "quad_valid", "tri_valid")))


# ------------------------------------------------------ scene and tables

@pytest.mark.parametrize("bake", [True, False])
@pytest.mark.parametrize("name", ["tlas", "two"])
def test_scene_data_equals_jax(name, bake):
    """Tolerance 0: the world-baked and the unbaked SceneData."""
    got = make_scene(name, T.Scene).build("cpu", bake_instances=bake).numpy()
    jscene = make_scene(name, J.Scene)
    want = jscene.build(bake_instances=bake)
    for f in FIELDS:
        if getattr(want, f) is None:  # an extension field left unused
            assert got[f] is None, f
            continue
        b = np.asarray(getattr(want, f))
        assert got[f].dtype == b.dtype, f
        np.testing.assert_array_equal(got[f], b, err_msg=f)
    assert make_scene(name, T.Scene).num_primitives == jscene.num_primitives


@pytest.mark.parametrize("name", ["tlas", "two"])
def test_instance_tables_equal_jax(name):
    """Tolerance 0: pack_instance_tables on the unbaked base equals the
    JAX package's (itri, iacc, ibox, inst), and the engine tables (flat
    kinds, scene box) equal ``build_scene_tables``'s."""
    scene, jscene = make_scene(name, T.Scene), make_scene(name, J.Scene)
    host = scene.build("cpu", bake_instances=False).numpy()
    got = pack_instance_tables(scene._inst_meshes, scene.instances,
                               _ord_base(host))
    want = jax_pack_instances(jscene._inst_meshes, jscene.instances,
                              _ord_base(host))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32))
    t, sd = build_scene_tables(scene, "cpu")
    jt, _ = jax_tables(jscene, J.RenderConfig(width=8, height=8))
    for a, b in zip((t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl, t.tri_cl,
                     t.mats), (jt.sph, jt.quad, jt.tri, jt.sph_cl, jt.quad_cl,
                               jt.tri_cl, jt.mats)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert t.bb == jt.bb and not t.tri_live
    for a, b in zip((t.inst.itri, t.inst.iacc, t.inst.ibox, t.inst.inst), got):
        np.testing.assert_array_equal(a.numpy(), b)
    assert not sd.tri_valid.any()


def test_one_copy_per_unique_mesh():
    """itri holds each unique mesh once however often it is instanced;
    the unbaked base has no triangle; the baked build carries every copy;
    each instance's triangle run is its own mesh's."""
    scene = make_scene("two", T.Scene)
    t, _ = build_scene_tables(scene, "cpu")
    assert len(scene._inst_meshes) == 2 and len(scene.instances) == 4
    assert tuple(t.inst.itri.shape) == (25, 20 + 80)
    assert t.inst.n_inst == 4 and tuple(t.inst.inst.shape) == (24, 4)
    assert t.inst.ranges == ((0, 20), (20, 100), (20, 100), (0, 20))
    assert instance_ranges(t.inst.iacc.numpy(), t.inst.inst.numpy()) \
        == t.inst.ranges
    base = scene.build("cpu", bake_instances=False)
    assert not base.tri_valid.any() and base.tri_valid.shape == (1,)
    assert int(scene.build("cpu").tri_valid.sum()) == 2 * 20 + 2 * 80
    assert scene.num_primitives == 2 + 2 + 2 * 20 + 2 * 80  # spheres, quads


# ------------------------------------------- trace and segment vs Pallas

def _jax_inputs(name, depth, jitter, nee):
    """(JAX engine tables, port tables from them via convert, rays)."""
    jscene = make_scene(name, J.Scene)
    cfg = J.RenderConfig(width=W, height=H, max_depth=depth, jitter=jitter,
                         nee=nee)
    jt, _ = jax_tables(jscene, cfg)
    assert jt.nee == nee and jt.itri_cold is None
    base = jscene.build(bake_instances=False)
    # the unsplit (25, Nt) itri of pack_instance_tables (convert.py)
    inst = jax_pack_instances(jscene._inst_meshes, jscene.instances,
                              _ord_base({k: np.asarray(getattr(base, k))
                                         for k in ("sph_valid", "quad_valid",
                                                   "tri_valid")}))
    t = convert.tables_from_numpy(
        *(np.asarray(a) for a in (jt.sph, jt.quad, jt.tri, jt.sph_cl,
                                  jt.quad_cl, jt.tri_cl, jt.mats)),
        jt.sky, "cpu", lights=np.asarray(jt.lights), nee=jt.nee, inst=inst)
    cam = J.Camera(EYE, DIR, float(W), float(H), 100.0)
    ids = np.random.default_rng(5).permutation(W * H).astype(np.int32)
    o, d = jax_rays(jnp.asarray(cam.ray_params()), W, H, jnp.asarray(ids),
                    None, jitter, pix_seed=jnp.uint32(987))
    return jt, t, cfg, ids, o, d


def _trace_both(name, depth, jitter, nee):
    jt, t, cfg, ids, o, d = _jax_inputs(name, depth, jitter, nee)
    ref = np.asarray(pallas_trace(
        o, d, jnp.asarray(ids, jnp.float32), jt.sph, jt.quad, jt.tri,
        jt.sph_cl, jt.quad_cl, jt.tri_cl, jt.mats, jt.lights,
        jnp.asarray([SEED], jnp.int32), ROWS, depth, cfg.t_min, cfg.t_max,
        jt.sky, interpret=True, nee=jt.nee, inst=jt.inst,
        itri_vmem=jt.itri_vmem))
    got = trace(torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)),
                torch.from_numpy(ids), SEED, t.sph, t.quad, t.tri, t.sph_cl,
                t.quad_cl, t.tri_cl, t.mats, max_depth=depth, t_min=cfg.t_min,
                t_max=cfg.t_max, sky=t.sky, tri_live=t.tri_live, nee=t.nee,
                lights=t.lights, inst=t.inst).numpy()
    return ref, got


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("name", ["tlas", "two"])
def test_trace_depth1_matches_pallas(name, nee):
    ref, got = _trace_both(name, 1, False, nee)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert ref.mean() > 0


@pytest.mark.parametrize("name,nee", [("tlas", True), ("two", False)])
def test_trace_depth4_jittered_matches_pallas(name, nee):
    ref, got = _trace_both(name, 4, True, nee)
    close = (np.abs(got - ref).max(-1) <= 1e-4).mean()
    assert close >= 0.98, close
    assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


@pytest.mark.parametrize("nee", [False, True])
def test_segment_matches_pallas_segment(nee):
    """One 2-bounce segment at absolute depth 1 over the two-mesh scene,
    queue prefix COUNT of 512, incoming alive 1 or 2, random throughput
    and radiance: all 13 planes within 1e-5 and the alive plane equal on
    every slot; dead slots pass through in both packages."""
    jt, t, cfg, ids, o, d = _jax_inputs("two", 2, True, nee)
    rng = np.random.default_rng(9)
    r = W * H
    state = np.concatenate([
        np.array(o).T, np.array(d).T, rng.uniform(0.05, 1.0, (3, r)),
        rng.uniform(0.0, 1.0, (3, r)),
        rng.integers(1, 3 if nee else 2, (1, r))]).astype(np.float32)
    planes, alive = pallas_segment(
        jnp.asarray(ids, jnp.float32), tuple(jnp.asarray(p) for p in state),
        jt.sph, jt.quad, jt.tri, jt.sph_cl, jt.quad_cl, jt.tri_cl, jt.mats,
        jt.lights, jnp.asarray([SEED, 1, COUNT], jnp.int32), ROWS, 2,
        cfg.t_min, cfg.t_max, jt.sky, interpret=True, nee=nee, inst=jt.inst,
        itri_vmem=jt.itri_vmem)
    ref = np.stack([np.asarray(p) for p in planes] + [np.asarray(alive)])
    got = segment_slots(
        torch.from_numpy(ids), torch.from_numpy(state),
        torch.tensor([SEED, 1, COUNT], dtype=torch.int32), t.sph, t.quad,
        t.tri, t.sph_cl, t.quad_cl, t.tri_cl, t.mats, n_bounces=2,
        t_min=cfg.t_min, t_max=cfg.t_max, sky=t.sky, tri_live=t.tri_live,
        nee=t.nee, lights=t.lights, inst=t.inst).numpy()
    assert got.shape == ref.shape == (PLANES, r)
    np.testing.assert_array_equal(got[12], ref[12])
    np.testing.assert_allclose(got[:12, :COUNT], ref[:12, :COUNT], rtol=0,
                               atol=1e-5)
    assert 0 < got[12, :COUNT].sum() and got[12, :COUNT].min() == 0
    for out in (got, ref):
        np.testing.assert_array_equal(out[:12, COUNT:], state[:12, COUNT:])
        assert not out[12, COUNT:].any()


# -------------------------------------------------------------- engines

def _render(engine, scene, w=24, h=16, depth=6, frames=2, **cfg_kw):
    cfg = T.RenderConfig(width=w, height=h, max_depth=depth, seed=3, **cfg_kw)
    film = T.Film(w, h, "cpu")
    r = T.create_renderer(engine, "cpu")
    r.init(film, scene, T.Camera(EYE, DIR, float(w), float(h), 100.0), cfg)
    for _ in range(frames):
        r.progressive_render()
    return film.hdr_average(), r


def test_instanced_and_baked_films_agree():
    """The instanced scene and the same transforms baked with add_mesh
    render within an HDR RMSE of 1e-3 over 4 frames (the same pixel-keyed
    streams; only the transform's rounding differs: local-space tests
    against world-space ones, and the ordinals that break ties)."""
    films = []
    for instanced in (True, False):
        film, r = _render("fused", make_scene("two", T.Scene, instanced),
                          w=24, h=16, depth=4, frames=4)
        assert (r._tables.inst is not None) == instanced
        films.append(film)
    rmse = float((films[0] - films[1]).pow(2).mean().sqrt())
    assert rmse < 1e-3, rmse
    assert films[0].mean() > 0


@pytest.mark.parametrize("cfg_kw", [dict(), dict(nee=True,
                                                 russian_roulette_depth=2)])
def test_engines_bit_equal_on_instances(cfg_kw):
    """Tolerance 0: wavefront_fused (its default schedule and a
    one-bounce one), fused and tlas render the same film of an instanced
    scene, with and without NEE and roulette."""
    ref, r = _render("fused", make_scene("two", T.Scene), **cfg_kw)
    assert r._tables.inst is not None and r._tables.nee == ("nee" in cfg_kw)
    for engine, attrs in (("wavefront_fused", {}),
                          ("wavefront_fused", dict(schedule=(1,))),
                          ("tlas", {})):
        scene = make_scene("two", T.Scene)
        cfg = T.RenderConfig(width=24, height=16, max_depth=6, seed=3,
                             **cfg_kw)
        film = T.Film(24, 16, "cpu")
        e = T.create_renderer(engine, "cpu")
        for k, v in attrs.items():
            setattr(e, k, v)
        e.init(film, scene, T.Camera(EYE, DIR, 24.0, 16.0, 100.0), cfg)
        for _ in range(2):
            e.progressive_render()
        assert torch.equal(film.hdr_average(), ref), (engine, attrs)
    assert ref.mean() > 0


def test_tlas_engine_is_fused():
    r = T.create_renderer("tlas", "cpu")
    assert isinstance(r, FusedRenderer) and r.name == "tlas"
    assert "tlas" in T.available_engines()
    ref = T.create_renderer("tlas_ref", "cpu")  # the plain two-level walk
    assert not isinstance(ref, FusedRenderer) and ref.name == "tlas_ref"


def test_tri_heavy_counts_instanced_triangles():
    """The growing schedule follows the JAX engine's count: flat triangles
    plus each unique instanced mesh once.  A unique mesh of 1280 triangles
    instanced twice resolves (2, 6) at depth 8; four instances of the
    20-triangle icosahedron stay at segments of 3."""
    big = tmesh.subdivide(make_mesh("ico2"), 1)
    heavy = two_mesh_scene(T.Scene, ico20(), big)
    for scene, want in ((heavy, [2, 6]), (make_scene("tlas", T.Scene),
                                          [3, 3, 2])):
        r = T.create_renderer("wavefront_fused", "cpu")
        r.init(T.Film(8, 8, "cpu"), scene, T.default_camera(8, 8),
               T.RenderConfig(width=8, height=8, max_depth=8))
        assert r.segment_lengths() == want


def test_kernel_scene_struct_carries_instances():
    """scene_arg packs the instance tables' widths and records (the
    tables' own, made once with them) into PrtScene and refuses tables of
    the wrong shape."""
    t, _ = build_scene_tables(make_scene("two", T.Scene), "cpu")
    tabs = (t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl, t.tri_cl, t.mats)
    kw = dict(t_min=1e-3, t_max=1e16, sky=t.sky, tri_live=t.tri_live)
    cpu = torch.device("cpu")
    s = scene_arg(cpu, *tabs, **kw, inst=t.inst, records=t.records)
    assert (s.n_itri, s.n_iacc, s.n_inst) == (100, t.inst.iacc.shape[1], 4)
    assert s.itri == t.records.itri.data_ptr() and s.n_tri == 0
    assert scene_arg(cpu, *tabs, **kw).n_inst == 0
    bad = dataclasses.replace(t.inst, ibox=t.inst.ibox[:, :3].contiguous())
    with pytest.raises(ValueError, match="instance tables"):
        scene_arg(cpu, *tabs, **kw, inst=bad)
    with pytest.raises(NotImplementedError, match="item 13"):
        scene_arg(cpu, *tabs, **kw, inst=dataclasses.replace(
            t.inst, iacc=torch.zeros((10, 4))))


def test_remaining_refusals_raise():
    """Instances run, and so do their texture coordinates (with_uv: the
    31-row itri, also when the JAX package's comes through convert) and a
    checker on an instanced scene; what stays refused raises: the ordered
    instance trees (NotImplementedError), an itri of another row count
    and image textures on instance tables without texture coordinates
    (ValueError); the depth_out probe runs."""
    scene = make_scene("tlas", T.Scene)
    with pytest.raises(NotImplementedError, match="item 13"):
        pack_instance_tables(scene._inst_meshes, scene.instances, 3.0,
                             ordered=True)
    itri, iacc, ibox, inst = pack_instance_tables(
        scene._inst_meshes, scene.instances, 3.0, with_uv=True)
    assert itri.shape == (31, 20) and not itri[25:].any()  # no texcoords
    t, _ = build_scene_tables(scene, "cpu")
    args = (t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl, t.tri_cl, t.mats)
    carried = convert.tables_from_numpy(*(a.numpy() for a in args), t.sky,
                                        "cpu", inst=(itri, iacc, ibox, inst))
    assert carried.inst.itri.shape == (31, 20)
    with pytest.raises(ValueError, match="itri"):
        convert.tables_from_numpy(*(a.numpy() for a in args), t.sky, "cpu",
                                  inst=(itri[:28], iacc, ibox, inst))
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(4, 1)
    pix = torch.arange(4, dtype=torch.int32)
    kw = dict(max_depth=2, t_min=1e-3, t_max=1e16, sky=t.sky,
              tri_live=False, inst=t.inst)
    for fn in (trace, trace_reference):
        assert fn(o, d, pix, 1, *args, **kw).shape == (4, 3)
        assert fn(o, d, pix, 1, *args, **kw,
                  checker=((0.0, 2.0, 0.1, 0.2, 0.3),)).shape == (4, 3)
        with pytest.raises(ValueError, match="texture coordinates"):
            fn(o, d, pix, 1, *args, **kw, itex=((0.0, 0, 4, 4),),
               itex_tab=torch.zeros((1, 128)))
        rad, depth = fn(o, d, pix, 1, *args, **kw, depth_out=True)
        assert rad.shape == (4, 3) and depth.shape == (4,)
        assert depth.dtype == torch.float32
