"""The segment's queue form against the JAX package: the port's segment
(its plain version on the CPU) compacts the queue itself, where the JAX
engine runs ``pallas_segment`` over every slot and compacts after it
(``wavefront_fused._segmented_body``: one argsort of the sort keys, dead
slots keyed past every live key, and one gather).

Each scene's tables come from its own package's engine (the port's
``build_scene_tables`` and the JAX package's, equal as
tests/test_torch_segment.py and the other files show), the rays from the
JAX package, and the queue of 1024 slots (one 8x128 Pallas tile) has
COUNT live.  Tolerances: the survivors, matched by pixel id, have the
alive plane equal and the 12 other planes within the tolerance of the
scene's slot-for-slot test (SCENES), taken relative to values above 1
(the scenes here reach 35 units); the survivor count is equal; each sort
key equals the JAX package's ``_sort_key`` of the survivor's planes
exactly, and the key the JAX engine sorts by on the same share of the
survivors as the planes, rounded up to a whole survivor (a key quantises
the origin, so an origin within the tolerance can fall in the next
cell: every key that differs must have its origin in a cell next to
the JAX one's, on each axis).  CORNELL has 44 survivors, so its share
0.98 admits one: pixel 672's origin lies on the back wall, z = 0, which
is the scene box's midplane and so the edge of a cell of every Morton
level; the port's z is -4.8e-7 and the interpret kernel's 3.2e-8
(measured on an AVX-512 Xeon with jax 0.9.0; the exact hit lies on
z = 0, so there the interpret kernel's is the nearer), both within the
plane tolerance, on either side of the edge.  They part at the first
bounce's hit point on the floor: t and d are bit-equal, and the
interpret kernel's point is fma(t, d, o), a multiply-add XLA's CPU
backend contracts, where the port rounds t * d first (ROADMAP Queue 3).  An ended path's radiance,
written to ``rad[pix]``, is within the same tolerance, and no other pixel
of ``rad`` is written.  RANDOM_BALLS_LARGE has no slot-for-slot test of
its own: its origins and directions differ from the interpret kernel's by
up to 3.3e-3 after a bounce off its metal and glass spheres (measured;
throughput and radiance within 1e-6), so its bound is 1e-3 on 97% of the
survivors.  The queue-order tests are exact."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core.camera import Camera as JaxCamera  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402
from parallelraytracing_tpu.core.scene import \
    ply_showcase_scene as jax_showcase  # noqa: E402
from parallelraytracing_tpu.engines.tables import \
    build_scene_tables as jax_tables  # noqa: E402
from parallelraytracing_tpu.engines.wavefront_fused import \
    _sort_key as jax_sort_key  # noqa: E402
from parallelraytracing_tpu.ops.pallas_trace import pallas_segment  # noqa: E402
from parallelraytracing_tpu.ops.rays import \
    generate_camera_rays_ids as jax_rays  # noqa: E402

from torch_meshes import ICO_F, ICO_V, mesh_ply, tlas_scene  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch.core import mesh as tmesh  # noqa: E402
from parallelraytracing_tpu_torch.core.scene import ply_showcase_scene  # noqa: E402
from parallelraytracing_tpu_torch.engines.tables import build_scene_tables  # noqa: E402
from parallelraytracing_tpu_torch.engines.wavefront_fused import \
    segmented_trace  # noqa: E402
from parallelraytracing_tpu_torch.ops.segment import (DEAD_KEY,  # noqa: E402
                                                      segment,
                                                      segment_reference,
                                                      segment_slots)

W = H = 32  # 1024 slots: one 8x128 Pallas tile
ROWS = 8
COUNT = 700  # live queue prefix; slots 700.. are not read
SEED = 424242
MAX_DEPTH = 8

#: scene -> (NEE, rr_depth, depth0, plane tolerance, share of survivors
#: within it): the tolerance of the scene's slot-for-slot test
#: (tests/test_torch_segment.py, _nee.py, _instances.py); texture_demo's
#: is that of tests/test_torch_textures.py's depth-4 traces (its
#: slot-for-slot test runs a smaller scene, whose 1e-5 texture_demo's
#: ground quad, 9 units out, misses by up to 1.6e-5: measured)
SCENES = {"random_balls_large": (False, 0, 0, 1e-3, 0.97),
          "cornell": (True, 2, 2, 1e-4, 0.98),
          "ico2": (False, 0, 0, 1e-4, 0.99),
          "tlas": (False, 0, 1, 1e-5, 1.0),
          "texture_demo": (False, 0, 1, 1e-4, 0.99)}


def _ico20(mesh_cls):
    v = np.asarray(ICO_V, np.float64)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    return mesh_cls(v.astype(np.float32),
                    np.asarray(ICO_F, np.uint32).reshape(-1))


def _scenes(name, tmp_path):
    """(port Scene, JAX Scene, eye, look) of a named scene."""
    if name == "ico2":
        path = mesh_ply(tmp_path, "ico2")
        scene, eye, look = ply_showcase_scene(path)
        return scene, jax_showcase(path)[0], eye, look
    if name == "tlas":
        return (tlas_scene(T.Scene, _ico20(tmesh.Mesh)),
                tlas_scene(J.Scene, _ico20(tmesh.Mesh)), (0.0, 6.0, 14.0),
                (0.0, 1.0, 0.0))
    eye = (5.0, 5.0, 8.0) if name == "texture_demo" else None
    return (T.Scene(T.ScenePreset(name)), J.Scene(J.ScenePreset(name)), eye,
            (0.0, 0.0, 0.0))


def _queue(name, tmp_path):
    """The port's tables, the JAX tables, the config, and an input queue:
    (pixel ids, (13, 1024) state) from jittered camera rays, throughput
    and radiance drawn from a seed, alive 1 (or 1 and 2 under NEE)."""
    nee, rr_depth = SCENES[name][:2]
    scene, jscene, eye, look = _scenes(name, tmp_path)
    cfg = J.RenderConfig(width=W, height=H, max_depth=MAX_DEPTH, nee=nee,
                         russian_roulette_depth=rr_depth)
    jt, _ = jax_tables(jscene, cfg)
    t, _ = build_scene_tables(scene, "cpu", nee=nee)
    assert jt.nee == t.nee == nee
    assert np.allclose(np.asarray(jt.bb), np.asarray(t.bb), rtol=1e-12)
    if eye is None:
        params = jax_camera(W, H).ray_params()
    else:
        eye, look = np.asarray(eye, np.float64), np.asarray(look, np.float64)
        params = JaxCamera(eye, look - eye, float(W), float(H),
                           100.0).ray_params()
    ids = np.random.default_rng(5).permutation(W * H).astype(np.int32)
    o, d = jax_rays(jnp.asarray(params), W, H, jnp.asarray(ids), None, True,
                    pix_seed=jnp.uint32(987))
    rng = np.random.default_rng(9)
    r = W * H
    state = np.concatenate([
        np.array(o).T, np.array(d).T, rng.uniform(0.05, 1.0, (3, r)),
        rng.uniform(0.0, 1.0, (3, r)),
        rng.integers(1, 3 if nee else 2, (1, r))]).astype(np.float32)
    return t, jt, cfg, ids, state


def _jax_segment(jt, cfg, ids, state, depth0, n_bounces):
    """pallas_segment over the queue as the JAX engine calls it: the 13
    planes of every slot."""
    planes, alive = pallas_segment(
        jnp.asarray(ids, jnp.float32), tuple(jnp.asarray(p) for p in state),
        jt.sph, jt.quad, jt.tri, jt.sph_cl, jt.quad_cl, jt.tri_cl, jt.mats,
        jt.lights, jnp.asarray([SEED, depth0, COUNT], jnp.int32), ROWS,
        n_bounces, cfg.t_min, cfg.t_max, jt.sky, interpret=True,
        rr_depth=cfg.russian_roulette_depth, vmem_kinds=jt.vmem_kinds,
        nee=jt.nee, inst=jt.inst, itri_vmem=jt.itri_vmem,
        tri_cold=jt.tri_cold, itri_cold=jt.itri_cold, checker=jt.checker,
        tri_stream=jt.tri_stream, tri_pack=jt.tri_pack,
        tri_snode=jt.tri_snode, itex=jt.itex, itex_tab=jt.itex_tab)
    return [jnp.asarray(p) for p in planes], jnp.asarray(alive)


def _jax_compact(jt, planes, alive, ids, mode):
    """The JAX engine's compaction after a segment (_segmented_body): the
    survivors' (13, count) planes, pixel ids and keys, in its order."""
    alive_b = alive > 0.0
    key = (jax_sort_key(planes, *jt.bb, mode) if mode
           else jnp.arange(alive.shape[0], dtype=jnp.int32))
    order = jnp.argsort(jnp.where(alive_b, key, jnp.int32(2 ** 30)))
    count = int(jnp.sum(alive_b.astype(jnp.int32)))
    mat = jnp.take(jnp.stack([*planes, alive]), order, axis=1)
    return (np.asarray(mat)[:, :count], ids[np.asarray(order)][:count],
            np.asarray(key[order])[:count])


def _port_segment(t, cfg, ids, state, depth0, n_bounces, mode, fn=segment):
    """The port's segment over the queue: (state_out, pix_out, key_out,
    count_out as an int, rad), rad filled with NaN before it."""
    rad = torch.full((W * H, 3), float("nan"))
    s, p, k, c = fn(torch.from_numpy(ids), torch.from_numpy(state),
                    torch.tensor([COUNT], dtype=torch.int32), rad, t, cfg,
                    seed=SEED, depth0=depth0, n_bounces=n_bounces,
                    sort_rays=mode)
    return s, p, k, int(c), rad


def _by_pixel(pix, *cols):
    """Columns reordered by ascending pixel id."""
    order = np.argsort(pix, kind="stable")
    return (pix[order],) + tuple(c[..., order] for c in cols)


def _assert_close(got, ref, atol, share):
    bound = atol * np.maximum(1.0, np.abs(ref))
    close = (np.abs(got - ref) <= bound).all(0).mean()
    assert close >= share, close


def _assert_keys_close(g_state, w_state, g_key, w_key, bb, share):
    """The port's keys equal the JAX engine's but on (1 - share) of the
    survivors, rounded up, and where they differ each origin coordinate's
    cell is the JAX one's or next to it."""
    diff = g_key != w_key
    assert diff.sum() <= np.ceil((1.0 - share) * len(g_key) - 1e-9), \
        (diff.sum(), len(g_key))
    lo, ie = (np.asarray(x, np.float32) for x in bb)

    def cells(o):
        q = (o.T - lo) * ie * np.float32(1024.0)
        return np.clip(q, 0.0, 1023.0).astype(np.int32)
    gap = np.abs(cells(g_state[0:3, diff]) - cells(w_state[0:3, diff]))
    assert (gap <= 1).all(), gap


@pytest.mark.parametrize("name", list(SCENES))
def test_queue_matches_pallas_segment_and_jax_compaction(tmp_path, name):
    """One 2-bounce segment over a queue of COUNT live slots: the port's
    queue form against pallas_segment followed by the JAX engine's
    compaction, under the "octant", "origin" and "" keys."""
    nee, rr_depth, depth0, atol, share = SCENES[name]
    t, jt, cfg, ids, state = _queue(name, tmp_path)
    planes, alive = _jax_segment(jt, cfg, ids, state, depth0, 2)
    ref = np.stack([np.asarray(p) for p in planes] + [np.asarray(alive)])
    live = ids[:COUNT]
    ended = live[ref[12, :COUNT] == 0.0]
    assert 0 < len(ended) < COUNT  # some paths end, some go on
    for mode in ("octant", "origin", ""):
        j_state, j_pix, j_key = _jax_compact(jt, planes, alive, ids, mode)
        s, p, k, c, rad = _port_segment(t, cfg, ids, state, depth0, 2, mode)
        assert c == len(j_pix)
        g_pix, g_state, g_key = _by_pixel(
            p[:c].numpy(), s[:, :c].numpy(),
            k[:c].numpy() if mode else np.zeros(c))
        w_pix, w_state, w_key = _by_pixel(j_pix, j_state, j_key)
        np.testing.assert_array_equal(g_pix, w_pix)
        np.testing.assert_array_equal(g_state[12], w_state[12])
        _assert_close(g_state[:12], w_state[:12], atol, share)
        if mode:
            own = np.asarray(jax_sort_key([jnp.asarray(x) for x in g_state],
                                          *jt.bb, mode))
            np.testing.assert_array_equal(g_key, own)
            _assert_keys_close(g_state, w_state, g_key, w_key, t.bb, share)
            assert (k[c:] == DEAD_KEY).all() and (k[:c] < 2 ** 30).all()
        else:
            assert k is None
        # the ended paths' radiance, at their pixels, and nothing else
        written = torch.isfinite(rad).all(1).numpy()
        assert sorted(np.nonzero(written)[0]) == sorted(ended)
        slot_of = {int(px): i for i, px in enumerate(ids[:COUNT])}
        want = np.stack([ref[9:12, slot_of[int(px)]] for px in ended], 1)
        _assert_close(rad.numpy()[ended].T, want, atol, share)


@pytest.mark.parametrize("name", ["cornell", "ico2"])
def test_queue_order_does_not_change_the_result(tmp_path, name):
    """Tolerance 0: a permuted live prefix gives the same radiance and the
    same survivors (matched by pixel id: planes and keys bit for bit),
    NEE's mark and roulette included on CORNELL."""
    t, _, cfg, ids, state = _queue(name, tmp_path)
    depth0 = SCENES[name][2]
    perm = np.concatenate([np.random.default_rng(3).permutation(COUNT),
                           np.arange(COUNT, W * H)])
    runs = [_port_segment(t, cfg, ids[x], np.ascontiguousarray(state[:, x]),
                          depth0, 3, "octant")
            for x in (np.arange(W * H), perm)]
    (s0, p0, k0, c0, rad0), (s1, p1, k1, c1, rad1) = runs
    assert c0 == c1 > 0
    a = _by_pixel(p0[:c0].numpy(), s0[:, :c0].numpy(), k0[:c0].numpy())
    b = _by_pixel(p1[:c1].numpy(), s1[:, :c1].numpy(), k1[:c1].numpy())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(rad0.numpy(), rad1.numpy())


@pytest.mark.parametrize("count", [0, 1, 31, 33, COUNT])
def test_queue_is_the_slot_step_compacted(tmp_path, count):
    """Tolerance 0: the queue form is ``segment_slots``' step over the
    live prefix with its survivors gathered in queue order, their keys
    those of ``segment_reference``'s own planes, the ended slots'
    radiance scattered to their pixels; at the frame's last depth every
    path ends and no survivor is left."""
    t, _, cfg, ids, state = _queue("cornell", tmp_path)
    assert t.nee and cfg.russian_roulette_depth == 2
    slots = segment_slots(torch.from_numpy(ids), torch.from_numpy(state),
                          torch.tensor([SEED, 2, count], dtype=torch.int32),
                          t, cfg, n_bounces=2)
    for max_depth in (MAX_DEPTH, 4):  # 4: this segment is the frame's last
        rad = torch.full((W * H, 3), float("nan"))
        s, p, k, c = segment_reference(
            torch.from_numpy(ids), torch.from_numpy(state),
            torch.tensor([count], dtype=torch.int32), rad, t,
            dataclasses.replace(cfg, max_depth=max_depth), seed=SEED,
            depth0=2, n_bounces=2, sort_rays="origin")
        live = torch.arange(W * H) < count
        keep = live & (slots[12] > 0) & (max_depth > 4)
        assert int(c) == int(keep.sum())
        assert torch.equal(s[:, :int(c)], slots[:, keep])
        assert torch.equal(p[:int(c)], torch.from_numpy(ids)[keep])
        assert torch.equal(k[int(c):], torch.full((W * H - int(c),),
                                                  DEAD_KEY, dtype=torch.int32))
        ended = live & ~keep
        pix = torch.from_numpy(ids).long()
        assert torch.equal(rad[pix[ended]], slots[9:12, ended].t())
        assert torch.isnan(rad[pix[~ended]]).all()


@pytest.mark.parametrize("sort_rays", ["octant", "origin", ""])
def test_segmented_trace_reads_but_never_writes_pix(tmp_path, sort_rays):
    """The engine's two queues take turns and its frame is the same bits
    under every sort key; the caller's pixel ids are left as they were."""
    scene, _, _ = ply_showcase_scene(mesh_ply(tmp_path, "ico2"))
    t, _ = build_scene_tables(scene, "cpu")
    cfg = T.RenderConfig(width=24, height=16, max_depth=6)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.permutation(24 * 16).astype(np.int32))
    o = torch.from_numpy(rng.uniform(-0.5, 0.5, (24 * 16, 3))
                         .astype(np.float32)) + torch.tensor([0.0, 1.0, 6.0])
    d = torch.from_numpy(rng.normal(size=(24 * 16, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    before = ids.clone()
    got = segmented_trace(t, o, d, ids, SEED, cfg, schedule=(1, 2, 3),
                          sort_rays=sort_rays)
    assert torch.equal(ids, before)
    want = segmented_trace(t, o, d, ids, SEED, cfg, schedule=(6,),
                           sort_rays="")
    assert torch.equal(got, want) and torch.isfinite(got).all()
