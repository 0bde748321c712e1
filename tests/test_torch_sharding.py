"""The port's multi-device mesh (parallel/sharding.py) against the JAX
package's, on worlds of 1, 2 and 4 gloo ranks (tests/torch_dist.py) in
the role of the JAX tests' virtual CPU devices; the JAX side runs here on
``jax.devices()[:n]`` of the conftest's 8, Pallas in interpret mode.

Tolerances:
- the mesh's shape and each rank's place and groups, ``shard_block_size``
  and the sample streams' seed offsets: exact;
- ``generate_camera_rays_flat``: o and d within 1e-6 (XLA's CPU rsqrt and
  norm round a direction's last bit otherwise than IEEE 1 / sqrt: ROADMAP
  Queue 3, "the JAX raygen's float32 normalisation differs by host");
- ``render_frame_sharded`` (the plain tracer) against
  ``render_frame_sharded_jit`` on a mesh of the same shape: rtol and atol
  1e-5 (tests/test_parallel.py's), MATERIAL_TEST on 2x1 and CORNELL
  (jittered) on 2x2;
- ``render_frame_sharded_fused`` (the trace kernel's plain version): 1x1,
  2x1 and 4x1, in scanline and in Morton order, bit-equal to each other
  (the determinism contract of tests/test_parallel.py's
  test_sharded_fused_invariant_to_device_count_and_layout); each, and 1x2
  (the spp stream offset), >= 99.9% of pixels within 1e-5 of the JAX
  function on the same mesh (the trace tests' form).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402
from parallelraytracing_tpu.engines.tables import build_scene_tables as jax_tables  # noqa: E402
from parallelraytracing_tpu.ops import rays as JR  # noqa: E402
from parallelraytracing_tpu.parallel import sharding as JS  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
import torch_dist as td  # noqa: E402
from parallelraytracing_tpu_torch.ops import rays as R  # noqa: E402
from parallelraytracing_tpu_torch.ops import rng  # noqa: E402
from parallelraytracing_tpu_torch.parallel import sharding as S  # noqa: E402

# the Pallas interpret-mode deadlock under asynchronous dispatch
# (tests/test_torch_slice.py says why; set at collection)
jax.config.update("jax_cpu_enable_async_dispatch", False)

#: tests/test_parallel.py's small_cfg
PLAIN = dict(width=32, height=16, max_depth=4, samples_per_frame=1, seed=3,
             intersect_chunk=16, ray_tile=1 << 10, jitter=False)
#: tests/test_parallel.py's fused-route configuration
FUSED = dict(PLAIN, width=64, height=32, jitter=True)
FUSED_KEY = 7
MESHES = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)]


def _route(spp, morton):
    return ("frame_kernel_route", ("fused", "material_test", FUSED,
                                   FUSED_KEY, spp, morton))


#: what each world computes: every rank runs every task
TASKS = {
    1: [("mesh", "mesh_info", ([1],)),
        ("fused_1", *_route(1, False)), ("fused_1m", *_route(1, True))],
    2: [("mesh", "mesh_info", ([1, 2],)),
        ("plain_material_test", "frame_plain",
         ("material_test", PLAIN, 0, 1)),
        ("fused_1", *_route(1, False)), ("fused_1m", *_route(1, True)),
        ("fused_2", *_route(2, False))],
    4: [("mesh", "mesh_info", ([1, 2, 4],)),
        ("plain_cornell", "frame_plain",
         ("cornell", dict(PLAIN, jitter=True), 1, 2)),
        ("fused_1", *_route(1, False)), ("fused_1m", *_route(1, True))],
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """world(n): the ranks' results of TASKS[n], computed once a module."""
    done = {}

    def get(n):
        if n not in done:
            done[n] = td.run_world(n, TASKS[n],
                                   tmp_path_factory.mktemp(f"world{n}"))
        return done[n]
    return get


def jax_mesh(n, spp):
    return JS.make_render_mesh(jax.devices()[:n], spp_axis=spp)


@pytest.mark.parametrize("n,spp", MESHES)
def test_mesh_matches_jax(world, n, spp):
    ref = jax_mesh(n, spp)
    ids = np.vectorize(lambda dev: dev.id)(ref.devices) - jax.devices()[0].id
    for rank, res in enumerate(world(n)):
        m = res["mesh"][spp]
        assert m["shape"] == dict(ref.shape)
        assert m["ranks"] == ids.tolist()
        assert ids[m["px_i"], m["spp_i"]] == rank
        spp_row = ids[m["px_i"]].tolist()
        px_col = ids[:, m["spp_i"]].tolist()
        assert m["spp_group"] == (spp_row if spp > 1 else None)
        assert m["px_group"] == (px_col if n // spp > 1 else None)


@pytest.mark.parametrize("width,height", [(32, 16), (33, 7), (1920, 1080)])
def test_shard_block_size_exact(width, height):
    for n, spp in MESHES + [(8, 1), (8, 2)]:
        cfg = T.RenderConfig(width=width, height=height)
        mesh = S.RenderMesh({"px": n // spp, "spp": spp},
                            np.arange(n).reshape(n // spp, spp))
        jcfg = J.RenderConfig(width=width, height=height)
        assert S.shard_block_size(cfg, mesh) == JS.shard_block_size(
            jcfg, jax_mesh(n, spp))


FLAT_CASES = {
    "key-jitter": dict(key=True, jitter=True),
    "key-lens": dict(key=True, jitter=True, lens=(0.2, 6.0)),
    "key-lens-no-jitter": dict(key=True, jitter=False, lens=(0.2, 6.0)),
    "centers": dict(jitter=False),
    "pixel-keyed-qmc-lens": dict(seed=0x6F1A2B3C, jitter=True,
                                 lens=(0.2, 6.0), qpt=True),
}


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
@pytest.mark.parametrize("start", [0, 300, 500])
def test_camera_rays_flat_matches_jax(case, start):
    """A 160-ray block of a 24x16 frame (ids from `start`, past H*W for
    the last two starts: dummy rays, finite)."""
    c = FLAT_CASES[case]
    w, h, count = 24, 16, 160
    cam = jax_camera(w, h).ray_params()
    jkey, key = jax.random.PRNGKey(5), rng.prng_key(5)
    qpt = JR.halton_qpt(3) if c.get("qpt") else None
    jo, jd = JR.generate_camera_rays_flat(
        jnp.asarray(cam), w, h, start, count,
        jkey if c.get("key") else None, c["jitter"], lens=c.get("lens"),
        pix_seed=(jnp.uint32(c["seed"]) if "seed" in c else None),
        qpt=None if qpt is None else jnp.asarray(qpt))
    o, d = R.generate_camera_rays_flat(
        torch.from_numpy(cam), w, h, start, count,
        key if c.get("key") else None, c["jitter"], lens=c.get("lens"),
        pix_seed=c.get("seed"), qpt=qpt)
    assert o.shape == d.shape == (count, 3)
    assert torch.isfinite(d).all()
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


@pytest.mark.parametrize("spp_i", [0, 1, 2, 3])
def test_spp_stream_offsets_match_jax(spp_i):
    """The int32 path seed and the uint32 jitter seed of stream spp_i, from
    frame seeds near the top of the int32 range (the offsets wrap) and
    below it; and the plain route's QMC rotation seed."""
    for seed0, jseed0 in ((0x7FFFFFF0, 0x7FFFFFFE), (12345, 0),
                          (1234567890, 2000000000)):
        jseed, jj = JS._spp_stream_offset(jnp.int32(seed0), jnp.int32(jseed0),
                                          jnp.int32(spp_i))
        seed, j = S._spp_stream_offset(seed0, jseed0, spp_i)
        assert seed == int(np.asarray(jseed)[0])
        assert j == int(np.asarray(jj))
        assert jj.dtype == jnp.uint32 and jseed.dtype == jnp.int32
    q = int(np.asarray(JR.qmc_rotation_seed(3)))
    jp = int(np.asarray((jnp.int32(q) + jnp.int32(spp_i)
                         * jnp.int32(S.SPP_STEP)).astype(jnp.uint32)))
    assert (R.qmc_rotation_seed(3) + spp_i * S.SPP_STEP) & rng.MASK32 == jp


@pytest.mark.parametrize("n,spp,preset,key,jitter", [
    (2, 1, "material_test", 0, False), (4, 2, "cornell", 1, True)])
def test_render_frame_sharded_matches_jax(world, n, spp, preset, key,
                                          jitter):
    """The plain tracer's frame: each rank's gathered frame, and its block,
    against the JAX function on a mesh of the same shape; the spp axis
    averages distinct streams (CORNELL on 2x2)."""
    jcfg = J.RenderConfig(**dict(PLAIN, jitter=jitter))
    cam = jnp.asarray(jax_camera(jcfg.width, jcfg.height).ray_params())
    ref = np.asarray(JS.render_frame_sharded_jit(
        J.Scene(J.ScenePreset(preset)).build(), cam, jax.random.PRNGKey(key),
        jcfg, jax_mesh(n, spp)))
    blk = -(-jcfg.pixel_count // (n // spp))
    pad = np.concatenate([ref, np.zeros(((n // spp) * blk - len(ref), 3),
                                        np.float32)])
    for rank, res in enumerate(world(n)):
        whole, block = res[f"plain_{preset}"]
        np.testing.assert_allclose(whole, ref, rtol=1e-5, atol=1e-5)
        px_i = rank // spp
        real = min(blk, jcfg.pixel_count - px_i * blk)
        np.testing.assert_allclose(block[:real],
                                   pad[px_i * blk:][:real], rtol=1e-5,
                                   atol=1e-5)
    assert np.isfinite(ref).all()
    np.testing.assert_array_equal(world(n)[0][f"plain_{preset}"][0],
                                  world(n)[-1][f"plain_{preset}"][0])


@pytest.fixture(scope="module")
def jax_fused():
    """The JAX render_frame_sharded_fused frame (interpret mode) on a mesh
    of each shape, once a module."""
    jcfg = J.RenderConfig(**FUSED)
    tables, _ = jax_tables(J.Scene(J.ScenePreset.MATERIAL_TEST), jcfg)
    cam = jnp.asarray(jax_camera(jcfg.width, jcfg.height).ray_params())
    done = {}

    def get(n, spp):
        if (n, spp) not in done:
            mesh = jax_mesh(n, spp)
            # jitted, as the JAX engine runs it (faster to compile)
            done[n, spp] = np.asarray(jax.jit(
                lambda t, c, k: JS.render_frame_sharded_fused(
                    t, c, k, jcfg, mesh, rows=2, interpret=True))(
                        tables, cam, jax.random.PRNGKey(FUSED_KEY)))
        return done[n, spp]
    return get


def _close_share(a, b):
    return float((np.abs(a - b).max(-1) <= 1e-5).mean())


@pytest.mark.parametrize("n,spp", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_sharded_fused_route(world, jax_fused, n, spp):
    """Every rank's frame of the fused route; 1x1, 2x1 and 4x1 in both
    pixel orders bit-equal to the 1x1 scanline frame; each within the
    trace tests' bound of the JAX function on the same mesh."""
    ref = jax_fused(n, spp)
    base = world(1)[0]["fused_1"]
    for res in world(n):
        names = ["fused_2"] if spp == 2 else ["fused_1", "fused_1m"]
        for name in names:
            got = res[name]
            assert got.shape == (FUSED["width"] * FUSED["height"], 3)
            if spp == 1:
                np.testing.assert_array_equal(got, base)
            share = _close_share(got, ref)
            assert share >= 0.999, (name, share)
    if spp == 2:
        # two sample streams averaged: not a copy of stream 0
        assert not np.allclose(world(2)[0]["fused_2"], base)
