"""The port's trace module against ``pallas_trace`` (Pallas interpret mode).

The JAX package's own packed tables go through ``convert.tables_from_numpy``
into the port's trace, with the same rays and seeds (made by the JAX
package and handed over as numpy), so this holds the port's kernel module
to the TPU kernel independently of the port's packer.  On the CPU the
port's ``trace`` runs its plain PyTorch version.

Tolerances: at depth 1 without jitter every ray's radiance agrees within
1e-5 absolute.  At depth 4 with jitter, >= 98% of rays agree within 1e-4
and the mean radiance within 1e-3 relative: XLA on the CPU and PyTorch
round sqrt, sin and cos (and XLA contracts multiply-adds) differently, and
a last-bit difference at a grazing hit sends a few paths elsewhere."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from parallelraytracing_tpu import Scene as JaxScene  # noqa: E402
from parallelraytracing_tpu import ScenePreset as JaxPreset  # noqa: E402
from parallelraytracing_tpu.config import RenderConfig as JaxConfig  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402
from parallelraytracing_tpu.engines.tables import \
    build_scene_tables as jax_tables  # noqa: E402
from parallelraytracing_tpu.ops.pallas_trace import pallas_trace  # noqa: E402
from parallelraytracing_tpu.ops.rays import \
    generate_camera_rays_ids as jax_rays  # noqa: E402

from parallelraytracing_tpu_torch import convert  # noqa: E402
from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference  # noqa: E402

W = H = 32  # 1024 rays: one 8x128 Pallas tile
SEED = 424242


def _both(preset, depth, jitter):
    cfg = JaxConfig(width=W, height=H, max_depth=depth, jitter=jitter)
    jt, _ = jax_tables(JaxScene(JaxPreset(preset)), cfg)
    ids = np.random.default_rng(5).permutation(W * H).astype(np.int32)
    o, d = jax_rays(jnp.asarray(jax_camera(W, H).ray_params()), W, H,
                    jnp.asarray(ids), None, jitter, pix_seed=jnp.uint32(987))
    ref = np.asarray(pallas_trace(
        o, d, jnp.asarray(ids, jnp.float32), jt.sph, jt.quad, jt.tri,
        jt.sph_cl, jt.quad_cl, jt.tri_cl, jt.mats, jt.lights,
        jnp.asarray([SEED], jnp.int32), 8, depth, cfg.t_min, cfg.t_max,
        jt.sky, interpret=True))
    t = convert.tables_from_numpy(
        *(np.asarray(a) for a in (jt.sph, jt.quad, jt.tri, jt.sph_cl,
                                  jt.quad_cl, jt.tri_cl, jt.mats)),
        jt.sky, "cpu")
    got = trace(torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)),
                torch.from_numpy(ids), SEED, t.sph, t.quad, t.tri, t.sph_cl,
                t.quad_cl, t.tri_cl, t.mats, max_depth=depth, t_min=cfg.t_min,
                t_max=cfg.t_max, sky=t.sky, tri_live=t.tri_live).numpy()
    return ref, got


@pytest.mark.parametrize("preset", ["random_balls_large", "material_test"])
def test_depth1_matches_pallas(preset):
    ref, got = _both(preset, 1, False)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("preset", ["material_test", "random_balls_large"])
def test_depth4_jittered_matches_pallas(preset):
    ref, got = _both(preset, 4, True)
    close = (np.abs(got - ref).max(1) <= 1e-4).mean()
    assert close >= 0.98, close
    assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


def test_features_outside_the_slice_raise():
    from parallelraytracing_tpu_torch import Scene, ScenePreset
    from parallelraytracing_tpu_torch.engines.tables import build_scene_tables
    t, _ = build_scene_tables(Scene(ScenePreset.MATERIAL_TEST), "cpu")
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(4, 1)
    pix = torch.arange(4, dtype=torch.int32)
    args = (o, d, pix, 1, t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl,
            t.tri_cl, t.mats)
    kw = dict(max_depth=2, t_min=1e-3, t_max=1e16, sky=t.sky, tri_live=False)
    for fn in (trace, trace_reference):
        assert fn(*args, **kw).shape == (4, 3)
        for extra in (dict(checker=((1.0,),)),
                      dict(itex=((1,),)), dict(depth_out=True),
                      dict(collect_stats=True), dict(sky=(0.1,) * 13)):
            with pytest.raises(NotImplementedError):
                fn(*args, **{**kw, **extra})
