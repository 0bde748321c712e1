"""The port's ``sharded`` engine (engines/sharded.py), its segmented route
and its entry points, on the CPU: at 1x1 in this process and over a world
of 2 gloo ranks (tests/torch_dist.py).

Tolerances:
- ``render_frame_sharded_segmented`` (the segment kernel's plain version)
  on 2x1 against the JAX function (interpret mode) on 2 devices: >= 99.9%
  of pixels within 1e-5 (the trace tests' form); and bit-equal to the
  port's 1x1 frame in both pixel orders;
- the engine's film, gathered, against the port's ``fused`` engine (and on
  the segmented route ``wavefront_fused``): bit for bit, at 1x1 and 2x1,
  jitter off and on, CORNELL with NEE, an instanced scene, QMC with the
  thin lens, a mesh through the segmented route, and every frame gathered
  (``defer_gather`` off) — the JAX contracts of tests/test_parallel.py,
  test_feature_matrix.py and test_qmc.py (NEE there within 2e-5: XLA
  reassociates under shard_map; the port has no such pass);
- the CLI's PNG under a 2-rank launch: written by rank 0 only, equal to
  the 1x1 run's; the registry: the JAX package's engines exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402
from parallelraytracing_tpu.engines.tables import build_scene_tables as jax_tables  # noqa: E402
from parallelraytracing_tpu.parallel import sharding as JS  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
import torch_dist as td  # noqa: E402
from parallelraytracing_tpu_torch import cli  # noqa: E402
from parallelraytracing_tpu_torch.utils.png import read_png  # noqa: E402

# the Pallas interpret-mode deadlock under asynchronous dispatch
# (tests/test_torch_slice.py says why; set at collection)
jax.config.update("jax_cpu_enable_async_dispatch", False)

#: the segmented route: tests/test_parallel.py's mesh scene around the
#: level-2 icosphere (320 triangles; forced onto the route), 32x16, depth 6
SEG_SPEC = "mesh:ico2"
SEG = dict(width=32, height=16, max_depth=6, seed=7)
SEG_KEY = 4
SEG_ROUTE = dict(schedule=(2, 4), sort_rays="octant")

BASE = dict(width=48, height=32, max_depth=4, seed=5)
#: engine cases: (scene spec, config, the sharded engine's attributes, the
#: engine whose film it must equal)
CASES = {
    "material-no-jitter": ("material_test", dict(BASE, jitter=False), {},
                           "fused"),
    "material-jitter": ("material_test", BASE, {}, "fused"),
    "cornell-nee": ("cornell", dict(BASE, seed=1, jitter=False, nee=True),
                    {}, "fused"),
    "instanced": ("tlas:octa", dict(BASE, jitter=False), {}, "fused"),
    "qmc-lens": ("material_test", dict(BASE, qmc=True, lens_radius=0.2,
                                       focus_distance=6.0), {}, "fused"),
    "mesh-segmented": (SEG_SPEC, dict(BASE, max_depth=6, seed=7),
                       {"segmented": "1"}, "wavefront_fused"),
    "gather-every-frame": ("material_test", BASE, {"defer_gather": False},
                           "fused"),
}
FRAMES = 2
CLI_ARGV = ["--device", "cpu", "--engine", "sharded", "--scene", "cornell",
            "--width", "16", "--height", "12", "--frames", "2", "--depth",
            "3"]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The results of a world of 2 gloo ranks, computed once a module."""
    tmp = tmp_path_factory.mktemp("world2")
    tasks = [(f"film:{name}", "engine_film", (spec, cfg, FRAMES, attrs))
             for name, (spec, cfg, attrs, _) in CASES.items()]
    for morton in (False, True):
        tasks.append((f"seg:{morton}", "frame_kernel_route",
                      ("segmented", SEG_SPEC, SEG, SEG_KEY, 1, morton,
                       SEG_ROUTE)))
    tasks.append(("cli", "cli_run", (CLI_ARGV, str(tmp / "out{rank}.png"))))
    return td.run_world(2, tasks, tmp), tmp


def film_of(engine, spec, cfg_kw, frames=FRAMES, **attrs):
    cfg = T.RenderConfig(**cfg_kw)
    film = T.Film(cfg.width, cfg.height, "cpu")
    r = T.create_renderer(engine, "cpu")
    for k, v in attrs.items():
        setattr(r, k, v)
    r.init(film, td.make_scene(T, spec),
           T.default_camera(cfg.width, cfg.height), cfg)
    for _ in range(frames):
        r.progressive_render()
    r.gather_film()
    return film.hdr_average().numpy(), r


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_its_single_device_twin(world2, case):
    spec, cfg, attrs, twin = CASES[case]
    ref, _ = film_of(twin, spec, cfg)
    route = "segmented" if twin == "wavefront_fused" else "fused"
    one, r = film_of("sharded", spec, cfg, **attrs)
    assert r._mesh.shape == {"px": 1, "spp": 1}
    assert ("segmented" if r._use_seg else "fused") == route
    np.testing.assert_array_equal(one, ref)
    assert np.isfinite(ref).all() and ref.mean() > 0.01
    blocks = []
    for res in world2[0]:
        img, got_route, block = res[f"film:{case}"]
        assert got_route == route
        np.testing.assert_array_equal(img, ref)
        blocks.append(block)
    if attrs.get("defer_gather") is False:
        assert blocks == [None, None]
    else:  # each rank accumulated its own half of the slots
        half = cfg["width"] * cfg["height"] // 2
        assert blocks == [(0, half), (half, 2 * half)]


def test_segmented_route_matches_jax(world2):
    """The segmented route's frame on 2x1 (each rank's, gathered), against
    the JAX function on 2 devices, and bit-equal to the port's 1x1 frame
    in scanline and in Morton order."""
    from parallelraytracing_tpu_torch.parallel import sharding as S
    jcfg = J.RenderConfig(**SEG)
    tables, _ = jax_tables(td.make_scene(J, SEG_SPEC), jcfg,
                           allow_partial=False)
    cam = jnp.asarray(jax_camera(jcfg.width, jcfg.height).ray_params())
    mesh = JS.make_render_mesh(jax.devices()[:2])
    # jitted, as the JAX engine runs it (shard_map dispatches op by op
    # otherwise: minutes)
    ref = np.asarray(jax.jit(lambda t, c, k: JS.render_frame_sharded_segmented(
        t, c, k, jcfg, mesh, rows=2, interpret=True, **SEG_ROUTE))(
            tables, cam, jax.random.PRNGKey(SEG_KEY)))
    from parallelraytracing_tpu_torch.engines.tables import build_scene_tables
    from parallelraytracing_tpu_torch.ops import rng
    cfg = T.RenderConfig(**SEG)
    one = S.render_frame_sharded_segmented(
        build_scene_tables(td.make_scene(T, SEG_SPEC), "cpu")[0],
        torch.from_numpy(T.default_camera(cfg.width, cfg.height).ray_params()),
        rng.prng_key(SEG_KEY), cfg, S.make_render_mesh(), **SEG_ROUTE).numpy()
    share = float((np.abs(one - ref).max(-1) <= 1e-5).mean())
    assert share >= 0.999, share
    for res in world2[0]:
        for morton in (False, True):
            np.testing.assert_array_equal(res[f"seg:{morton}"], one)


def test_cli_sharded_writes_png(world2, tmp_path, capsys):
    """``--engine sharded --device cpu``: the 1x1 mesh without a launcher;
    under a 2-rank launch rank 0 alone writes, the same image."""
    out = tmp_path / "sharded.png"
    assert cli.main(CLI_ARGV + ["--out", str(out)]) == 0
    assert "engine=sharded" in capsys.readouterr().out
    img = read_png(str(out))
    assert img.shape == (12, 16, 4)
    results, tmp = world2
    assert [res["cli"] for res in results] == [(0, True), (0, False)]
    np.testing.assert_array_equal(read_png(str(tmp / "out0.png")), img)


def test_registry_equals_jax():
    assert set(T.available_engines()) == set(J.available_engines())
    assert "sharded" in T.available_engines()
