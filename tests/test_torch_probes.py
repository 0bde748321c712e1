"""The trace's probes in the port against the JAX package: ``depth_out``
(each ray's bounces entered alive) and ``collect_stats`` (the walk
counters), the fused engine's ``depth_sort`` built on them, and the
float32 peak micro's plain version.  The cases are defined here, with
the checks; tests/test_torch_probes_mesh.py and
tests/test_torch_probes_walks.py run the checks on the meshes, the
linear scan, the stream route and NEE through instances, and hold
depth_sort to the JAX engine.

``pallas_trace`` runs in Pallas interpret mode.  The presets and the dense
meshes reach the port's trace as the JAX package's own tables (through
``convert``, as tests/test_torch_trace.py does); the instanced and the
streamed scenes as the port's own tables, which equal the JAX package's
bit for bit (tests/test_torch_instances.py, tests/test_torch_stream.py).
On the CPU the port's trace is its plain version: its depth comes from
its own bounce loop, its counters from the replay of the kernel's walks
(ops/walk_stats.py).

The JAX kernel counts one lockstep walk per (rows, 128) tile; the port
counts per ray.  Giving each of 8 rays a whole tile of identical copies
(same origin, direction and pixel id, so the same streams) makes a JAX
tile's walk that one ray's walk, and its counters [0:4] the ray's.  The 8
rays are the ones the port's counters rank at even steps among its 200
longest walks, so the walks reach leaves.

Tolerances: depths equal on every ray with NEE and roulette off; with
them, on >= 99.9% of rays (a last-bit throughput difference can flip a
roulette draw).  Counters equal exactly where no NEE shadow walk runs and
the triangles are dense.  With NEE on, leaves and primitives are equal
and the port's nodes are at most JAX's: the JAX kernel runs a shadow walk
every bounce even for a tile with no shadow ray, and its occluded lanes
keep following escape links (their t is -BIG, so no box passes: nodes,
no leaves); the port's walk stops at the occluder and runs only for a ray
that casts a shadow ray.  On the stream route the JAX kernel defers the
fold of a pending chunk, so its best t can lag the port's and a box can
pass for it that fails for the port: its counters are at least the
port's, and the replay holds the invariants of
tests/test_pallas.py::test_collect_stats_counters.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
import parallelraytracing_tpu.ops.pallas_trace as pt  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402
from parallelraytracing_tpu.engines.tables import \
    build_scene_tables as jax_tables  # noqa: E402
from parallelraytracing_tpu.engines.tables import \
    trace_tables as jax_trace_tables  # noqa: E402
from parallelraytracing_tpu.ops.rays import \
    generate_camera_rays_ids as jax_rays  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch import convert  # noqa: E402
from parallelraytracing_tpu_torch.benchmarks import micro, trace_stats  # noqa: E402
from parallelraytracing_tpu_torch.engines.tables import build_scene_tables  # noqa: E402
from parallelraytracing_tpu_torch.engines.wavefront_fused import \
    count_frame_rays  # noqa: E402
from parallelraytracing_tpu_torch.ops import pack  # noqa: E402
from parallelraytracing_tpu_torch.ops.trace import trace  # noqa: E402
from torch_meshes import make_mesh, stream_scene, tlas_scene  # noqa: E402

W, H = 32, 16  # 512 rays: one 4x128 Pallas tile
SEED = 424242
DEPTH = 4
#: rays given a replicated tile each, and the rank window they come from
REPS, RANK_WINDOW = 8, 200
MESH_EYE, MESH_DIR = (0.0, 4.0, 10.0), (0.0, -2.5, -10.0)
TLAS_EYE, TLAS_DIR = (0.0, 6.0, 14.0), (0.0, -5.0, -14.0)
#: name -> (scene, RenderConfig keywords, port tables from JAX's through
#: convert); the presets take the default camera
CASES = {
    "material_test": ("material_test", {}, True),
    "random_balls_large": ("random_balls_large", {}, True),
    "ico2": ("ico2", {}, True),
    "tlas": ("tlas", {}, False),
    "cornell_nee": ("cornell", dict(nee=True), True),
    "rr_depth2": ("material_test", dict(russian_roulette_depth=2), True),
    "octa": ("octa", {}, True),
    "stream": ("stream", {}, False),
    "tlas_nee": ("tlas", dict(nee=True), False),
}


def _scene(kind, cls):
    if kind in ("ico2", "octa", "stream"):
        return stream_scene(cls, make_mesh("octa" if kind == "octa"
                                           else "ico2"))
    if kind == "tlas":
        return tlas_scene(cls, make_mesh("ico1"))
    return cls((T.ScenePreset if cls is T.Scene else J.ScenePreset)(kind))


def _camera(kind):
    if kind in ("ico2", "octa", "stream"):
        eye, direction = MESH_EYE, MESH_DIR
    elif kind == "tlas":
        eye, direction = TLAS_EYE, TLAS_DIR
    else:
        return jax_camera(W, H)
    return J.Camera(np.array(eye), np.array(direction), float(W), float(H),
                    100.0)


def _set_stream(on: bool):
    """Both packages' stream constants: threshold 64 and chunks of 32
    (the ico2 scene streams), or their defaults."""
    vals = (64, 32, 0) if on else _DEFAULTS
    pt.STREAM_THRESHOLD, pt.STREAM_CHUNK, pt.STREAM_NODE_ROWS = vals
    pack.STREAM_THRESHOLD, pack.STREAM_CHUNK = vals[:2] if on \
        else _PORT_DEFAULTS


_DEFAULTS = (pt.STREAM_THRESHOLD, pt.STREAM_CHUNK, pt.STREAM_NODE_ROWS)
_PORT_DEFAULTS = (pack.STREAM_THRESHOLD, pack.STREAM_CHUNK)


#: the cases whose frame's depths, and whose replicated rays' counters,
#: are held to the JAX kernel's
FRAME = ("material_test", "random_balls_large", "ico2", "tlas",
         "cornell_nee", "rr_depth2")
REPLICATED = ("random_balls_large", "octa", "ico2", "tlas", "cornell_nee",
              "tlas_nee", "stream")


@functools.lru_cache(maxsize=None)
def _run(name: str) -> dict:
    """One case through both packages at W x H, depth DEPTH, jitter on:
    the port's trace with both probes on the frame's rays (and without
    them), and one ``pallas_trace`` call with depth_out and collect_stats
    over the frame's rays (one tile of W * H // 128 rows, for a case of FRAME) and a tile of
    copies of each of the REPS chosen rays (rows 1 without the frame, for
    a case of REPLICATED)."""
    kind, cfg_kw, via_convert = CASES[name]
    frame, replicated = name in FRAME, name in REPLICATED
    _set_stream(kind == "stream")
    try:
        cfg = J.RenderConfig(width=W, height=H, max_depth=DEPTH, jitter=True,
                             **cfg_kw)
        jt, _ = jax_tables(_scene(kind, J.Scene), cfg)
        if via_convert:
            t = convert.tables_from_numpy(
                *(np.asarray(a) for a in (jt.sph, jt.quad, jt.tri, jt.sph_cl,
                                          jt.quad_cl, jt.tri_cl, jt.mats)),
                jt.sky, "cpu", lights=np.asarray(jt.lights), nee=jt.nee)
        else:
            t, _ = build_scene_tables(_scene(kind, T.Scene), "cpu",
                                      nee=cfg.nee)
        assert t.nee == jt.nee == cfg.nee
        assert (t.stream is not None) == (kind == "stream")
        ids = np.random.default_rng(5).permutation(W * H).astype(np.int32)
        o, d = jax_rays(jnp.asarray(_camera(kind).ray_params()), W, H,
                        jnp.asarray(ids), None, True, pix_seed=jnp.uint32(987))
        o, d = np.array(o), np.array(d)
        tcfg = T.RenderConfig(width=W, height=H, max_depth=DEPTH, jitter=True,
                              **cfg_kw)
        rays = (torch.from_numpy(o), torch.from_numpy(d),
                torch.from_numpy(ids), SEED)
        rad, depth, stats = trace(*rays, t, tcfg, depth_out=True,
                                  collect_stats=True)
        out = dict(t=t, cfg=tcfg, rays=rays, rad=rad, depth=depth,
                   stats=stats, plain=trace(*rays, t, tcfg))
        order = np.argsort(-stats[:, 0].numpy(), kind="stable")
        sel = order[np.linspace(0, RANK_WINDOW, REPS).astype(int)]
        rows = W * H // 128 if frame else 1
        parts = [([o], [d], [ids])] if frame else []
        if replicated:
            parts.append(([np.repeat(o[sel], rows * 128, 0)],
                          [np.repeat(d[sel], rows * 128, 0)],
                          [np.repeat(ids[sel], rows * 128, 0)]))
        jo, jd, jids = (np.concatenate([p[k][0] for p in parts])
                        for k in range(3))
        _, jdepth, jstats = jax_trace_tables(
            jt, jnp.asarray(jo), jnp.asarray(jd),
            jnp.asarray(jids, jnp.float32), jnp.asarray([SEED], jnp.int32),
            rows, cfg, True, collect_stats=True, depth_out=True)
        out.update(sel=sel, jdepth=np.asarray(jdepth)[:W * H] if frame
                   else None,
                   jstats=np.asarray(jstats)[-REPS:, :4] if replicated
                   else None)
        return out
    finally:
        _set_stream(False)


# ------------------------------------------------- the checks, per case
#
# tests/test_torch_probes_mesh.py and tests/test_torch_probes_walks.py run
# the same checks on the other cases (three files, so that the Pallas
# interpret runs spread over the test workers).

def check_depth_out(name):
    """depth_out equals pallas_trace(depth_out=True) per ray (exactly with
    NEE and roulette off, on >= 99.9% of rays with them), and its sum is
    count_frame_rays' count of ray segments."""
    r = _run(name)
    got = r["depth"].numpy()
    assert got.dtype == np.float32 and got.shape == (W * H,)
    if CASES[name][1]:
        assert (got == r["jdepth"]).mean() >= 0.999
    else:
        np.testing.assert_array_equal(got, r["jdepth"])
    assert int(got.sum()) == count_frame_rays(r["t"], *r["rays"], r["cfg"])
    assert 1 <= got.min() and got.max() <= DEPTH and got.max() > 1


def check_stats_exact(name):
    """NEE off, dense: the port's per-ray counters equal the JAX kernel's
    per-tile counters on tiles of one ray's copies, exactly; the walks
    chosen reach leaves of the kind under test."""
    r = _run(name)
    got = r["stats"][r["sel"]].numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, r["jstats"])
    assert got[:, 2].sum() > 0 and (got[:, 0] >= got[:, 1]).all()


def check_stats_nee(name):
    """NEE on: leaves, primitives and bounces equal, nodes at most the JAX
    kernel's (the module's note)."""
    r = _run(name)
    got, want = r["stats"][r["sel"]].numpy(), r["jstats"]
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    assert (got[:, 0] <= want[:, 0]).all()
    return got, want


def check_radiance(name):
    """With the probes on, the radiance is the trace's bit for bit."""
    r = _run(name)
    assert torch.equal(r["rad"], r["plain"])


# ------------------------------------------------------------- presets

@pytest.mark.parametrize("name", ["material_test", "random_balls_large",
                                  "cornell_nee", "rr_depth2"])
def test_depth_out_matches_pallas(name):
    check_depth_out(name)


def test_collect_stats_matches_pallas():
    """The sphere tree of random_balls_large."""
    check_stats_exact("random_balls_large")


def test_collect_stats_with_nee():
    """cornell's kinds are all tiny: plain loops count nothing, so the
    counters are the bounces alone (the instanced scene's NEE walks are
    in tests/test_torch_probes_walks.py)."""
    got, _ = check_stats_nee("cornell_nee")
    assert not got[:, :3].any() and got[:, 3].min() >= 1


@pytest.mark.parametrize("name", ["random_balls_large", "cornell_nee"])
def test_probes_leave_the_radiance_alone(name):
    check_radiance(name)


# ------------------------------------------------------------- fp32_peak

@pytest.mark.parametrize("mix", ["fma", "slab"])
def test_fp32_peak_plain_matches_jax_chains(mix):
    """The plain version of the micro's chains against a numpy replay of
    the JAX kernel's arithmetic (benchmarks/micro.py l.49-89, float32,
    each multiply and add rounded): within 1 ulp of the output per chain
    step (loops 4: 8 multiply-adds a chain for "fma", 4 for "slab", 8
    chains summed)."""
    loops = 4
    x = np.linspace(0.25, 1.0, 1000, dtype=np.float32)
    f32 = np.float32
    acc = [x * f32(0.5 + 0.05 * k) for k in range(8)]
    for _ in range(loops):
        if mix == "fma":
            acc = [a * f32(1.0 + (k + 1) * 1e-7) + f32((k + 1) * 1e-7)
                   for k, a in enumerate(acc)]
            acc = [a * f32(1.0 - (k + 1) * 1e-7) - f32((k + 1) * 1e-7)
                   for k, a in enumerate(acc)]
        else:
            a, b, c, d, e, f, g, h = acc
            a = a * f32(1.0000001) - f32(1e-7)
            b = b * f32(0.9999999) + f32(1e-7)
            c = c * f32(1.0000002) - f32(2e-7)
            d = d * f32(0.9999998) + f32(2e-7)
            e = e * f32(1.0000003) - f32(3e-7)
            f = f * f32(0.9999997) + f32(3e-7)
            g = g * f32(1.0000004) - f32(4e-7)
            h = h * f32(0.9999996) + f32(4e-7)
            a, b = np.minimum(a, e), np.maximum(b, f)
            c, d = np.minimum(c, g), np.maximum(d, h)
            e, f = np.maximum(e, f32(0.1)), np.minimum(f, f32(10.0))
            g, h = np.where(g > c, g, c), np.where(h < d, h, d)
            acc = [a, b, c, d, e, f, g, h]
    want = acc[0]
    for a in acc[1:]:
        want = want + a
    got = micro.peak_chains(torch.from_numpy(x), loops, mix).numpy()
    steps = loops * (2 if mix == "fma" else 1)
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert got.dtype == np.float32 and ulps.max() <= steps * 8


@pytest.mark.parametrize("mix", ["fma", "slab"])
def test_fp32_peak_chains_do_not_settle(mix):
    """The chains drift with every iteration, so a kernel that ran half
    its loops would miss the plain version by more than chip_smoke's
    1e-6 relative tolerance (at 128 loops on the ramp)."""
    x = torch.linspace(0.25, 1.0, 1024)
    full = micro.peak_chains_reference(x, 128, mix)
    half = micro.peak_chains_reference(x, 64, mix)
    assert float(((full - half).abs() / full.abs()).max()) > 1e-6


def test_fp32_peak_counts():
    """Operations in the JAX micro's unit (a multiply-add counted once)
    and floating-point operations (counted twice); fp32_peak measures
    only on a card."""
    assert micro.operations("fma", 4, 10) == 10 * 4 * 16
    assert micro.flops("fma", 4, 10) == 10 * 4 * 32
    assert micro.flops("slab", 4, 10) == 10 * 4 * 24
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            micro.fp32_peak()


def test_trace_stats_summary():
    """Per-ray percentiles and per-warp SIMT efficiency: a warp whose 32
    rays walk 1 node but one walks 32 spends 32 x 32 lane slots on 63
    nodes; a partial warp counts its missing lanes as idle."""
    stats = torch.zeros((40, 4), dtype=torch.int32)
    stats[:, 0] = 1
    stats[5, 0] = 32
    s = trace_stats.summarize(stats)
    assert s["warps"] == 2 and s["per_ray"]["nodes"]["max"] == 32
    nodes = s["per_warp"]["nodes"]
    assert nodes["sum"] == 31 + 32 + 8
    assert nodes["lane_slots"] == 32 * 32 + 32 * 1
    assert nodes["simt_efficiency"] == pytest.approx(71 / 1056)
