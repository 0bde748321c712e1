"""The port's host state against the JAX package's, exactly.

Scene arrays, packed trace tables and the Morton pixel permutation are
integer or float32 data computed by the same host (numpy) arithmetic in
both packages, so they must be bit-equal: tolerance 0."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.engines.fused import \
    morton_pixel_perm as jax_morton  # noqa: E402
from parallelraytracing_tpu.ops.pallas_trace import \
    pack_scene_tables as jax_pack  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch import convert  # noqa: E402
from parallelraytracing_tpu_torch.core.scene import SceneData  # noqa: E402
from parallelraytracing_tpu_torch.engines.fused import morton_pixel_perm  # noqa: E402
from parallelraytracing_tpu_torch.ops.pack import pack_scene_tables  # noqa: E402

REFERENCE_PRESETS = ["default", "light_test", "material_test", "cornell",
                     "random_balls_small", "random_balls_medium",
                     "random_balls_large"]
FIELDS = [f.name for f in dataclasses.fields(SceneData)]


def _jax_arrays(preset):
    sd = J.Scene(J.ScenePreset(preset)).build()
    return sd, {f: None if getattr(sd, f) is None
                else np.asarray(getattr(sd, f)) for f in FIELDS}


@pytest.mark.parametrize("preset", REFERENCE_PRESETS)
def test_scene_data_equals_jax(preset):
    _, ref = _jax_arrays(preset)
    got = T.Scene(T.ScenePreset(preset)).build("cpu").numpy()
    for f in FIELDS:
        if ref[f] is None:  # an extension field the preset leaves unused
            assert got[f] is None, f
            continue
        assert got[f].dtype == ref[f].dtype, f
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


@pytest.mark.parametrize("preset", ["random_balls_large", "random_balls_small",
                                    "material_test", "cornell"])
def test_packed_tables_equal_jax(preset):
    sd, ref_arrays = _jax_arrays(preset)
    ref = jax_pack(sd, eye=None)[:7]
    got = pack_scene_tables(T.Scene(T.ScenePreset(preset)).build("cpu").numpy())
    names = ["sph", "quad", "tri", "sph_cl", "quad_cl", "tri_cl", "mats"]
    for name, a, b in zip(names, ref, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    # the JAX package's arrays, carried across, pack the same
    carried = convert.scene_data_from_numpy(ref_arrays, "cpu").numpy()
    for a, b in zip(ref, pack_scene_tables(carried)):
        np.testing.assert_array_equal(b, a)


def test_random_balls_large_uses_the_tree():
    tabs = pack_scene_tables(
        T.Scene(T.ScenePreset.RANDOM_BALLS_LARGE).build("cpu").numpy())
    sph, quad, tri, sph_cl, quad_cl, tri_cl, mats = tabs
    assert sph.shape == (6, 808) and sph_cl.shape[0] == 8
    assert quad.shape == (14, 1) and quad_cl.shape == (6, 2)
    assert tri.shape == (27, 1) and not tri[0:3].any()  # never-hit pad
    assert mats.shape == (5, 809)


@pytest.mark.parametrize("size", [(1920, 1080), (37, 23), (64, 64)])
def test_morton_pixel_perm_equals_jax(size):
    for a, b in zip(jax_morton(*size), morton_pixel_perm(*size)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("preset", ["texture_demo", "sky_demo"])
def test_extension_presets_raise(preset):
    """The extension presets build and pack (their textures and sky run in
    the kernels; tests/test_torch_textures.py holds them to the JAX
    package), and the trace's probes run on their tables: depth_out's
    (R,) float32 depths and collect_stats' (R, 4) int32 counters."""
    from parallelraytracing_tpu_torch.engines.tables import build_scene_tables
    from parallelraytracing_tpu_torch.ops.trace import trace
    t, _ = build_scene_tables(T.Scene(T.ScenePreset(preset)), "cpu")
    assert (preset == "texture_demo") == bool(t.checker and t.itex)
    assert (preset == "sky_demo") == (len(t.sky) == 13)
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]])
    args = (o, d, torch.arange(2, dtype=torch.int32), 1, t,
            T.RenderConfig(max_depth=2, t_min=1e-3, t_max=1e16))
    assert trace(*args).shape == (2, 3)
    for extra, shape, dtype in ((dict(depth_out=True), (2,), torch.float32),
                                (dict(collect_stats=True), (2, 4),
                                 torch.int32)):
        rad, probe = trace(*args, **extra)
        assert rad.shape == (2, 3) and probe.shape == shape
        assert probe.dtype == dtype


def test_import_leaves_jax_out():
    code = ("import sys, parallelraytracing_tpu_torch, "
            "parallelraytracing_tpu_torch.cli, "
            "parallelraytracing_tpu_torch.convert, "
            "parallelraytracing_tpu_torch.ops.trace, "
            "parallelraytracing_tpu_torch.ops.segment, "
            "parallelraytracing_tpu_torch.engines.wavefront_fused, "
            "parallelraytracing_tpu_torch.core.mesh, "
            "parallelraytracing_tpu_torch.ops._build, "
            "parallelraytracing_tpu_torch.ops.walk_stats, "
            "parallelraytracing_tpu_torch.benchmarks.micro, "
            "parallelraytracing_tpu_torch.benchmarks.trace_stats, "
            "parallelraytracing_tpu_torch.benchmarks.roofline, "
            "parallelraytracing_tpu_torch.engines.megakernel, "
            "parallelraytracing_tpu_torch.engines.tracer, "
            "parallelraytracing_tpu_torch.engines.adaptive, "
            "parallelraytracing_tpu_torch.ops.intersect, "
            "parallelraytracing_tpu_torch.ops.materials, "
            "parallelraytracing_tpu_torch.ops.sky, "
            "parallelraytracing_tpu_torch.ops.textures, "
            "parallelraytracing_tpu_torch.ops.nee, "
            "parallelraytracing_tpu_torch.accel.lbvh, "
            "parallelraytracing_tpu_torch.accel.traverse, "
            "parallelraytracing_tpu_torch.accel.refit, "
            "parallelraytracing_tpu_torch.accel.tlas, "
            "parallelraytracing_tpu_torch.engines.bvh, "
            "parallelraytracing_tpu_torch.engines.wavefront, "
            "parallelraytracing_tpu_torch.engines.tlas, "
            "parallelraytracing_tpu_torch.benchmarks.walk_rounds, "
            "parallelraytracing_tpu_torch.postfx.denoise, "
            "parallelraytracing_tpu_torch.native, "
            "parallelraytracing_tpu_torch.viewer.app, "
            "parallelraytracing_tpu_torch.utils.timing, "
            "parallelraytracing_tpu_torch.utils.profiling, "
            "parallelraytracing_tpu_torch.utils.diagnostics, "
            "parallelraytracing_tpu_torch.examples.animated_refit, "
            "parallelraytracing_tpu_torch.examples.render_showcase, "
            "parallelraytracing_tpu_torch.examples.interactive_session, "
            "parallelraytracing_tpu_torch.parallel, "
            "parallelraytracing_tpu_torch.parallel.sharding, "
            "parallelraytracing_tpu_torch.engines.sharded, "
            "parallelraytracing_tpu_torch.benchmarks.sharded_cards; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'parallelraytracing_tpu'"
            " or m.startswith('parallelraytracing_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_cache_key_covers_included_headers():
    """Both kernel libraries include csrc/bounce.cuh and the persistent
    launch of csrc/persistent.cuh, so their hashes are part of both cache
    keys: an edit to a shared header rebuilds both."""
    from parallelraytracing_tpu_torch.ops import _build
    for name in ("trace", "segment"):
        names = [p.name for p in _build.sources(name)]
        assert names == [f"{name}.cu", "persistent.cuh", "bounce.cuh"], names
        assert name in _build.SIGNATURES
    assert _build.library_path("trace") != _build.library_path("segment")


def test_probe_and_micro_libraries():
    """The probe kernel builds from its own source and the shared bounce
    (so the trace library keeps its instantiations), the micro from its
    source alone, the raygen from its source and the bounce's PCG;
    chip_smoke.py's build phase builds all five."""
    from parallelraytracing_tpu_torch.ops import _build
    assert [p.name for p in _build.sources("probe")] == ["probe.cu",
                                                          "bounce.cuh"]
    assert [p.name for p in _build.sources("micro")] == ["micro.cu"]
    assert [p.name for p in _build.sources("raygen")] == ["raygen.cu",
                                                           "bounce.cuh"]
    assert _build.LIBRARIES == ("trace", "segment", "probe", "micro",
                                "raygen")
    assert {lib for lib, _, _ in _build.SIGNATURES.values()} \
        == set(_build.LIBRARIES)
    assert all(_build.SIGNATURES[lib][0] == lib for lib in _build.LIBRARIES)
    assert _build.SCENE in _build.SIGNATURES["probe"][2]
    assert _build.SCENE not in _build.SIGNATURES["micro"][2]
