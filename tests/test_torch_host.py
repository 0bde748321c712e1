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
    return sd, {f: np.asarray(getattr(sd, f)) for f in FIELDS}


@pytest.mark.parametrize("preset", REFERENCE_PRESETS)
def test_scene_data_equals_jax(preset):
    _, ref = _jax_arrays(preset)
    got = T.Scene(T.ScenePreset(preset)).build("cpu").numpy()
    for f in FIELDS:
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.Scene(T.ScenePreset(preset))


def test_import_leaves_jax_out():
    code = ("import sys, parallelraytracing_tpu_torch, "
            "parallelraytracing_tpu_torch.cli, "
            "parallelraytracing_tpu_torch.convert, "
            "parallelraytracing_tpu_torch.ops.trace, "
            "parallelraytracing_tpu_torch.ops._build; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'parallelraytracing_tpu'"
            " or m.startswith('parallelraytracing_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
