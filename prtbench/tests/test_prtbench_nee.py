"""The reference's next-event estimation and Russian roulette, beside
the film comparison of test_prtbench_reference.py: its light list is the
renderer's, its tally counts the shadow rays it traces (none with NEE
off), and a render setting it does not follow is refused before a run;
and its frame seeds, drawn for every frame at once, are the renderer's."""

from __future__ import annotations

import copy

import numpy as np
import pytest

from prtbench import cell, reference, scenes
from prtbench.tests.prtbench_fixtures import _few_threads, small_plan  # noqa: F401

NEE_CELLS = ["cornell_nee_rest_1080p", "balls_nee_rest_1080p"]


def _scene(plan):
    mats, objs = scenes.expand(plan["config"]["scene"])
    return mats, objs, reference.RefScene.build(plan["config"]["scene"]["sky"],
                                                mats, objs, "cpu")


@pytest.mark.parametrize("workload", NEE_CELLS)
def test_the_light_list_is_the_renderers(workload):
    from parallelraytracing_tpu_torch.ops.pack import pack_lights_table
    plan = small_plan(workload)
    mats, objs, sc = _scene(plan)
    scene = scenes.build_program_scene(plan["config"]["scene"], mats, objs)
    host = scene.build("cpu").numpy()
    prog = pack_lights_table(host)
    ref = sc.lights.numpy()
    assert ref.shape == (18, prog.shape[1])
    # kind, center, radius, u, v, normal, emission bit for bit; the
    # ordinals in the same order (the renderer pads a kind it lacks with
    # one invalid column, so its quads' ordinals may start one later)
    rows = [0] + list(range(2, 18))
    np.testing.assert_array_equal(ref[rows], prog[rows])
    assert np.all(np.diff(ref[1]) > 0)
    assert np.all(ref[1] - prog[1] == ref[1, 0] - prog[1, 0])


@pytest.mark.parametrize("workload", NEE_CELLS)
def test_the_tally_counts_shadow_rays_only_under_nee(workload):
    plan = small_plan(workload, depth=6)
    rnd = plan["config"]["render"]
    _, _, sc = _scene(plan)
    w, h = cell.frame_size(plan)
    eye, view = scenes.orbit_camera(plan["config"]["camera"], 0, 0.0)
    tallies = {}
    for nee in (True, False):
        counts = reference.new_counts()
        reference.pixel_radiance(
            sc, reference.camera_params(eye, view, w, h), w, h,
            np.arange(w * h), range(2), 2**31 + 5, rnd["max_depth"],
            rnd["t_min"], reference.t_cap(rnd["t_max"]), "cpu",
            counts=counts, nee=nee, rr_depth=rnd["russian_roulette_depth"])
        tallies[nee] = counts
    assert tallies[True]["shadow"] > 0.05 * w * h
    assert tallies[False]["shadow"] == 0
    # the shadow rays are no segments of the paths
    assert tallies[True]["segments"] == tallies[False]["segments"]


@pytest.mark.parametrize("key, value", [("samples_per_frame", 2),
                                        ("jitter", False)])
def test_a_setting_the_reference_does_not_follow_is_refused(key, value):
    plan = copy.deepcopy(small_plan("cornell_nee_rest_1080p"))
    plan["config"]["render"][key] = value
    w, h = cell.frame_size(plan)
    with pytest.raises(ValueError, match=key):
        cell.reference_share(plan, 7, np.arange(4), 2, [2], [0], 0, w, h,
                             "cpu")


@pytest.mark.parametrize("seed", [0, 2**31 + 77, 3_260_000_011, 2**33 + 1])
def test_frame_seeds_are_the_renderers(seed):
    # the reference draws every frame's seeds at once; the renderer's
    # scalar chain, frame by frame, is the witness
    from parallelraytracing_tpu_torch.ops import rays
    frames = list(range(40)) + [25_000, 2**32 + 3]
    want = np.array([rays.frame_stream_seeds(rays.sample_key(seed, f, 0))
                     for f in frames], np.int64)
    np.testing.assert_array_equal(reference.frame_seeds(seed, frames), want)
