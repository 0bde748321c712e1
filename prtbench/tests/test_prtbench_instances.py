"""The ``instances`` object kind: the renderer keeps each mesh once and
traces its copies through the trace kernel's instance block, the
reference bakes every copy to world space and counts the scene's bytes
as its description holds them; and the configurations that came before
the kind read the reference's outputs they read before it."""

from __future__ import annotations

import copy
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from prtbench import cell, reference, registry, roofline, run, scenes
from prtbench.tests.prtbench_fixtures import _few_threads, small_plan  # noqa: F401

CELL = "instanced_tlas_rest_1080p"
#: the reference's outputs on the older cells at their small plans
#: (``_share`` at ``SEED``), recorded before the instance kind existed:
#: sha256 of the displays' and the window's radiance, the tally, the
#: scene's bytes and the frame's floor
DIGESTS = Path(__file__).with_name("reference_digests.json")
SEED = 2**31 + 1234


def _config() -> dict:
    return copy.deepcopy(registry.plan(run.ROOT, CELL)["config"])


def _as_meshes(desc: dict) -> dict:
    """`desc` with each instance written as a ``mesh`` object of its own,
    in the same order."""
    out = copy.deepcopy(desc)
    out["objects"] = []
    for o in desc["objects"]:
        if o["kind"] != "instances":
            out["objects"].append(copy.deepcopy(o))
            continue
        out["objects"] += [{"kind": "mesh", "mesh": o["mesh"],
                            "material": o["material"], "transform": t}
                           for t in o["transforms"]]
    return out


def test_the_program_keeps_two_meshes_for_seven_instances():
    from parallelraytracing_tpu_torch.engines.tables import build_scene_tables
    desc = _config()["scene"]
    mats, objs = scenes.expand(desc)
    assert objs[1]["mesh"] is objs[2]["mesh"]
    scene = scenes.build_program_scene(desc, mats, objs)
    assert [mi for mi, _, _ in scene.instances] == [0, 0, 1, 1, 1, 1, 1]
    assert [mat for _, mat, _ in scene.instances] == [0, 0, 1, 1, 1, 2, 2]
    assert len(scene._inst_meshes) == 2
    # the icosahedron of the glass and the red copies is one Mesh
    assert scene._inst_meshes[1].num_triangles == 20
    tables, data = build_scene_tables(scene, "cpu")
    assert tables.inst.n_inst == 7
    assert tables.inst.itri.shape[1] == 20_480 + 20
    # no flat triangle: the triangle kind holds one invalid pad
    assert not data.tri_valid.any() and not tables.tri_live


def test_instances_read_as_the_same_scene_baked():
    plan = small_plan(CELL, level=3)
    desc, rnd = plan["config"]["scene"], plan["config"]["render"]
    w, h = cell.frame_size(plan)
    eye, view = scenes.orbit_camera(plan["config"]["camera"], 0, 0.0)
    out = {}
    for name, d in (("instances", desc), ("meshes", _as_meshes(desc))):
        mats, objs = scenes.expand(d)
        sc = reference.RefScene.build(d["sky"], mats, objs, "cpu")
        counts = reference.new_counts()
        rad = reference.pixel_radiance(
            sc, reference.camera_params(eye, view, w, h), w, h,
            np.arange(w * h), range(2), SEED, rnd["max_depth"], rnd["t_min"],
            reference.t_cap(rnd["t_max"]), "cpu", counts=counts)
        out[name] = (rad, counts, sc)
    (rad_i, counts_i, sc_i), (rad_m, counts_m, sc_m) = out["instances"], \
        out["meshes"]
    assert counts_i["triangle"] > 0.05 * w * h
    np.testing.assert_array_equal(rad_i, rad_m)
    assert counts_i == counts_m
    assert sc_i.tri.shape[1] == sc_m.tri.shape[1] == 2 * 1280 + 5 * 20
    assert sc_i.scene_bytes < sc_m.scene_bytes


def test_scene_bytes_count_each_mesh_once():
    desc = _config()["scene"]
    floats = 5 * 1 + 13 * 1 + 5 * 5  # a sphere, a quad, five materials
    for d, body in ((desc, 19 * (20_480 + 20) + 13 * 7),
                    (_as_meshes(desc), 19 * (2 * 20_480 + 5 * 20))):
        mats, objs = scenes.expand(d)
        sc = reference.RefScene.build(d["sky"], mats, objs, "cpu")
        assert sc.scene_bytes == 4 * (floats + body)


def _share(workload: str) -> dict:
    plan = small_plan(workload, depth=6 if "nee" in workload else 4)
    w, h = cell.frame_size(plan)
    pixels = cell.sample_pixels(SEED, w, h, 256)
    if plan["traffic"]["motion"] == "orbit":
        share = cell.reference_share(plan, SEED, pixels, 1, [1, 1], [1, 2], 3,
                                     w, h, "cpu")
    else:
        share = cell.reference_share(plan, SEED, pixels, 3, [1, 3], [0, 0], 0,
                                     w, h, "cpu")
    radiance = (np.ascontiguousarray(share["ref_disp"]).tobytes()
                + np.ascontiguousarray(share["ref_final"]).tobytes())
    return {"radiance_sha256": hashlib.sha256(radiance).hexdigest(),
            "counts": share["counts"], "scene_bytes": share["scene_bytes"],
            "floor": roofline.frame_floor(share["counts"], share["paths"],
                                          w * h, share["scene_bytes"])}


@pytest.mark.parametrize("workload", sorted(json.loads(DIGESTS.read_text())))
def test_the_older_cells_read_what_they_read(workload):
    assert _share(workload) == json.loads(DIGESTS.read_text())[workload]
