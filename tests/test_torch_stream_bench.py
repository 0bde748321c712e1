"""The benchmark's stream-route configuration (``big_mesh_320k_stream``,
cell ``icosphere_l7_540p``) rendered by the port on the CPU against the
benchmark's plain reference (``prtbench/reference.py``), ray by ray
through the film.

The cell's own mesh (a level-7 icosphere, 327,680 triangles) is far
above ``ops/pack.STREAM_THRESHOLD``; at the CPU's size (``small_plan``:
48x27, depth 4, a level-3 icosphere of 1,280 triangles) the threshold is
patched to 64 and the chunk to 32 slots, as tests/test_torch_stream.py
does, so the small mesh takes the same route: the chunk-aligned top tree,
the chunks' mini-trees and the stream tables of ``SceneTables.stream``.
On the CPU the segments run their plain versions, which fold every slot
column, so the route changes no image: the film must match the reference
as the dense cells' films do (prtbench/tests/test_prtbench_reference.py).
"""

import numpy as np
import pytest
import torch

from torch_meshes import make_mesh  # noqa: F401  (one thread a worker)

from parallelraytracing_tpu_torch import Film, RenderConfig, create_renderer
from parallelraytracing_tpu_torch.ops import pack
from prtbench import cell, reference, registry, run, scenes
from prtbench.tests.prtbench_fixtures import small_plan

WORKLOAD = "icosphere_l7_540p"
THRESHOLD, CHUNK = 64, 32


def test_the_configuration_takes_the_stream_route_unpatched():
    plan = registry.plan(run.ROOT, WORKLOAD)
    assert plan["config"]["engine"] == "wavefront_fused"
    meshes = [o["mesh"] for o in plan["config"]["scene"]["objects"]
              if o["kind"] == "mesh"]
    assert meshes == [{"icosphere": 7}]
    n_tri = 20 * 4 ** 7
    assert n_tri == 327_680 > pack.STREAM_THRESHOLD
    assert pack.STREAM_CHUNK == 64


@pytest.mark.parametrize("seed", [2**31 + 77, 12345])
def test_stream_route_film_matches_the_reference(monkeypatch, seed):
    monkeypatch.setattr(pack, "STREAM_THRESHOLD", THRESHOLD)
    monkeypatch.setattr(pack, "STREAM_CHUNK", CHUNK)
    plan = small_plan(WORKLOAD, level=3)
    cfg, rnd = plan["config"], plan["config"]["render"]
    w, h = cell.frame_size(plan)
    frames = 3
    mats, objs = scenes.expand(cfg["scene"])
    eye, view = scenes.orbit_camera(cfg["camera"], 0, 0.0)
    film = Film(w, h, "cpu")
    r = create_renderer(cfg["engine"], "cpu")
    r.init(film, scenes.build_program_scene(cfg["scene"], mats, objs),
           scenes.program_camera(eye, view, w, h),
           RenderConfig(width=w, height=h, max_depth=rnd["max_depth"],
                        seed=seed, t_min=rnd["t_min"], t_max=rnd["t_max"]))
    stream = r._tables.stream
    assert stream is not None and stream.chunk == CHUNK
    assert r._tables.tri.shape[1] % CHUNK == 0
    for _ in range(frames):
        r.progressive_render()
    hdr = film.hdr_average().reshape(-1, 3).double().numpy()
    disp = film.display_numpy().reshape(-1, 4)[:, :3]

    sc = reference.RefScene.build(cfg["scene"]["sky"], mats, objs, "cpu")
    rad = reference.pixel_radiance(
        sc, reference.camera_params(eye, view, w, h), w, h, np.arange(w * h),
        range(frames), seed, rnd["max_depth"], rnd["t_min"],
        reference.t_cap(rnd["t_max"]), "cpu")
    mean = rad.sum(0) / frames
    assert mean.max() > 0.1
    # the mesh is in the frame: some camera ray's first hit is a triangle
    counts = reference.new_counts()
    reference.pixel_radiance(
        sc, reference.camera_params(eye, view, w, h), w, h, np.arange(w * h),
        [0], seed, 1, rnd["t_min"], reference.t_cap(rnd["t_max"]), "cpu",
        counts=counts)
    assert counts["triangle"] > 0.05 * w * h
    # the tolerances of test_prtbench_reference.py: the plain versions and
    # the reference round alike, so a film channel differs only by the
    # float32 sums' order (a few ulps of the mean), and a display channel
    # by at most the one 8-bit step such a difference can cross
    np.testing.assert_allclose(hdr, mean, rtol=1e-5, atol=1e-6)
    ref_disp = reference.tonemap(torch.from_numpy(mean.astype(np.float32)))
    assert np.abs(disp.astype(int) - ref_disp.numpy().astype(int)).max() <= 1
