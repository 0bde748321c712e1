"""The reference against a tiny render of the renderer on the CPU (its
plain PyTorch versions), ray by ray through the film."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from prtbench import cell, reference, scenes
from prtbench.tests.prtbench_fixtures import _few_threads, small_plan  # noqa: F401


@pytest.mark.parametrize("workload", ["balls_rest_1080p",
                                      "icosphere_rest_1080p",
                                      "balls_orbit_360p"])
def test_reference_matches_a_cpu_render(workload):
    from parallelraytracing_tpu_torch import Film, RenderConfig, create_renderer
    plan = small_plan(workload, level=3)
    cfg, rnd = plan["config"], plan["config"]["render"]
    w, h = cell.frame_size(plan)
    seed, frames, step = 2**31 + 77, 3, 7.5
    mats, objs = scenes.expand(cfg["scene"])
    eye, view = scenes.orbit_camera(cfg["camera"], 2, step)
    film = Film(w, h, "cpu")
    r = create_renderer(cfg["engine"], "cpu")
    r.init(film, scenes.build_program_scene(cfg["scene"], mats, objs),
           scenes.program_camera(eye, view, w, h),
           RenderConfig(width=w, height=h, max_depth=rnd["max_depth"],
                        seed=seed))
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
    np.testing.assert_allclose(hdr, mean, rtol=1e-5, atol=1e-6)
    ref_disp = reference.tonemap(torch.from_numpy(mean.astype(np.float32)))
    assert np.abs(disp.astype(int) - ref_disp.numpy().astype(int)).max() <= 1


def test_triangle_clusters_find_the_brute_force_hit():
    plan = small_plan("icosphere_rest_1080p", level=3)
    mats, objs = scenes.expand(plan["config"]["scene"])
    sc = reference.RefScene.build(plan["config"]["scene"]["sky"], mats, objs,
                                  "cpu")
    g = torch.Generator().manual_seed(3)
    o = torch.rand((4096, 3), generator=g) * torch.tensor([30.0, 20.0, 30.0]) \
        - torch.tensor([15.0, 0.0, 15.0])
    d = torch.nn.functional.normalize(torch.randn((4096, 3), generator=g), dim=1)
    ray = tuple(o[:, k] for k in range(3)) + tuple(d[:, k] for k in range(3))
    t_c, o_c = reference._tri_closest(ray, sc, 1e-3, 1e16)
    t, ok, _, _ = reference._tri_hits(tuple(v[:, None] for v in ray), sc.tri,
                                      1e-3, 1e16)
    t = torch.where(ok, t, float("inf"))
    t_b, o_b = reference._lexmin(t, sc.tri[17])
    assert torch.isfinite(t_b).sum() > 200
    assert torch.equal(t_c, t_b)
    assert torch.equal(o_c[torch.isfinite(t_b)], o_b[torch.isfinite(t_b)])
