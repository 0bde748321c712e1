"""The trace and segment kernels on a CUDA card against their plain
PyTorch versions.

The kernel has no CPU mode, so every test here needs a card and skips
without one.  Run on a machine with a GPU (tests/conftest.py imports JAX,
which a GPU machine need not have, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances (those of chip_smoke.py): at depth 1 without jitter the
winning radiance agrees per ray within 1e-5 on >= 99.9% of rays (the
kernel's per-ray tree walk and the plain brute-force fold pick the same
primitive except where a box test and a hit test round differently); at
depth 20 the films of 4-16 jittered frames agree to an HDR RMSE < 1e-3.
The segment kernel is held to the same bounds on the 13 planes of one
segment, and the wavefront_fused and fused films on a mesh to the RMSE
bound (the two kernels share their bounce, so 0 is expected).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_meshes import make_mesh, write_ply  # noqa: E402

RAY_ATOL, RAY_SHARE = 1e-5, 0.999
FILM_RMSE = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trace kernel has no CPU mode")
    return torch.device("cuda")


def preset_renderer(preset, width, height, **cfg_kw):
    from parallelraytracing_tpu_torch import (Film, RenderConfig, Scene,
                                              ScenePreset, create_renderer,
                                              default_camera)
    film = Film(width, height, "cuda")
    r = create_renderer("fused", "cuda")
    r.init(film, Scene(ScenePreset(preset)), default_camera(width, height),
           RenderConfig(width=width, height=height, **cfg_kw))
    return r, film


def mesh_renderer(engine, ply, width, height, attrs=(), **cfg_kw):
    """A renderer of `engine` on the showcase scene of the PLY mesh, with
    the knobs `attrs` set before init."""
    from parallelraytracing_tpu_torch import (Camera, Film, RenderConfig,
                                              create_renderer)
    from parallelraytracing_tpu_torch.core.scene import ply_showcase_scene
    scene, eye, look = ply_showcase_scene(ply)
    eye, look = np.asarray(eye, np.float64), np.asarray(look, np.float64)
    film = Film(width, height, "cuda")
    r = create_renderer(engine, "cuda")
    for k, v in dict(attrs).items():
        setattr(r, k, v)
    r.init(film, scene, Camera(eye, look - eye, float(width), float(height),
                               100.0),
           RenderConfig(width=width, height=height, **cfg_kw))
    return r, film


def frame_inputs(r, frame_index, jitter=None):
    """(o, d, pixel ids, path seed) of one frame of renderer r."""
    from parallelraytracing_tpu_torch.engines.fused import raygen_ids
    from parallelraytracing_tpu_torch.ops.rays import (frame_stream_seeds,
                                                       sample_key)
    cfg = r.config
    jseed, seed = frame_stream_seeds(sample_key(cfg.seed, frame_index, 0))
    o, d = raygen_ids(r._cam_params, r._ids, jseed, cfg.width, cfg.height,
                      cfg.jitter if jitter is None else jitter)
    return o, d, r._ids, seed


def traced(r, fn, max_depth=None):
    """fn (trace or trace_reference) on renderer r's tables and config."""
    t, cfg = r._tables, r.config
    return lambda o, d, pix, seed: fn(
        o, d, pix, seed, t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl, t.tri_cl,
        t.mats, max_depth=max_depth or cfg.max_depth, t_min=cfg.t_min,
        t_max=cfg.t_max, sky=t.sky, tri_live=t.tri_live)


def ray_share(k, p):
    """Share of rows whose values all agree within RAY_ATOL."""
    return float(((k - p).abs().amax(1) <= RAY_ATOL).float().mean())


def film_rmse(r, frames, fn_k, fn_p):
    """HDR RMSE between the means of `frames` frames of fn_k and fn_p."""
    acc_k = acc_p = 0.0
    for f in range(frames):
        inputs = frame_inputs(r, f)
        acc_k = acc_k + fn_k(*inputs)
        acc_p = acc_p + fn_p(*inputs)
    torch.cuda.synchronize()
    return float(((acc_k - acc_p) / frames).pow(2).mean().sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["random_balls_large", "material_test"])
def test_kernel_matches_plain(cuda, preset):
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    r1, _ = preset_renderer(preset, 320, 180, max_depth=1, jitter=False)
    inputs = frame_inputs(r1, 0)
    k, p = traced(r1, trace)(*inputs), traced(r1, trace_reference)(*inputs)
    assert torch.isfinite(k).all() and torch.isfinite(p).all()
    assert ray_share(k, p) >= RAY_SHARE
    r20, _ = preset_renderer(preset, 320, 180, max_depth=20, jitter=True)
    rmse = film_rmse(r20, 16, traced(r20, trace), traced(r20, trace_reference))
    assert rmse < FILM_RMSE, rmse


@pytest.mark.cuda
def test_engine_launches_kernel_and_wrapper_checks(cuda):
    from parallelraytracing_tpu_torch.ops.trace import trace
    r, film = preset_renderer("material_test", 64, 48, max_depth=4)
    before = trace.launches
    r.progressive_render()
    r.progressive_render()
    torch.cuda.synchronize()
    assert trace.launches == before + 2
    assert torch.isfinite(film.hdr_average()).all()

    o, d, pix, seed = frame_inputs(r, 0)
    t = r._tables
    args = (seed, t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl, t.tri_cl, t.mats)
    kw = dict(max_depth=4, t_min=1e-3, t_max=1e16, sky=t.sky, tri_live=False)
    with pytest.raises(TypeError):
        trace(o, d, pix.to(torch.int64), *args, **kw)
    with pytest.raises(ValueError):
        trace(o, d.t().contiguous().t(), pix, *args, **kw)
    with pytest.raises(NotImplementedError):
        trace(o, d, pix, *args, **{**kw, "nee": True})
    assert trace.launches == before + 2


@pytest.fixture
def mesh_ply(tmp_path):
    """The icosahedron at level 3 (1280 triangles): above TRI_HEAVY, so
    wavefront_fused runs its growing schedule."""
    from parallelraytracing_tpu_torch.core.mesh import subdivide
    mesh = subdivide(make_mesh("ico2"), 1)
    assert mesh.num_triangles == 1280
    return write_ply(tmp_path / "icosphere3.ply", mesh)


@pytest.mark.cuda
def test_mesh_trace_kernel_matches_plain(cuda, mesh_ply):
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    r, _ = mesh_renderer("fused", mesh_ply, 160, 90, max_depth=20)
    inputs = frame_inputs(r, 0, jitter=False)
    k = traced(r, trace, max_depth=1)(*inputs)
    p = traced(r, trace_reference, max_depth=1)(*inputs)
    assert ray_share(k, p) >= RAY_SHARE
    rmse = film_rmse(r, 4, traced(r, trace), traced(r, trace_reference))
    assert rmse < FILM_RMSE, rmse


@pytest.mark.cuda
def test_segment_kernel_matches_plain(cuda, mesh_ply):
    from parallelraytracing_tpu_torch.engines.wavefront_fused import (
        _initial_state, _run_segment, _scalars, segmented_trace)
    from parallelraytracing_tpu_torch.ops.segment import segment, segment_reference
    r, _ = mesh_renderer("wavefront_fused", mesh_ply, 160, 90, max_depth=20)
    o, d, pix, seed = frame_inputs(r, 0)
    state = _initial_state(o, d)
    count = torch.full((1,), o.shape[0], dtype=torch.int32, device="cuda")
    k, p = (_run_segment(r._tables, pix, state, _scalars(seed, 0, count), 2,
                         r.config, fn) for fn in (segment, segment_reference))
    assert ray_share(k.t(), p.t()) >= RAY_SHARE
    sched = tuple(r.segment_lengths())
    assert sched == (2, 4, 14)

    def frames(fn):
        return lambda o, d, pix, seed: segmented_trace(
            r._tables, o, d, pix, seed, r.config, schedule=sched, seg_fn=fn)
    rmse = film_rmse(r, 4, frames(segment), frames(segment_reference))
    assert rmse < FILM_RMSE, rmse


@pytest.mark.cuda
def test_segment_wrapper_checks(cuda, mesh_ply):
    from parallelraytracing_tpu_torch.ops.segment import PLANES, segment
    r, _ = mesh_renderer("wavefront_fused", mesh_ply, 16, 8)
    t = r._tables
    pix = torch.arange(4, dtype=torch.int32, device="cuda")
    state = torch.zeros((PLANES, 4), device="cuda")
    scalars = torch.tensor([1, 0, 4], dtype=torch.int32, device="cuda")
    tabs = (t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl, t.tri_cl, t.mats)
    kw = dict(n_bounces=1, t_min=1e-3, t_max=1e16, sky=t.sky, tri_live=True)
    before = segment.launches
    assert segment(pix, state, scalars, *tabs, **kw).shape == (PLANES, 4)
    with pytest.raises(TypeError):
        segment(pix.long(), state, scalars, *tabs, **kw)
    with pytest.raises(ValueError):
        segment(pix, state[:12].contiguous(), scalars, *tabs, **kw)
    with pytest.raises(ValueError):
        segment(pix.cpu(), state, scalars, *tabs, **kw)
    with pytest.raises(NotImplementedError):
        segment(pix, state, scalars, *tabs, **kw, nee=True)
    assert segment.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("attrs", [{}, dict(sort_rays=""),
                                   dict(schedule=(1, 2, 4))])
def test_mesh_engines_agree(cuda, mesh_ply, attrs):
    """wavefront_fused (default knobs, compaction only, another schedule)
    renders the fused engine's film on the card: RMSE < FILM_RMSE."""
    films = []
    for engine, knobs in (("fused", {}), ("wavefront_fused", attrs)):
        r, film = mesh_renderer(engine, mesh_ply, 96, 64, knobs, max_depth=20)
        for _ in range(4):
            r.progressive_render()
        films.append(film.hdr_average())
    torch.cuda.synchronize()
    assert torch.isfinite(films[0]).all()
    assert float((films[0] - films[1]).pow(2).mean().sqrt()) < FILM_RMSE
