"""The trace kernel on a CUDA card against its plain PyTorch version.

The kernel has no CPU mode, so every test here needs a card and skips
without one.  Run on a machine with a GPU:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances (those of chip_smoke.py): at depth 1 without jitter the
winning radiance agrees per ray within 1e-5 on >= 99.9% of rays (the
kernel's per-ray tree walk and the plain brute-force fold pick the same
primitive except where a box test and a hit test round differently); at
depth 20 the films of 16 jittered frames agree to an HDR RMSE < 1e-3.
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trace kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["random_balls_large", "material_test"])
def test_kernel_matches_plain(cuda, preset):
    import chip_smoke
    share, rmse = chip_smoke.compare_kernel_plain(preset, 320, 180)
    assert share >= chip_smoke.RAY_SHARE, share
    assert rmse < chip_smoke.FILM_RMSE, rmse


@pytest.mark.cuda
def test_engine_launches_kernel_and_wrapper_checks(cuda):
    import chip_smoke
    from parallelraytracing_tpu_torch.ops.trace import trace
    r, film = chip_smoke.make_renderer("material_test", 64, 48, max_depth=4)
    before = trace.launches
    r.progressive_render()
    r.progressive_render()
    torch.cuda.synchronize()
    assert trace.launches == before + 2
    assert torch.isfinite(film.hdr_average()).all()

    o, d, pix, seed = chip_smoke.frame_inputs(r, 0)
    t = r._tables
    args = (seed, t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl, t.tri_cl, t.mats)
    kw = dict(max_depth=4, t_min=1e-3, t_max=1e16, sky=t.sky, tri_live=False)
    with pytest.raises(TypeError):
        trace(o, d, pix.to(torch.int64), *args, **kw)
    with pytest.raises(ValueError):
        trace(o, d.t().contiguous().t(), pix, *args, **kw)
    with pytest.raises(NotImplementedError):
        trace(o, d, pix, *args, **{**kw, "tri_live": True})
    assert trace.launches == before + 2
