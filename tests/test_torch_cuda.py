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
The segment kernel is held to the same bounds on one segment, its
slots matched to the plain version's by pixel id (its queue's order is
the atomics'): each live slot's outcome, a survivor's 13 planes or an
ended path's radiance, and the survivors' sort keys exactly; at the
queue's edges, bit for bit; and the wavefront_fused and fused films on a
mesh to the RMSE bound (the two kernels share their bounce, so 0 is
expected).  With NEE and Russian roulette the same bounds hold, and the
survivors are the same with the alive plane (1, or 2 for NEE's no-emit
mark) equal; so do they
on an instanced scene, where the plain version tests each instance's own
mesh triangles by brute force against the kernel's tree walks, and on the
scene extensions (checker and image textures, the directional sky, thin
lens and QMC raygen, textured instances), whose float64 atan2 / asin the
plain version takes the same way as the kernel.  On a big mesh's stream
route the kernels' two-level walk (top tree, then each chunk's mini-tree)
is held to the plain version's brute force over every slot column, and
the streamed films to the dense ones, bit for bit.  The film add of the
fused and wavefront_fused engines copies nothing from the host under the
profiler, and its film is bit-equal to the same sample buffers
accumulated with a float32 weight tensor.
"""

import dataclasses

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


def preset_renderer(preset, width, height, engine="fused", **cfg_kw):
    from parallelraytracing_tpu_torch import (Film, RenderConfig, Scene,
                                              ScenePreset, create_renderer,
                                              default_camera)
    film = Film(width, height, "cuda")
    r = create_renderer(engine, "cuda")
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
    o, d = raygen_ids(r._cam_params, r._ids, r._pixel_seed(jseed), cfg.width,
                      cfg.height, cfg.jitter if jitter is None else jitter,
                      cfg.lens, r._qpt(frame_index, 0))
    return o, d, r._ids, seed


def traced(r, fn, max_depth=None):
    """fn (trace or trace_reference) on renderer r's tables and config
    (NEE, Russian roulette, instances and textures as the renderer runs
    them)."""
    t, cfg = r._tables, r.config
    if max_depth:
        cfg = cfg.replace(max_depth=max_depth)
    return lambda o, d, pix, seed: fn(o, d, pix, seed, t, cfg)


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
    from parallelraytracing_tpu_torch import RenderConfig, Scene, ScenePreset
    from parallelraytracing_tpu_torch.engines.tables import build_scene_tables
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
    cfg = RenderConfig(max_depth=4, t_min=1e-3, t_max=1e16)
    with pytest.raises(TypeError):
        trace(o, d, pix.to(torch.int64), seed, t, cfg)
    with pytest.raises(ValueError):
        trace(o, d.t().contiguous().t(), pix, seed, t, cfg)
    with pytest.raises(ValueError, match="tables.sph"):
        trace(o, d, pix, seed, build_scene_tables(
            Scene(ScenePreset.MATERIAL_TEST), "cpu")[0], cfg)
    with pytest.raises(ValueError, match="light table"):
        dataclasses.replace(t, lights=t.lights[:-1].contiguous())
    assert trace.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("preset,cfg_kw", [
    ("cornell", dict(nee=True)), ("random_balls_large", dict(nee=True)),
    ("random_balls_large", dict(russian_roulette_depth=3)),
    ("cornell", dict(nee=True, russian_roulette_depth=3))])
def test_nee_rr_kernel_matches_plain(cuda, preset, cfg_kw):
    """NEE (the kernel's any-hit shadow walk against the plain version's
    closest-hit formulation) and Russian roulette on the card."""
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    r1, _ = preset_renderer(preset, 320, 180, max_depth=1, jitter=False,
                            **cfg_kw)
    assert r1._tables.nee == cfg_kw.get("nee", False)
    inputs = frame_inputs(r1, 0)
    k, p = traced(r1, trace)(*inputs), traced(r1, trace_reference)(*inputs)
    assert torch.isfinite(k).all() and ray_share(k, p) >= RAY_SHARE
    r20, _ = preset_renderer(preset, 320, 180, max_depth=20, **cfg_kw)
    inputs = frame_inputs(r20, 0)
    k, p = traced(r20, trace)(*inputs), traced(r20, trace_reference)(*inputs)
    assert ray_share(k, p) >= RAY_SHARE
    rmse = film_rmse(r20, 4, traced(r20, trace), traced(r20, trace_reference))
    assert rmse < FILM_RMSE, rmse


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


def segment_outcomes(res, rad):
    """Each pixel's outcome of a segment launch, (P, 16): a survivor's 13
    planes (NaN if the pixel's path did not survive) and the radiance an
    ended path wrote to `rad` (filled with NaN before the launch)."""
    state, pix, _, count = res
    c = int(count)
    planes = torch.full((rad.shape[0], 13), float("nan"), device=rad.device)
    planes[pix[:c].long()] = state[:, :c].t()
    return torch.cat([planes, rad], 1)


def queue_both(r, pix, state, count, seed, depth0, n_bounces, fns=None):
    """One segment of wavefront_fused renderer r over the queue (pix,
    state) with `count` live, through the kernel and the plain version
    (or `fns`): each one's (result, per-pixel outcomes), and the pixels
    of the live slots."""
    from parallelraytracing_tpu_torch.ops.segment import segment, segment_reference
    out = []
    for fn in fns or (segment, segment_reference):
        rad = torch.full((r.config.width * r.config.height, 3), float("nan"),
                         device="cuda")
        res = fn(pix, state, count, rad, r._tables, r.config, seed=seed,
                 depth0=depth0, n_bounces=n_bounces, sort_rays=r.sort_rays)
        out.append((res, segment_outcomes(res, rad)))
    return out, pix[:int(count)].long()


def outcomes_agree(k, p, live):
    """The kernel's outcomes against the plain version's on the live
    pixels: the same survivors with the alive plane equal, and every
    value within RAY_ATOL on RAY_SHARE of the pixels."""
    k, p = k[live], p[live]
    both = torch.isnan(k) & torch.isnan(p)
    assert bool(((k[:, 12] == p[:, 12]) | both[:, 12]).all())
    close = (((k - p).abs() <= RAY_ATOL) | both).all(1)
    assert not len(live) or float(close.float().mean()) >= RAY_SHARE


def keys_exact(res, bb, mode):
    """The kernel's keys are the plain sort_key of its own survivors'
    planes, and DEAD_KEY past them."""
    from parallelraytracing_tpu_torch.ops.segment import DEAD_KEY, sort_key
    state, _, key, count = res
    c = int(count)
    assert torch.equal(key[:c], sort_key(state[:, :c], bb, mode))
    assert bool((key[c:] == DEAD_KEY).all())


def first_segment_agrees(w, n_bounces=2):
    """One segment of wavefront_fused renderer w from frame 0's camera
    rays, every slot live: kernel and plain agree (outcomes_agree), the
    kernel's keys exact."""
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        _initial_state
    o, d, pix, seed = frame_inputs(w, 0)
    count = torch.full((1,), o.shape[0], dtype=torch.int32, device="cuda")
    ((k, k_out), (_, p_out)), live = queue_both(
        w, pix, _initial_state(o, d), count, seed, 0, n_bounces)
    outcomes_agree(k_out, p_out, live)
    keys_exact(k, w._tables.bb, w.sort_rays)


@pytest.mark.cuda
def test_segment_kernel_matches_plain(cuda, mesh_ply):
    """One 2-bounce segment of the mesh, slots matched by pixel id
    (outcomes_agree), then 4 frames of segmented_trace through the kernel
    and through the plain version (RMSE)."""
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        segmented_trace
    from parallelraytracing_tpu_torch.ops.segment import segment, segment_reference
    r, _ = mesh_renderer("wavefront_fused", mesh_ply, 160, 90, max_depth=20)
    first_segment_agrees(r)
    sched = tuple(r.segment_lengths())
    assert sched == (2, 4, 14)

    def frames(fn):
        return lambda o, d, pix, seed: segmented_trace(
            r._tables, o, d, pix, seed, r.config, schedule=sched, seg_fn=fn)
    rmse = film_rmse(r, 4, frames(segment), frames(segment_reference))
    assert rmse < FILM_RMSE, rmse


@pytest.mark.cuda
def test_segment_wrapper_checks(cuda, mesh_ply):
    from parallelraytracing_tpu_torch import RenderConfig
    from parallelraytracing_tpu_torch.ops.segment import PLANES, segment
    r, _ = mesh_renderer("wavefront_fused", mesh_ply, 16, 8)
    t = r._tables
    assert t.tri_live
    pix = torch.arange(4, dtype=torch.int32, device="cuda")
    state = torch.zeros((PLANES, 4), device="cuda")
    count = torch.tensor([4], dtype=torch.int32, device="cuda")
    rad = torch.zeros((4, 3), device="cuda")
    tabs = (t, RenderConfig(max_depth=4, t_min=1e-3, t_max=1e16))
    kw = dict(seed=1, depth0=0, n_bounces=1)
    before = segment.launches
    s, p, k, c = segment(pix, state, count, rad, *tabs, **kw)
    assert s.shape == (PLANES, 4) and k is None and c.shape == (1,)
    with pytest.raises(TypeError):
        segment(pix.long(), state, count, rad, *tabs, **kw)
    with pytest.raises(ValueError):
        segment(pix, state[:12].contiguous(), count, rad, *tabs, **kw)
    with pytest.raises(ValueError):
        segment(pix.cpu(), state, count, rad, *tabs, **kw)
    with pytest.raises(ValueError, match="light table"):
        dataclasses.replace(t, lights=t.lights[:-1].contiguous())
    with pytest.raises(ValueError, match="sort_rays"):
        segment(pix, state, count, rad, *tabs, **kw, sort_rays="depth")
    with pytest.raises(ValueError, match="scene box"):
        dataclasses.replace(t, bb=((0.0, 0.0, 0.0),))
    assert segment.launches == before + 1


@pytest.mark.cuda
def test_segment_nee_rr_kernel_matches_plain(cuda):
    """Every segment of a CORNELL frame with NEE and rr_depth 3 against
    the plain segment at its real queue (the kernel's queue carried on),
    slots matched by pixel id: the same survivors with the alive plane
    (1, or NEE's 2) equal, the outcomes within RAY_ATOL on RAY_SHARE of
    the live slots, the keys exact; then the wavefront_fused and fused
    films (RMSE bound, 0 expected)."""
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        segmented_trace
    from parallelraytracing_tpu_torch.ops.segment import segment, segment_reference
    cfg_kw = dict(max_depth=20, nee=True, russian_roulette_depth=3)
    r, wf_film = preset_renderer("cornell", 160, 90, "wavefront_fused",
                                 **cfg_kw)
    assert r._tables.nee and r.segment_lengths() == [3] * 6 + [2]
    checked = []

    def both(pix, state, count, rad, *tabs, **kw):
        outs = []
        for fn in (segment_reference, segment):
            r_ = torch.full_like(rad, float("nan"))
            res = fn(pix, state, count, r_, *tabs, **{
                **kw, "out": kw["out"] if fn is segment else None})
            outs.append((res, segment_outcomes(res, r_), r_))
        (_, p_out, _), (k, k_out, k_rad) = outs
        outcomes_agree(k_out, p_out, pix[:int(count)].long())
        if kw["sort_rays"]:
            keys_exact(k, r._tables.bb, kw["sort_rays"])
        rad.copy_(torch.where(torch.isnan(k_rad), rad, k_rad))
        checked.append(int(count))
        return k
    segmented_trace(r._tables, *frame_inputs(r, 0), r.config,
                    schedule=tuple(r.segment_lengths()), seg_fn=both)
    assert len(checked) == 7 and checked[0] == 160 * 90
    f, fused_film = preset_renderer("cornell", 160, 90, **cfg_kw)
    for _ in range(4):
        r.progressive_render()
        f.progressive_render()
    diff = wf_film.hdr_average() - fused_film.hdr_average()
    assert float(diff.pow(2).mean().sqrt()) < FILM_RMSE


#: live counts of the queue's edge cases: none, one, under a warp, a warp
#: and two more, a ragged count of blocks; the test adds one more than
#: the segment kernel's persistent grid has threads
EDGE_COUNTS = (0, 1, 31, 33, 4101)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["mesh", "cornell"])
def test_queue_edge_cases(cuda, mesh_ply, scene):
    """The segment kernel's persistent queue at its edges (the mesh, and
    CORNELL with NEE and rr_depth 3, 640x360): for each live count of
    EDGE_COUNTS and the persistent grid's threads + 1, the first segment
    equals the plain version bit for bit (survivors' planes and pixel
    ids, ended paths' radiance) with exact keys, and a second launch
    gives the same survivors and radiance; then a whole frame into a
    radiance buffer filled with NaN leaves no NaN."""
    from parallelraytracing_tpu_torch.engines.tables import trace_launch
    from parallelraytracing_tpu_torch.engines.wavefront_fused import (
        _initial_state, segmented_trace)
    from parallelraytracing_tpu_torch.ops.segment import segment, segment_reference
    if scene == "mesh":
        r, _ = mesh_renderer("wavefront_fused", mesh_ply, 640, 360,
                             max_depth=20)
    else:
        r, _ = preset_renderer("cornell", 640, 360, "wavefront_fused",
                               max_depth=20, nee=True,
                               russian_roulette_depth=3)
    launch = trace_launch(r._tables, r.config, "segment")
    assert launch["grid"] >= launch["sms"] and launch["threads"] % 32 == 0
    full = launch["grid"] * launch["threads"] + 1
    o, d, pix, seed = frame_inputs(r, 0)
    assert full <= o.shape[0]
    state = _initial_state(o, d)
    n_b = r.segment_lengths()[0]
    for n in EDGE_COUNTS + (full,):
        count = torch.full((1,), n, dtype=torch.int32, device="cuda")
        ((k1, o1), (_, o2), (_, p_out)), _ = queue_both(
            r, pix, state, count, seed, 0, n_b,
            (segment, segment, segment_reference))
        assert torch.equal(o1.view(torch.int32), o2.view(torch.int32)), n
        assert torch.equal(o1.view(torch.int32), p_out.view(torch.int32)), n
        keys_exact(k1, r._tables.bb, r.sort_rays)
        assert int(k1[3]) <= n
    rad = torch.full((o.shape[0], 3), float("nan"), device="cuda")
    segmented_trace(r._tables, o, d, pix, seed, r.config,
                    sort_rays=r.sort_rays,
                    schedule=tuple(r.segment_lengths()), rad=rad)
    assert not torch.isnan(rad).any()


#: the re-sort grid's threads a SM (csrc/segment.cu: kResortBlocksPerSm
#: blocks of kResortThreads)
RESORT_THREADS_PER_SM = 512


def resort_agrees(state, pix, key, n):
    """The re-sort kernel against resort_reference on the first n slots
    of a pushed queue (their pixel ids distinct, below its length): each
    bucket's slot range equal, its rows equal bit for bit matched by
    pixel id, nothing past n written, the tally n."""
    from parallelraytracing_tpu_torch.ops.segment import (BUCKET_SHIFT,
                                                          resort,
                                                          resort_reference)
    r = state.shape[1]
    count = torch.tensor([n], dtype=torch.int32, device="cuda")
    bucket_of = torch.full((r,), -1, dtype=torch.int64, device="cuda")
    bucket_of[pix[:n].long()] = (key[:n] >> BUCKET_SHIFT).long()
    rows = []
    for fn in (resort, resort_reference):
        out = (torch.full_like(state, float("nan")), torch.full_like(pix, -1))
        tally = torch.zeros((1,), dtype=torch.int64, device="cuda")
        fn(state, pix, key, count, out, tally)
        s_out, p_out = out
        assert int(tally) == n
        assert bool(torch.isnan(s_out[:, n:]).all()), n
        assert bool((p_out[n:] == -1).all()), n
        assert bool(((p_out[:n] >= 0) & (p_out[:n] < r)).all()), n
        b = bucket_of[p_out[:n].long()]
        assert bool((b >= 0).all()), n  # a survivor's pixel
        assert bool((b[1:] >= b[:-1]).all()), n  # ascending: contiguous
        order = torch.argsort(b * r + p_out[:n].long())
        rows.append((b, p_out[:n][order], s_out[:, :n][:, order]))
    (kb, kp, ks), (pb, pp, ps) = rows
    assert torch.equal(kb, pb), n  # each bucket's slot range
    assert torch.equal(kp, pp), n  # each bucket's pixels
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32)), n


@pytest.mark.cuda
def test_resort_kernel_matches_plain(cuda, tmp_path):
    """The queue re-sort's two kernels against resort_reference
    (resort_agrees): on the 1080p level-5 mesh's first boundary (the
    survivors of its first segment, 2 bounces), then on a full queue of
    live keys (origins over the scene box, every octant) under "octant"
    and "origin" for each live count of EDGE_COUNTS, the re-sort grid's
    threads + 1 and the whole queue, and the whole queue in one bucket;
    then the wrapper's checks."""
    from parallelraytracing_tpu_torch.core.mesh import subdivide
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        _initial_state
    from parallelraytracing_tpu_torch.ops.segment import (PLANES, resort,
                                                          segment, sort_key)
    ply = write_ply(tmp_path / "icosphere5.ply",
                    subdivide(make_mesh("ico2"), 3))
    r, _ = mesh_renderer("wavefront_fused", ply, 1920, 1080, max_depth=20)
    assert r.segment_lengths() == [2, 4, 14] and r.sort_rays == "octant"
    o, d, pix, seed = frame_inputs(r, 0)
    n = o.shape[0]
    rad = torch.zeros((n, 3), device="cuda")
    state, p_out, key, c = segment(
        pix, _initial_state(o, d), torch.tensor([n], dtype=torch.int32,
                                                device="cuda"),
        rad, r._tables, r.config, seed=seed, depth0=0, n_bounces=2,
        sort_rays="octant")
    c = int(c)
    assert 0 < c < n // 4
    before = resort.launches
    resort_agrees(state, p_out, key, c)
    assert resort.launches == before + 2  # two kernels a call

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    counts = EDGE_COUNTS + (sms * RESORT_THREADS_PER_SM + 1, n)
    gen = torch.Generator(device="cuda").manual_seed(7)
    lo, ie = (torch.tensor(x, device="cuda") for x in r._tables.bb)
    full = torch.cat([
        lo[:, None] + torch.rand((3, n), generator=gen, device="cuda")
        / ie[:, None],
        torch.randn((3, n), generator=gen, device="cuda"),
        torch.rand((PLANES - 6, n), generator=gen, device="cuda")])
    ids = torch.randperm(n, generator=gen, device="cuda").to(torch.int32)
    for mode in ("octant", "origin"):
        keys = sort_key(full, r._tables.bb, mode)
        assert bool((keys < 2 ** 30).all())
        for m in counts:
            resort_agrees(full, ids, keys, m)
    resort_agrees(full, ids, torch.zeros_like(keys), n)  # one bucket

    cnt = torch.tensor([4], dtype=torch.int32, device="cuda")
    out = (torch.empty_like(full), torch.empty_like(ids))
    with pytest.raises(TypeError):
        resort(full, ids.long(), keys, cnt, out)
    with pytest.raises(ValueError):
        resort(full[:12].contiguous(), ids, keys, cnt, out)
    with pytest.raises(ValueError):
        resort(full, ids, keys, cnt.cpu(), out)
    with pytest.raises(ValueError, match="tally"):
        resort(full, ids, keys, cnt, out, torch.zeros((1,), device="cuda"))


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


def instanced_renderer(engine, width, height, nee=False, **cfg_kw):
    """A renderer of `engine` on the two-mesh instanced scene of
    tests/torch_meshes.py (the 20-triangle icosahedron and the
    icosahedron at level 3, 1280 triangles, above TRI_HEAVY: four
    instances, a quad light and a sphere light)."""
    from parallelraytracing_tpu_torch import (Camera, Film, RenderConfig,
                                              Scene, create_renderer)
    from parallelraytracing_tpu_torch.core.mesh import Mesh, subdivide
    from torch_meshes import ICO_F, ICO_V, two_mesh_scene
    v = np.asarray(ICO_V, np.float64)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    ico = Mesh(v.astype(np.float32), np.asarray(ICO_F, np.uint32).reshape(-1))
    big = subdivide(make_mesh("ico2"), 1)
    big.compute_vertex_normals()
    film = Film(width, height, "cuda")
    r = create_renderer(engine, "cuda")
    r.init(film, two_mesh_scene(Scene, ico, big),
           Camera(np.array([0.0, 6.0, 14.0]), np.array([0.0, -5.0, -14.0]),
                  float(width), float(height), 100.0),
           RenderConfig(width=width, height=height, nee=nee, **cfg_kw))
    assert r._tables.inst is not None and r._tables.nee == nee
    return r, film


@pytest.mark.cuda
@pytest.mark.parametrize("nee", [False, True])
def test_instanced_trace_kernel_matches_plain(cuda, nee):
    """The instance block of the trace kernel (its any-hit shadow walk
    with NEE) against the plain version's brute force over each
    instance's own triangles."""
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    r, _ = instanced_renderer("fused", 160, 90, nee=nee, max_depth=8)
    inputs = frame_inputs(r, 0, jitter=False)
    k = traced(r, trace, max_depth=1)(*inputs)
    p = traced(r, trace_reference, max_depth=1)(*inputs)
    assert torch.isfinite(k).all() and ray_share(k, p) >= RAY_SHARE
    rmse = film_rmse(r, 4, traced(r, trace), traced(r, trace_reference))
    assert rmse < FILM_RMSE, rmse


@pytest.mark.cuda
@pytest.mark.parametrize("nee", [False, True])
def test_instanced_segment_kernel_matches_plain(cuda, nee):
    """One 2-bounce segment of the instanced scene, slots matched by
    pixel id (first_segment_agrees: the same survivors with the alive
    plane equal, the outcomes within RAY_ATOL on RAY_SHARE of the slots);
    then the wavefront_fused ((2, 6) at depth 8) and fused films."""
    r, wf_film = instanced_renderer("wavefront_fused", 160, 90, nee=nee,
                                    max_depth=8)
    assert r.segment_lengths() == [2, 6]
    first_segment_agrees(r)
    f, fused_film = instanced_renderer("fused", 160, 90, nee=nee, max_depth=8)
    for _ in range(4):
        r.progressive_render()
        f.progressive_render()
    diff = wf_film.hdr_average() - fused_film.hdr_average()
    assert float(diff.pow(2).mean().sqrt()) < FILM_RMSE


def extension_renderer(name, engine, width, height, **cfg_kw):
    """A renderer of `engine` on one of the scene-extension scenes: the
    texture_demo and sky_demo presets at the CLI's preset camera, or the
    textured instances of tests/torch_meshes.py."""
    from parallelraytracing_tpu_torch import (Camera, Film, RenderConfig,
                                              Scene, ScenePreset,
                                              create_renderer)
    from parallelraytracing_tpu_torch.core.mesh import Mesh
    from parallelraytracing_tpu_torch.core.scene import globe_image
    from torch_meshes import ICO_F, ICO_V, textured_instance_scene
    if name == "instances":
        v = np.asarray(ICO_V, np.float64)
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
        ico = Mesh(v.astype(np.float32),
                   np.asarray(ICO_F, np.uint32).reshape(-1))
        big = make_mesh("ico2")
        big.compute_vertex_normals()
        scene = textured_instance_scene(Scene, ico, big, globe_image())
        eye, look = np.array([0.0, 6.0, 14.0]), np.array([0.0, 1.0, 0.0])
    else:
        scene = Scene(ScenePreset(name))
        eye, look = np.array([5.0, 5.0, 8.0]), np.zeros(3)
    film = Film(width, height, "cuda")
    r = create_renderer(engine, "cuda")
    r.init(film, scene, Camera(eye, look - eye, float(width), float(height),
                               100.0),
           RenderConfig(width=width, height=height, **cfg_kw))
    return r, film


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg_kw", [
    ("texture_demo", dict()), ("texture_demo", dict(nee=True)),
    ("texture_demo", dict(lens_radius=0.1, qmc=True)),
    ("sky_demo", dict()), ("instances", dict(nee=True))])
def test_extension_kernels_match_plain(cuda, name, cfg_kw):
    """The textured and sky instantiations of both kernels against their
    plain versions: the trace at depth 1 without jitter and one 2-bounce
    segment (every ray or slot within RAY_ATOL on RAY_SHARE of them, the
    same survivors with the alive plane equal: first_segment_agrees), and
    4 frames of the trace at depth 8 (RMSE)."""
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    r, _ = extension_renderer(name, "fused", 160, 90, max_depth=8, **cfg_kw)
    assert r._tables.checker or r._tables.itex or len(r._tables.sky) == 13
    inputs = frame_inputs(r, 0, jitter=False)
    k = traced(r, trace, max_depth=1)(*inputs)
    p = traced(r, trace_reference, max_depth=1)(*inputs)
    assert torch.isfinite(k).all() and ray_share(k, p) >= RAY_SHARE
    rmse = film_rmse(r, 4, traced(r, trace), traced(r, trace_reference))
    assert rmse < FILM_RMSE, rmse
    w, _ = extension_renderer(name, "wavefront_fused", 160, 90, max_depth=8,
                              **cfg_kw)
    first_segment_agrees(w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["texture_demo", "instances"])
def test_extension_engines_agree(cuda, name):
    """wavefront_fused renders the fused engine's film of a textured scene
    on the card (RMSE bound, 0 expected)."""
    films = []
    for engine in ("fused", "wavefront_fused"):
        r, film = extension_renderer(name, engine, 96, 64, max_depth=8)
        for _ in range(4):
            r.progressive_render()
        films.append(film.hdr_average())
    torch.cuda.synchronize()
    assert torch.isfinite(films[0]).all()
    assert float((films[0] - films[1]).pow(2).mean().sqrt()) < FILM_RMSE


def stream_renderer(engine, mesh, width, height, **cfg_kw):
    """A renderer of `engine` on tests/test_stream.py's scene around
    `mesh`, packed at the stream constants of ops/pack.py as they are."""
    from parallelraytracing_tpu_torch import (Camera, Film, RenderConfig,
                                              Scene, create_renderer)
    from torch_meshes import stream_scene
    film = Film(width, height, "cuda")
    r = create_renderer(engine, "cuda")
    r.init(film, stream_scene(Scene, mesh),
           Camera(np.array([0.0, 4.0, 10.0]), np.array([0.0, -2.5, -10.0]),
                  float(width), float(height), 100.0),
           RenderConfig(width=width, height=height, **cfg_kw))
    return r, film


#: the ico2 scene streamed at threshold 64 (chunks of 32 and 64 slots):
#: (STREAM_THRESHOLD, STREAM_CHUNK) of ops/pack.py
STREAMED = [(64, 32), (64, 64)]


def set_stream(monkeypatch, threshold, chunk=None):
    """Set ops/pack.py's stream constants for one test."""
    from parallelraytracing_tpu_torch.ops import pack
    monkeypatch.setattr(pack, "STREAM_THRESHOLD", threshold)
    if chunk is not None:
        monkeypatch.setattr(pack, "STREAM_CHUNK", chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", STREAMED)
@pytest.mark.parametrize("nee", [False, True])
def test_stream_kernels_match_plain(cuda, monkeypatch, knobs, nee):
    """The stream instantiations of both kernels on the ico2 scene: the
    trace at depth 1 without jitter and at depth 8 (every ray within
    RAY_ATOL on RAY_SHARE of them), one 2-bounce segment
    (first_segment_agrees)."""
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    mesh = make_mesh("ico2")
    set_stream(monkeypatch, *knobs)
    r, _ = stream_renderer("fused", mesh, 160, 90, max_depth=8, nee=nee)
    assert r._tables.stream is not None and r._tables.nee == nee
    inputs = frame_inputs(r, 0, jitter=False)
    k = traced(r, trace, max_depth=1)(*inputs)
    p = traced(r, trace_reference, max_depth=1)(*inputs)
    assert torch.isfinite(k).all() and ray_share(k, p) >= RAY_SHARE
    inputs = frame_inputs(r, 0)
    assert ray_share(traced(r, trace)(*inputs),
                     traced(r, trace_reference)(*inputs)) >= RAY_SHARE
    w, _ = stream_renderer("wavefront_fused", mesh, 160, 90, max_depth=8,
                           nee=nee)
    first_segment_agrees(w)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["fused", "wavefront_fused"])
def test_level6_stream_films_equal_dense(cuda, monkeypatch, engine):
    """The icosahedron at level 6 (81,920 triangles) at the default
    threshold streams; its films of 2 frames at 96x64, depth 8, equal the
    dense layout's bit for bit, on both engines (the fold's (t, ordinal)
    minimum does not depend on the layout)."""
    from parallelraytracing_tpu_torch.core.mesh import subdivide
    mesh = subdivide(make_mesh("ico2"), 4)
    mesh.compute_vertex_normals()
    films = []
    for dense in (False, True):
        if dense:
            set_stream(monkeypatch, 1 << 30)
        r, film = stream_renderer(engine, mesh, 96, 64, max_depth=8)
        assert (r._tables.stream is None) == dense
        for _ in range(2):
            r.progressive_render()
        films.append(film.hdr_average())
    torch.cuda.synchronize()
    assert torch.isfinite(films[0]).all() and films[0].mean() > 0
    assert torch.equal(films[0], films[1])


def probe_vs_plain(r, n_rays=256):
    """The probe kernel on frame 0 of renderer r against the trace kernel
    (radiance bit for bit) and, on n_rays sampled rays, against the plain
    version (depths and counters equal); its depths sum to
    count_frame_rays' segments."""
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        count_frame_rays
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    o, d, pix, seed = frame_inputs(r, 0)
    before = trace.probe_launches
    rad, depth, stats = traced(r, lambda *a, **kw: trace(
        *a, **kw, depth_out=True, collect_stats=True))(o, d, pix, seed)
    assert trace.probe_launches == before + 1
    assert torch.equal(rad, traced(r, trace)(o, d, pix, seed))
    assert int(depth.double().sum()) == count_frame_rays(
        r._tables, o, d, pix, seed, r.config)
    sel = torch.randperm(o.shape[0], generator=torch.Generator().manual_seed(
        0))[:n_rays].to("cuda")
    _, p_depth, p_stats = traced(r, lambda *a, **kw: trace_reference(
        *a, **kw, depth_out=True, collect_stats=True))(
        o[sel].contiguous(), d[sel].contiguous(), pix[sel].contiguous(), seed)
    assert torch.equal(p_depth, depth[sel])
    assert torch.equal(p_stats, stats[sel])
    assert stats[:, 0].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("nee", [False, True])
def test_probe_kernel_matches_plain(cuda, nee):
    """The probe kernel (csrc/probe.cu) on the sphere tree, with and
    without NEE's shadow walks."""
    r, _ = preset_renderer("random_balls_large", 320, 180, max_depth=20,
                           nee=nee)
    probe_vs_plain(r)


@pytest.mark.cuda
def test_probe_kernel_matches_plain_on_meshes(cuda, mesh_ply, monkeypatch):
    """The probe kernel's triangle tree (NEE on), instance trees and
    stream route against the plain replay."""
    r, _ = mesh_renderer("fused", mesh_ply, 160, 90, max_depth=20, nee=True)
    probe_vs_plain(r)
    r, _ = instanced_renderer("fused", 160, 90, nee=True, max_depth=8)
    probe_vs_plain(r)
    set_stream(monkeypatch, 64, 32)
    r, _ = stream_renderer("fused", make_mesh("ico2"), 160, 90, max_depth=8,
                           nee=True)
    assert r._tables.stream is not None
    probe_vs_plain(r)


#: ray counts of the persistent trace kernel's edge cases: none, one,
#: under a warp, a warp and two more, a ragged count of blocks; the test
#: adds one more ray than the persistent grid has threads
REGEN_RAYS = (0, 1, 31, 33, 4101)


@pytest.mark.cuda
@pytest.mark.parametrize("max_depth", [1, 20])
@pytest.mark.parametrize("preset,nee", [("random_balls_large", False),
                                        ("cornell", True)])
def test_persistent_trace_equals_probe(cuda, preset, nee, max_depth):
    """The persistent trace kernel (path regeneration through its ray
    counter) against the probe kernel (one thread per ray, the loop the
    trace kernel had): bit for bit for every ray count of REGEN_RAYS and
    the persistent grid's threads + 1, and two launches give the same
    bits, whatever lane and iteration ran each ray."""
    from parallelraytracing_tpu_torch.engines.tables import trace_launch
    from parallelraytracing_tpu_torch.ops.trace import trace
    r, _ = preset_renderer(preset, 128, 72, max_depth=max_depth, nee=nee)
    launch = trace_launch(r._tables, r.config)
    assert launch["grid"] >= launch["sms"] and launch["threads"] % 32 == 0
    o, d, pix, seed = frame_inputs(r, 0)
    full = launch["grid"] * launch["threads"] + 1
    reps = -(-full // o.shape[0])
    o, d, pix = (x.repeat((reps,) + (1,) * (x.dim() - 1)) for x in (o, d, pix))
    kern = traced(r, trace)
    probe = traced(r, lambda *a, **kw: trace(*a, **kw, depth_out=True)[0])
    for n in REGEN_RAYS + (full,):
        args = (o[:n].contiguous(), d[:n].contiguous(), pix[:n].contiguous(),
                seed)
        k1, k2, pk = kern(*args), kern(*args), probe(*args)
        torch.cuda.synchronize()
        assert k1.shape == (n, 3) and torch.isfinite(k1).all()
        assert torch.equal(k1, pk), n
        assert torch.equal(k1, k2), n


@pytest.mark.cuda
def test_depth_sort_films_equal_on_card(cuda):
    """depth_sort 1 and 13 render depth_sort 0's film bit for bit on the
    card, one probe launch each."""
    from parallelraytracing_tpu_torch import (Film, RenderConfig, Scene,
                                              ScenePreset, create_renderer,
                                              default_camera)
    from parallelraytracing_tpu_torch.ops.trace import trace
    films = []
    for ds in (0, 1, 13):
        before = trace.probe_launches
        film = Film(160, 90, "cuda")
        r = create_renderer("fused", "cuda")
        r.depth_sort = ds
        r.init(film, Scene(ScenePreset.RANDOM_BALLS_LARGE),
               default_camera(160, 90),
               RenderConfig(width=160, height=90, max_depth=20))
        assert trace.probe_launches == before + (ds > 0)
        for _ in range(2):
            r.progressive_render()
        films.append(film.hdr_average())
    assert torch.equal(films[0], films[1]) and torch.equal(films[0], films[2])


def _film_add_uploads(path):
    """The host-to-device copies a Chrome trace puts inside ``prt.film_add``
    spans: the runtime's memcpy calls made in a span, and the device's
    ``Memcpy HtoD`` events they launched (matched by correlation id: the
    device runs a copy after the host has issued it, and by then the host
    may be in another span)."""
    import json
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"]
               if e.get("ph") == "X" and "dur" in e]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in evs
             if e.get("cat") == "user_annotation" and e["name"] == "prt.film_add"]
    assert spans, "no prt.film_add span in the trace"

    def inside(e):
        return any(lo <= e["ts"] <= hi for lo, hi in spans)
    calls = [e for e in evs if e.get("cat") == "cuda_runtime"
             and "Memcpy" in e["name"] and inside(e)]
    ids = {e.get("args", {}).get("correlation") for e in calls}
    copies = [e for e in evs if "Memcpy HtoD" in e["name"]
              and e.get("args", {}).get("correlation") in ids]
    return [e["name"] for e in calls + copies]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["fused", "wavefront_fused"])
def test_film_add_uploads_nothing_and_stays_bit_equal(cuda, tmp_path, engine):
    """Ten frames under the profiler (CPU + CUDA): no host-to-device copy
    inside any ``prt.film_add`` span, and the film bit-equal to the same
    frames' sample buffers accumulated with a float32 weight tensor on the
    card (3 spp: the weight is 3.0)."""
    from parallelraytracing_tpu_torch.utils import profiling
    r, film = preset_renderer("random_balls_large", 64, 48, engine,
                              max_depth=4, samples_per_frame=3)
    bufs = []
    render = r.render_sample_buffer

    def kept(frame_index):
        rgb = render(frame_index)
        bufs.append(rgb.clone())
        return rgb
    r.render_sample_buffer = kept
    with profiling.trace(str(tmp_path / engine)) as path:
        for _ in range(10):
            r.progressive_render()
        torch.cuda.synchronize()
    assert _film_add_uploads(path) == []

    w = torch.tensor(3.0, dtype=torch.float32, device=cuda)
    accum, weights = torch.zeros_like(film.accum), torch.zeros_like(film.weights)
    for rgb in bufs:
        accum += rgb.reshape(accum.shape).to(torch.float32) * w
        weights += w
    assert len(bufs) == 10 and film.sample_count == 10
    assert torch.equal(film.accum, accum) and torch.equal(film.weights, weights)


@pytest.mark.cuda
def test_fp32_peak_matches_plain(cuda):
    """The micro kernel (csrc/micro.cu) against its plain version: within
    1e-6 relative (its fmaf rounds once where the plain version rounds
    through float64), a measured rate on the card, and twice the loops
    taking twice the time (1.8-2.2x), so the kernel runs every iteration
    it is given."""
    from parallelraytracing_tpu_torch.benchmarks import micro
    errs = micro.check_plain("cuda", 64, 4096)
    assert max(errs.values()) <= 1e-6, errs
    sec, ops = micro.fp32_peak("fma", loops=256, n=132 * 2048)
    assert sec > 0 and ops == 132 * 2048 * 256 * 16
    for mix in micro.MIXES:
        assert 1.8 <= micro.loop_ratio(mix) <= 2.2, mix


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 4101])
def test_trace_kernel_on_a_ragged_subset_of_ids(cuda, n):
    """The adaptive engine's launch: K1 on a subset of a frame's pixel ids
    out of their Morton order (the persistent kernel writes each ray's
    radiance at its place in the input), against trace_reference, at depth
    1 without jitter and at depth 20 with it (headline scene)."""
    from parallelraytracing_tpu_torch.ops.trace import trace, trace_reference
    g = torch.Generator().manual_seed(n)
    for depth, jitter in ((1, False), (20, True)):
        r, _ = preset_renderer("random_balls_large", 160, 90, max_depth=depth,
                               jitter=jitter)
        o, d, pix, seed = frame_inputs(r, 3)
        sel = torch.randperm(pix.numel(), generator=g)[:n].to(cuda)
        args = (o[sel].contiguous(), d[sel].contiguous(), pix[sel].contiguous(),
                seed)
        k, p = traced(r, trace)(*args), traced(r, trace_reference)(*args)
        assert k.shape == (n, 3) and torch.isfinite(k).all()
        off = int(((k - p).abs().amax(1) > RAY_ATOL).sum())
        assert off <= max(1, int(n * (1 - RAY_SHARE))), (depth, off)


def _frame(engine, device, scene, width=64, height=48, **cfg_kw):
    """One frame's HDR film of `engine` on `device`."""
    from parallelraytracing_tpu_torch import (Film, RenderConfig,
                                              create_renderer, default_camera)
    film = Film(width, height, device)
    r = create_renderer(engine, device)
    r.init(film, scene, default_camera(width, height),
           RenderConfig(width=width, height=height, **cfg_kw))
    r.progressive_render()
    return film.hdr_average().cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("engine,nee", [("bvh", False), ("bvh", True),
                                        ("wavefront", False),
                                        ("wavefront", True),
                                        ("wavefront_bvh", False),
                                        ("tlas_ref", False),
                                        ("tlas_ref", True)])
def test_plain_engines_on_the_card_match_cpu(cuda, engine, nee):
    """The plain PyTorch engines (the LBVH walk, the compacted queue, the
    two-level walk) run the same per-ray arithmetic on the card as on the
    CPU: a frame's rays within 1e-5 on >= 99.9% of them (CORNELL for NEE,
    tests/test_tlas.py's instanced layout for tlas_ref)."""
    from parallelraytracing_tpu_torch import Scene, ScenePreset
    from torch_meshes import tlas_scene

    def scene():
        if engine == "tlas_ref":
            return tlas_scene(Scene, make_mesh("ico2"))
        return Scene(ScenePreset.CORNELL if nee else ScenePreset.MATERIAL_TEST)
    kw = dict(max_depth=6, seed=3, nee=nee)
    k = _frame(engine, cuda, scene(), **kw)
    p = _frame(engine, "cpu", scene(), **kw)
    err = (k - p).abs().amax(-1)
    assert float((err <= RAY_ATOL).float().mean()) >= RAY_SHARE, float(err.max())
