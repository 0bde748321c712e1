"""The port's slice end to end against the JAX package's ``fused`` engine.

Both renderers run MATERIAL_TEST at 32x24, depth 4, 2 jittered frames from
the same seed (the JAX kernel in Pallas interpret mode, the port's trace
through its plain PyTorch version on the CPU), and their HDR films must
agree under the trace tests' tolerance form: >= 98% of pixels within 1e-4
and the mean within 1e-3 relative (last-bit rounding differences of
sqrt/sin/cos between XLA and PyTorch can send a few paths elsewhere).

The film itself is exact: the same sample buffers accumulate to the same
float32 buffers (tolerance 0); the u8 display may differ by one step,
because XLA and PyTorch round pow() differently."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch import cli  # noqa: E402
from parallelraytracing_tpu_torch.engines.fused import morton_pixel_perm  # noqa: E402
from parallelraytracing_tpu_torch.utils.png import read_png  # noqa: E402

W, H, DEPTH, FRAMES = 32, 24, 4, 2


def test_fused_film_matches_jax_fused():
    jcfg = J.RenderConfig(width=W, height=H, max_depth=DEPTH, seed=11)
    jfilm = J.Film(W, H)
    jr = J.create_renderer("fused")
    jr.rows = 8  # one 1024-ray tile: the interpret run stays short
    jr.init(jfilm, J.Scene(J.ScenePreset.MATERIAL_TEST), jax_camera(W, H), jcfg)

    cfg = T.RenderConfig(width=W, height=H, max_depth=DEPTH, seed=11)
    film = T.Film(W, H, "cpu")
    r = T.create_renderer("fused", "cpu")
    r.init(film, T.Scene(T.ScenePreset.MATERIAL_TEST), T.default_camera(W, H),
           cfg)
    assert r.film_layout()[1] == W * H  # no pad to a tile multiple
    for _ in range(FRAMES):
        jr.progressive_render()
        r.progressive_render()

    ref = np.asarray(jfilm.hdr_average())
    got = film.hdr_average().numpy()
    assert got.shape == ref.shape == (H, W, 3)
    close = (np.abs(got - ref).max(-1) <= 1e-4).mean()
    assert close >= 0.98, close
    assert abs(got.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())
    assert film.sample_count == jfilm.sample_count == FRAMES


def test_film_accumulates_like_jax():
    rng = np.random.default_rng(2)
    frames = [rng.uniform(0, 3, (W * H, 3)).astype(np.float32) for _ in range(3)]
    perm, inv = morton_pixel_perm(W, H)
    jfilm = J.Film(W, H)
    jfilm.set_layout((inv, W * H))
    film = T.Film(W, H, "cpu")
    film.set_layout((inv, W * H))
    for f in frames:
        jfilm.add_sample_buffer(f[perm], 1.0)
        film.add_sample_buffer(torch.from_numpy(f[perm]), 1.0)
    np.testing.assert_array_equal(film.accum.numpy(), np.asarray(jfilm.accum))
    np.testing.assert_array_equal(film.hdr_average().numpy(),
                                  np.asarray(jfilm.hdr_average()))
    disp = film.display_numpy().astype(int)
    assert np.abs(disp - np.asarray(jfilm.display_numpy()).astype(int)).max() <= 1

    film.set_layout(None)  # back to canonical (H, W): content converted
    np.testing.assert_array_equal(film.hdr_average().numpy(),
                                  np.asarray(jfilm.hdr_average()))


def test_film_checkpoint_round_trip(tmp_path):
    film = T.Film(W, H, "cpu")
    film.set_layout((morton_pixel_perm(W, H)[1], W * H))
    film.add_sample_buffer(torch.rand(W * H, 3, generator=torch.Generator().manual_seed(0)))
    path = str(tmp_path / "ckpt.npz")
    film.save_checkpoint(path, frame_index=5)
    back, frame = T.Film.load_checkpoint(path, "cpu")
    assert frame == 5 and back.sample_count == 1
    np.testing.assert_array_equal(back.hdr_average().numpy(),
                                  film.hdr_average().numpy())


def test_cli_writes_png(tmp_path, capsys):
    out = tmp_path / "cornell.png"
    hdr = tmp_path / "cornell.pfm"
    rc = cli.main(["--device", "cpu", "--scene", "cornell", "--width", "16",
                   "--height", "12", "--frames", "2", "--depth", "3",
                   "--out", str(out), "--hdr-out", str(hdr)])
    assert rc == 0 and "wrote" in capsys.readouterr().out
    img = read_png(str(out))
    assert img.shape == (12, 16, 4) and img[..., 3].min() == 255
    assert hdr.stat().st_size > 16 * 12 * 3 * 4


def test_cli_refuses_other_engines():
    with pytest.raises(ValueError, match="fused"):
        cli.main(["--device", "cpu", "--engine", "megakernel"])
    with pytest.raises(ValueError, match="unknown engine"):
        T.create_renderer("wavefront", "cpu")
