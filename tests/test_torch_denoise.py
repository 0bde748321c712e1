"""The à-trous denoiser against the JAX package's on the CPU, and the
CLI's megakernel and adaptive engines with ``--denoise``.

Tolerances: the guide buffers' depth and albedo and the filter within
1e-5 relative (the guide pass is the brute-force intersector, held in
tests/test_torch_megakernel.py; the filter's exp and pow round apart
from XLA's in the last bits); misses (depth +inf) exactly; the normal
within 1e-4: XLA compiles the guide pass as one program and fuses its
multiply-adds otherwise than in the intersector alone, the hit distance
moves by up to 5.6e-6 relative and a sphere's normal, the hit point over
the radius, by up to 5.2e-5 (texture_demo's globe); the PNG's u8
display within one step, as tests/test_torch_slice.py holds the film's.
Whether the filter lowers the error to a converged image is checked on
the card (chip_smoke.py's denoise phase): its truth takes 256 frames.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402
from parallelraytracing_tpu.ops import rays as jrays  # noqa: E402
from parallelraytracing_tpu.postfx import denoise as jden  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch import cli  # noqa: E402
from parallelraytracing_tpu_torch.ops import rays  # noqa: E402
from parallelraytracing_tpu_torch.postfx import denoise  # noqa: E402
from parallelraytracing_tpu_torch.utils.png import read_png  # noqa: E402

W, H = 32, 24


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    assert err.max() <= rtol, err.max()


def _guides(preset, monkeypatch, w=W, h=H):
    """Both packages' guides of a preset.  The port's guide pass is given
    the JAX package's pixel-center rays: at a sphere's silhouette an ulp
    of a direction (tests/test_torch_megakernel.py holds the raygen within
    2e-7) moves the hit point, and the normal, by up to 2e-3."""
    jcfg = J.RenderConfig(width=w, height=h)
    cfg = T.RenderConfig(width=w, height=h, ray_tile=300)  # tiled guide pass
    params = jax_camera(w, h).ray_params()
    ref = jax.jit(jden.aux_buffers, static_argnums=(2,))(
        J.Scene(J.ScenePreset(preset)).build(), jnp.asarray(params), jcfg)
    jo, jd = jrays.generate_camera_rays(jnp.asarray(params), w, h, None, False)
    monkeypatch.setattr(rays, "generate_camera_rays", lambda *a, **k: (
        torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd))))
    got = denoise.aux_buffers(T.Scene(T.ScenePreset(preset)).build("cpu"),
                              torch.from_numpy(params), cfg)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


@pytest.mark.parametrize("preset", ["cornell", "texture_demo", "sky_demo"])
def test_aux_buffers_match_jax(preset, monkeypatch):
    (jn, ja, jd), (n, a, d) = _guides(preset, monkeypatch)
    miss = ~np.isfinite(jd)
    np.testing.assert_array_equal(~np.isfinite(d), miss)
    assert 0 < miss.mean() < 1 or preset == "cornell"
    _close(n, jn, 1e-4)
    _close(a, ja, 1e-5)
    _close(d[~miss], jd[~miss], 1e-5)


def test_shift_luma_local_std_match_jax():
    img = np.random.default_rng(1).uniform(0, 3, (H, W, 3)).astype(np.float32)
    for dy, dx in ((0, 0), (2, -3), (-5, 7), (30, -40)):
        np.testing.assert_array_equal(
            denoise._shift(torch.from_numpy(img), dy, dx).numpy(),
            np.asarray(jden._shift(jnp.asarray(img), dy, dx)))
    lum = denoise._luma(torch.from_numpy(img))
    _close(lum.numpy(), jden._luma(jnp.asarray(img)), 1e-6)
    _close(denoise._local_std(lum).numpy(),
           jax.jit(jden._local_std)(jnp.asarray(lum.numpy())), 1e-5)


@pytest.mark.parametrize("iterations", [1, 3])
def test_atrous_denoise_matches_jax(iterations, monkeypatch):
    """The filter on a noisy image over texture_demo's guides (textured
    albedo, sky misses), the same inputs to both packages."""
    (jn, ja, jd), _ = _guides("texture_demo", monkeypatch)
    g = np.random.default_rng(iterations)
    rad = (ja * g.exponential(1.0, (H, W, 1))).astype(np.float32)
    ins = [np.array(x) for x in (rad, jn, ja, jd)]
    ref = jden.atrous_denoise(*(jnp.asarray(x) for x in ins), iterations)
    got = denoise.atrous_denoise(*(torch.from_numpy(x) for x in ins), iterations)
    _close(got.numpy(), ref, 1e-5)
    assert np.abs(got.numpy() - rad).mean() > 1e-3  # it filtered


def test_save_denoised_png_matches_jax(tmp_path):
    g = np.random.default_rng(2)
    frame = g.uniform(0, 2, (W * H, 3)).astype(np.float32)
    jf, tf = J.Film(W, H), T.Film(W, H, "cpu")
    jf.add_sample_buffer(jnp.asarray(frame))
    tf.add_sample_buffer(torch.from_numpy(frame))
    params = jax_camera(W, H).ray_params()
    jden.save_denoised_png(str(tmp_path / "j.png"), jf,
                           J.Scene(J.ScenePreset.CORNELL).build(),
                           jnp.asarray(params), J.RenderConfig(width=W, height=H),
                           iterations=2)
    denoise.save_denoised_png(str(tmp_path / "t.png"), tf,
                              T.Scene(T.ScenePreset.CORNELL).build("cpu"),
                              torch.from_numpy(params),
                              T.RenderConfig(width=W, height=H), iterations=2)
    a = read_png(str(tmp_path / "j.png")).astype(int)
    b = read_png(str(tmp_path / "t.png")).astype(int)
    assert a.shape == b.shape == (H, W, 4)
    assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("engine", ["adaptive", "megakernel"])
def test_cli_engine_with_denoise_writes_png(tmp_path, capsys, engine):
    out = tmp_path / f"{engine}.png"
    assert cli.main(["--device", "cpu", "--engine", engine, "--denoise", "2",
                     "--scene", "cornell", "--width", "32", "--height", "24",
                     "--depth", "2", "--frames", "5", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert f"engine={engine}" in text and "(denoised x2)" in text
    img = read_png(str(out))
    assert img.shape == (24, 32, 4) and img[..., :3].mean() > 0
