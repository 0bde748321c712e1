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

import jax  # noqa: E402
import parallelraytracing_tpu as J  # noqa: E402
from parallelraytracing_tpu.core.camera import default_camera as jax_camera  # noqa: E402

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch import cli  # noqa: E402
from parallelraytracing_tpu_torch.engines.fused import morton_pixel_perm  # noqa: E402
from parallelraytracing_tpu_torch.utils.png import read_png  # noqa: E402

# Run the JAX package's computations inline in the dispatching thread.
# With asynchronous dispatch a JAX engine dispatches its next operation
# while a Pallas interpret-mode kernel still runs its host callbacks, and
# under load the two threads deadlock (the test then waits until the
# suite's time limit).  The flag is read when the CPU client is made, so
# it is set here, at collection, before any test computes.
jax.config.update("jax_cpu_enable_async_dispatch", False)


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


@pytest.mark.parametrize("weight", [1.0, 0.25, 1.0 / 3.0, 7.0])
@pytest.mark.parametrize("layout", ["canonical", "slots", "block"])
def test_film_adds_bit_equal_with_no_upload(monkeypatch, layout, weight):
    """``add_sample_buffer`` and ``add_sample_slots`` leave accum and
    weights bit-equal to accumulating with a float32 0-dim weight tensor,
    and build no tensor from host data while they add."""
    rng = np.random.default_rng(5)
    slots = W * H + 8  # a padded storage layout
    inv = torch.from_numpy(rng.permutation(slots)[:W * H].astype(np.int64))
    lo, hi = 64, 320
    n, shape = {"canonical": (W * H, (H, W, 3)),
                "slots": (slots, (slots, 3)),
                "block": (hi - lo, (slots, 3))}[layout]
    film = T.Film(W, H, "cpu")
    if layout != "canonical":
        film.set_layout((inv, slots) if layout == "slots" else
                        (inv, slots, (lo, hi)))
    frames = [torch.from_numpy(rng.uniform(0, 3, (n, 3)).astype(np.float32))
              for _ in range(3)]
    ids = torch.from_numpy(rng.integers(
        0, W * H if layout == "canonical" else slots, 50))
    ids = torch.cat([ids, ids[:5]])  # a slot given twice adds twice
    sub = torch.from_numpy(rng.uniform(0, 3, (len(ids), 3)).astype(np.float32))

    w = torch.tensor(weight, dtype=torch.float32)  # the old formula
    accum = torch.zeros(shape, dtype=torch.float32)
    weights = torch.zeros(shape[:-1], dtype=torch.float32)
    for f in frames:
        if layout == "block":
            accum[lo:hi] += f * w
            weights[lo:hi] += w
        else:
            accum += f.reshape(shape) * w
            weights += w
    accum.view(-1, 3).index_add_(0, ids, sub * w)
    weights.view(-1).index_add_(0, ids, w.expand(ids.shape))

    built = []

    def counted(make):
        def call(*args, **kwargs):
            built.append(make)
            return make(*args, **kwargs)
        return call
    monkeypatch.setattr(torch, "tensor", counted(torch.tensor))
    monkeypatch.setattr(torch, "as_tensor", counted(torch.as_tensor))
    for f in frames:
        film.add_sample_buffer(f, weight)
    film.add_sample_slots(ids, sub, weight)
    monkeypatch.undo()
    assert built == []
    assert film.accum.shape == accum.shape and film.sample_count == 4
    assert torch.equal(film.accum, accum) and torch.equal(film.weights, weights)


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
    """An engine neither package has is refused; ``sharded``, the last JAX
    engine the port took, is in both the CLI's list and the registry."""
    with pytest.raises(ValueError, match="fused"):
        cli.main(["--device", "cpu", "--engine", "nonesuch"])
    with pytest.raises(ValueError, match="unknown engine"):
        T.create_renderer("nonesuch", "cpu")
    assert "sharded" in cli.ENGINE_CHOICES
    assert T.create_renderer("sharded", "cpu").name == "sharded"
