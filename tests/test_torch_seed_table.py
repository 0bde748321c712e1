"""The renderers' seed table (``Renderer._frame_seeds``) on the CPU.

- films after a few frames are bit-equal whether the seeds come from the
  table or from the per-frame chain ``frame_stream_seeds(sample_key(...))``
  (monkeypatched in), for ``fused``, ``wavefront_fused`` and ``sharded``
  (1x1): at rest from frame 0, resumed across a block's end, and with
  ``reset_progressive`` after each frame, as the viewer's orbit does;
- the counter reads one fill for each block the frames touch: ceil(N /
  SEED_BLOCK) for N frames at rest, 1 when every frame is frame 0, and
  one a sample of the frame.
"""

import math

import numpy as np
import pytest
import torch

import parallelraytracing_tpu_torch as T
from parallelraytracing_tpu_torch.engines.base import Renderer
from parallelraytracing_tpu_torch.ops.rays import (SEED_BLOCK,
                                                   frame_stream_seeds,
                                                   sample_key)

W, H, FRAMES = 8, 6, 3
#: the frame a resumed run starts at: its frames cross a block's end
RESUME = SEED_BLOCK - 2


def _chain(self, frame_index, s):
    return frame_stream_seeds(sample_key(self.config.seed, frame_index, s))


def _render(engine, mode, spp=1):
    eye = np.array([5.0, 5.0, 8.0])
    cfg = T.RenderConfig(width=W, height=H, max_depth=3, seed=5,
                         samples_per_frame=spp)
    film = T.Film(W, H, "cpu")
    r = T.create_renderer(engine, "cpu")
    r.init(film, T.Scene(T.ScenePreset.MATERIAL_TEST),
           T.Camera(eye, -eye, float(W), float(H), 100.0), cfg)
    if mode == "resumed":
        r._frame_index = RESUME  # as the CLI's --resume sets it
    for _ in range(FRAMES):
        r.progressive_render()
        if mode == "orbit":
            r.reset_progressive()
    return r, film


@pytest.mark.parametrize("mode, fills", [("rest", 1), ("resumed", 2),
                                         ("orbit", 1)])
@pytest.mark.parametrize("engine", ["fused", "wavefront_fused", "sharded"])
def test_films_bit_equal_to_the_chain_and_fills_counted(monkeypatch, engine,
                                                        mode, fills):
    r, film = _render(engine, mode)
    assert (r.seed_frames, r.seed_fills) == (FRAMES, fills)
    with monkeypatch.context() as m:
        m.setattr(Renderer, "_frame_seeds", _chain)
        _, ref = _render(engine, mode)
    assert torch.equal(film.accum, ref.accum)
    assert torch.equal(film.weights, ref.weights)


def test_each_sample_keeps_its_own_block(monkeypatch):
    r, film = _render("fused", "resumed", spp=2)
    assert (r.seed_frames, r.seed_fills) == (2 * FRAMES, 2 * 2)
    with monkeypatch.context() as m:
        m.setattr(Renderer, "_frame_seeds", _chain)
        _, ref = _render("fused", "resumed", spp=2)
    assert torch.equal(film.accum, ref.accum)


@pytest.mark.parametrize("n", [1, SEED_BLOCK, SEED_BLOCK + 1,
                               2 * SEED_BLOCK + 88])
def test_fills_at_rest_are_ceil_frames_over_the_block(n):
    """Frames 0 .. n-1 of two samples through the helper alone, each
    pair against the chain."""
    r, _ = _render("fused", "rest")
    r.seed_frames = r.seed_fills = 0
    r._seed_blocks = {}
    for f in range(n):
        for s in range(2):
            assert r._frame_seeds(f, s) == _chain(r, f, s), (f, s)
    assert r.seed_frames == 2 * n
    assert r.seed_fills == 2 * math.ceil(n / SEED_BLOCK)
