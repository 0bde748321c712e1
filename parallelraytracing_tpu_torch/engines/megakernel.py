"""Megakernel engine: the reference engine and the oracle of the
converged-spp gates (the counterpart of
``parallelraytracing_tpu.engines.megakernel``).

The analogue of the reference's CUDA megakernel backend (one thread = one
pixel = one whole path), written in plain PyTorch as the JAX engine is
jnp: full-frame raygen (ops/rays.generate_camera_rays) and the
brute-force path trace of engines/tracer.py.  It computes no TPU kernel's
work, so it has no hand-written kernel; it is the independent oracle the
fused and wavefront_fused kernels are held to.  Its streams are the JAX
engine's threefry: frame key fold_in(PRNGKey(seed), frame), sample key
fold_in(frame key, s), split into the jitter key and the path key, the
path key tiled by ``cfg.ray_tile`` (tracer.tile_streams).  A frame's
samples trace together (a ray's result depends only on its key and
index), in calls of at least ``cfg.ray_tile`` rays.
"""

from __future__ import annotations

import torch

from parallelraytracing_tpu_torch.engines.base import Renderer, register_engine
from parallelraytracing_tpu_torch.engines.tracer import (
    make_brute_force_intersector, tile_streams, trace_paths_tiled, trace_rays)
from parallelraytracing_tpu_torch.ops import rng
from parallelraytracing_tpu_torch.ops.rays import generate_camera_rays


def raygen(cam_params, key, width: int, height: int, jitter: bool, lens=None,
           pix_seed=None, qpt=None):
    """The engine's camera rays: threefry jitter under `key` (or an (S, 2)
    tensor of keys: S frames' rays), or under QMC pixel-keyed rotations of
    the Halton point `qpt` (pix_seed the QMC rotation seed)."""
    return generate_camera_rays(cam_params, width, height, key, jitter,
                                lens=lens, pix_seed=pix_seed, qpt=qpt)


def trace(scene, o, d, key, cfg, lights=None) -> torch.Tensor:
    """(R, 3) radiance of the rays (o, d) under the path key `key`,
    tiled as the JAX engine's ``trace_paths_tiled``."""
    return trace_paths_tiled(scene, o, d, key, cfg, lights=lights)


def render_frame(scene, cam_params, key, cfg) -> torch.Tensor:
    """One frame's (H*W, 3) mean radiance in one call, raygen and trace
    together (the JAX package's single-program frame, for tooling):
    sample s draws under fold_in(key, s), split into its jitter key and
    its path key.  No NEE, no QMC: the engine's loop below has those."""
    acc = None
    for s in range(cfg.samples_per_frame):
        k_jit, k_path = rng.split(rng.fold_in(key, s))
        o, d = generate_camera_rays(cam_params, cfg.width, cfg.height, k_jit,
                                    cfg.jitter, lens=cfg.lens)
        rad = trace_paths_tiled(scene, o, d, k_path, cfg)
        acc = rad if acc is None else acc + rad
    return acc / cfg.samples_per_frame


@register_engine
class MegakernelRenderer(Renderer):
    name = "megakernel"
    #: rays traced in one call (None: ``cfg.ray_tile``, which bounds the
    #: brute force's (rays x chunk) transients)
    rays_per_call = None

    def _post_init(self) -> None:
        from parallelraytracing_tpu_torch.ops.nee import extract_lights
        self._scene_data = self._scene.build(self.device)
        lights = (extract_lights(self._scene_data.numpy())
                  if self.config.nee else None)
        self._lights = None if lights is None else lights.to(self.device)
        self._intersect = make_brute_force_intersector(self.config)

    def _raygen(self, frame_index: int, samples, k_jits):
        """The camera rays of `samples` (their jitter keys `k_jits`),
        sample-major: one batched draw, or under QMC one raygen a sample
        (each rotates its own Halton point)."""
        cfg = self.config
        if self._qseed is None:
            return raygen(self._cam_params, torch.tensor(k_jits), cfg.width,
                          cfg.height, cfg.jitter, cfg.lens)
        rays = [raygen(self._cam_params, k, cfg.width, cfg.height, cfg.jitter,
                       cfg.lens, self._qseed, self._qpt(frame_index, s))
                for s, k in zip(samples, k_jits)]
        return (torch.cat([o for o, _ in rays]), torch.cat([d for _, d in rays]))

    def _frame_tracer(self, frame_index: int):
        """(scene, intersector, lights) of this frame's trace."""
        return self._scene_data, self._intersect, self._lights

    def render_sample_buffer(self, frame_index: int) -> torch.Tensor:
        cfg = self.config
        r = cfg.pixel_count
        base = rng.fold_in(rng.prng_key(cfg.seed), frame_index)
        scene, intersect, lights = self._frame_tracer(frame_index)
        batch = self.rays_per_call or cfg.ray_tile
        per_call = max(1, batch // r)
        acc = None
        for s0 in range(0, cfg.samples_per_frame, per_call):
            samples = range(s0, min(s0 + per_call, cfg.samples_per_frame))
            k_jits, keys, groups, indices = [], [], [], []
            for s in samples:
                k_jit, k_path = rng.split(rng.fold_in(base, s))
                k, g, i = tile_streams(k_path, r, cfg.ray_tile)
                groups.append(g + sum(x.shape[0] for x in keys))
                k_jits.append(k_jit)
                keys.append(k)
                indices.append(i)
            o, d = self._raygen(frame_index, samples, k_jits)
            rad = trace_rays(scene, o, d, torch.cat(keys), torch.cat(groups),
                             torch.cat(indices), cfg, intersect, lights, batch)
            for j in range(len(samples)):
                part = rad[j * r:(j + 1) * r]
                acc = part if acc is None else acc + part
        return acc / cfg.samples_per_frame
