"""The `wavefront` and `wavefront_bvh` engines: per-bounce stages over a
compacted pool of paths (the counterpart of
``parallelraytracing_tpu.engines.wavefront``).

The analogue of the reference's CUDA wavefront backend: per-pixel path
state in R-sized arrays that persist across bounces (pool slot = pixel),
an intersect stage and a shade stage per bounce, and a queue of the alive
slots that keeps the work proportional to the alive paths.  The queue is
compacted after each bounce by a stable prefix-sum scatter (pos =
cumsum(alive) - 1; queue[pos] = slot), and a bounce's stages run on the
queue's slots only, their pool updates written by ``index_add_`` /
``index_copy_`` at those slots: each slot is written at most once a
bounce, so the result does not depend on the order.  One host read a
bounce (the queue's new length).

The randomness is the JAX engine's: per bounce, fold_in(key, depth) split
into the direction key and the uniform key, drawn per pool slot (the unit
vectors of ``random_unit_vectors(k_dir, R)``, the uniforms of
``uniform(k_uni, (R,))``, NEE's from fold_in(k, 11) and roulette's from
fold_in(k, 7)) and read at the queue's slots, so a path's draws do not
depend on the queue order.  When the frame is one ray tile (R <=
``cfg.ray_tile``) these are the megakernel engine's draws, ray for ray.
With `wavefront_bvh` both the bounce rays and NEE's shadow rays walk the
LBVH (accel/traverse.py).
"""

from __future__ import annotations

import math

import torch

from parallelraytracing_tpu_torch.core.scene import MAT_LAMBERTIAN
from parallelraytracing_tpu_torch.engines.base import Renderer, register_engine
from parallelraytracing_tpu_torch.engines.megakernel import raygen
from parallelraytracing_tpu_torch.engines.tracer import (
    _bounce_keys, _draws, batched_intersector, make_brute_force_intersector)
from parallelraytracing_tpu_torch.ops import rng
from parallelraytracing_tpu_torch.ops.materials import (emitted, scatter,
                                                        surface_albedo,
                                                        unit_vectors)
from parallelraytracing_tpu_torch.ops.nee import sample_light
from parallelraytracing_tpu_torch.ops.sky import sky_radiance

#: ray segments traced (one per queued path per bounce), summed over every
#: call since it was last set to 0
ray_segments = [0]


def wavefront_trace(scene, o: torch.Tensor, d: torch.Tensor, key, cfg,
                    intersect, lights=None) -> torch.Tensor:
    """Trace the R camera rays (o, d) through the staged loop under the
    path key `key`; returns (R, 3) radiance.  The pool is padded to a
    whole ray tile (origins 0, directions 1.0), the padding dead from the
    start."""
    r, dev = o.shape[0], o.device
    tile = min(cfg.ray_tile, r)
    rp = r + (-r) % tile
    # the pool's own copies (updated in place), padded
    o = torch.cat([o, torch.zeros((rp - r, 3), device=dev)])
    d = torch.cat([d, torch.ones((rp - r, 3), device=dev)])
    nee = lights is not None
    bkeys = _bounce_keys(rng.as_key(key)[None], cfg.max_depth).to(dev)
    radiance = torch.zeros((rp, 3), device=dev)
    throughput = torch.ones((rp, 3), device=dev)
    # emission at a vertex a diffuse bounce reached is counted by the
    # previous vertex's light sample
    no_emit = torch.zeros(rp, dtype=torch.bool, device=dev)
    queue = torch.arange(r, device=dev)
    slots = torch.arange(rp, device=dev)
    for depth in range(cfg.max_depth):
        if queue.numel() == 0:
            break
        ray_segments[0] += queue.numel()
        ot, dt, thr = o[queue], d[queue], throughput[queue]
        hit = intersect(scene, ot, dt)
        rr = 0 < cfg.russian_roulette_depth <= depth
        bits = _draws(bkeys[depth], torch.zeros_like(queue), queue, nee, rr)
        miss, lit = ~hit.hit, hit.hit
        add = torch.where(miss[:, None], thr * sky_radiance(scene, dt), 0.0)
        add = add + torch.where((lit & ~no_emit[queue])[:, None],
                                thr * emitted(scene, hit.mat), 0.0)
        new_d, atten, scat_alive = scatter(
            scene, dt, hit, unit_vectors(rng.normal_from_bits(bits[:, 0:3])),
            rng.uniform_from_bits(bits[:, 3]))
        cont = lit & scat_alive
        is_lam = scene.mat_type[hit.mat] == MAT_LAMBERTIAN
        if nee:
            wi, pdf, lvalid, lkind, lidx, lemit = sample_light(
                lights, hit.pos, rng.uniform_from_bits(bits[:, 4:7]))
            cos_s = (hit.normal * wi).sum(dim=1)
            cand = lit & is_lam & lvalid & (cos_s > 0.0)
            vis = torch.zeros_like(cand)
            ci = torch.nonzero(cand)[:, 0]
            if ci.numel():
                sh = intersect(scene, hit.pos[ci], wi[ci])
                vis[ci] = sh.hit & (sh.kind == lkind[ci]) & (sh.idx == lidx[ci])
            w = (cos_s / (math.pi * torch.clamp_min(pdf, 1e-12)))[:, None]
            add = add + torch.where((cand & vis)[:, None],
                                    thr * surface_albedo(scene, hit) * w * lemit,
                                    0.0)
        thr_new = thr * atten
        if rr:
            p = torch.clamp(thr_new.max(dim=1).values, 0.05, 1.0)
            survive = rng.uniform_from_bits(bits[:, -1]) < p
            thr_new = torch.where((cont & survive)[:, None],
                                  thr_new / p[:, None], thr_new)
            cont = cont & survive
        radiance.index_add_(0, queue, add)
        keep = torch.nonzero(cont)[:, 0]
        cq = queue[keep]
        throughput.index_copy_(0, cq, thr_new[keep])
        o.index_copy_(0, cq, hit.pos[keep])
        d.index_copy_(0, cq, new_d[keep])
        if nee:
            no_emit.index_copy_(0, cq, is_lam[keep])
        # the queue's compaction: a stable prefix-sum scatter of the alive
        # slots (the last position a sink for the dead ones)
        alive = torch.zeros(rp, dtype=torch.bool, device=dev)
        alive[cq] = True
        pos = torch.cumsum(alive, 0) - 1
        count = int(pos[-1]) + 1
        queue = torch.empty(rp + 1, dtype=torch.int64, device=dev)
        queue.index_copy_(0, torch.where(alive, pos, rp), slots)
        queue = queue[:count]
    return radiance[:r]


@register_engine
class WavefrontRenderer(Renderer):
    name = "wavefront"
    use_bvh = False

    def _post_init(self) -> None:
        from parallelraytracing_tpu_torch.ops.nee import extract_lights
        self._scene_data = self._scene.build(self.device)
        if self.use_bvh:
            from parallelraytracing_tpu_torch.accel.lbvh import build_bvh
            from parallelraytracing_tpu_torch.engines.bvh import \
                make_bvh_intersector
            self._bvh = build_bvh(self._scene_data, self.device)
            self._intersect = make_bvh_intersector(self._bvh, self.config)
        else:  # batches of a ray tile bound the (rays x chunk) transients
            self._intersect = batched_intersector(
                make_brute_force_intersector(self.config), self.config.ray_tile)
        lights = (extract_lights(self._scene_data.numpy())
                  if self.config.nee else None)
        self._lights = None if lights is None else lights.to(self.device)

    def render_sample_buffer(self, frame_index: int) -> torch.Tensor:
        cfg = self.config
        base = rng.fold_in(rng.prng_key(cfg.seed), frame_index)
        acc = None
        for s in range(cfg.samples_per_frame):
            k_jit, k_path = rng.split(rng.fold_in(base, s))
            o, d = raygen(self._cam_params, k_jit, cfg.width, cfg.height,
                          cfg.jitter, cfg.lens, self._qseed,
                          self._qpt(frame_index, s))
            rad = wavefront_trace(self._scene_data, o, d, k_path, cfg,
                                  self._intersect, self._lights)
            acc = rad if acc is None else acc + rad
        return acc / cfg.samples_per_frame


@register_engine
class WavefrontBVHRenderer(WavefrontRenderer):
    """The wavefront loop over the LBVH walk: compacted queues and an
    acceleration structure, the reference's OptiX wavefront analogue."""

    name = "wavefront_bvh"
    use_bvh = True
