"""The megakernel engine's path-trace loop (the counterpart of
``parallelraytracing_tpu.engines.tracer``).

The reference's iterative radiance/throughput loop (TraceRayGPU,
cuda_megakernel/renderer.cu:81-119) over a brute-force intersector, in
plain PyTorch: emission is added (times the throughput) at every hit
before the scatter, the sky on a miss, and emissive materials end the
path; `max_depth` bounds the bounces.  With NEE a Lambertian vertex also
samples one light (ops/nee.sample_light) and the next vertex's emission
is skipped when a diffuse bounce reached it; Russian roulette from
`russian_roulette_depth` survives with the largest throughput channel,
clamped to [0.05, 1].

Randomness is the JAX package's threefry, drawn per element: bounce
`depth` of a ray keyed `k` draws its unit vector from ``normal(split(
fold_in(k, depth))[0], (R, 3))``, its dielectric uniform from the second
key of that split, the light sample from ``fold_in(.., 11)`` and the
roulette from ``fold_in(.., 7)``, at the ray's element index.  So a ray's
result depends only on its key and its index, and the loop runs on the
paths still alive: a host read or two per bounce (the ids of the paths
that go on, and with NEE of the shadow rays), where the JAX
``while_loop`` tests ``jnp.any(alive)`` on the device.  That is
acceptable for the reference engine.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch

from parallelraytracing_tpu_torch.core.scene import MAT_LAMBERTIAN
from parallelraytracing_tpu_torch.ops import rng
from parallelraytracing_tpu_torch.ops.intersect import (HitRecord, intersect_scene,
                                                        prepare_scene)
from parallelraytracing_tpu_torch.ops.materials import (emitted, scatter,
                                                        surface_albedo,
                                                        unit_vectors)
from parallelraytracing_tpu_torch.ops.nee import sample_light
from parallelraytracing_tpu_torch.ops.sky import sky_radiance

IntersectFn = Callable[..., HitRecord]

#: fold_in salts of a bounce's light sample and roulette draws
_NEE_SALT = 11
_RR_SALT = 7


def make_brute_force_intersector(cfg) -> IntersectFn:
    """The brute-force closest hit under cfg's t range and chunk; the
    scene's chunks are cut once (``prepare_scene``) and kept while the
    intersector is given the same scene."""
    prepared = []

    def f(scene, o, d):
        if not prepared or prepared[0].scene is not scene:
            prepared[:] = [prepare_scene(scene, cfg.intersect_chunk)]
        return intersect_scene(scene, o, d, cfg.t_min, cfg.t_max,
                               cfg.intersect_chunk, prepared=prepared[0])
    return f


def batched_intersector(intersect: IntersectFn, batch: int) -> IntersectFn:
    """`intersect` run on batches of `batch` rays at a time, the hit
    records concatenated (a ray's hit does not depend on its batch)."""
    def f(scene, o, d):
        if o.shape[0] <= batch:
            return intersect(scene, o, d)
        parts = [intersect(scene, o[s:s + batch], d[s:s + batch])
                 for s in range(0, o.shape[0], batch)]
        return HitRecord(**{
            fld.name: (None if getattr(parts[0], fld.name) is None else
                       torch.cat([getattr(p, fld.name) for p in parts]))
            for fld in dataclasses.fields(HitRecord)})
    return f


def _bounce_keys(keys: torch.Tensor, max_depth: int) -> torch.Tensor:
    """(max_depth, G * 4, 2) keys of every bounce of the (G, 2) ray keys,
    four a key: the unit vector's, the dielectric uniform's, the light
    sample's and the roulette's (computed on the host: G is small)."""
    k = rng.fold_in_t(keys.cpu()[None], torch.arange(max_depth)[:, None])
    k_dir, k_uni = rng.split_t(k)
    return torch.stack([k_dir, k_uni, rng.fold_in_t(k, _NEE_SALT),
                        rng.fold_in_t(k, _RR_SALT)], dim=2).reshape(
                            max_depth, -1, 2)


def _draws(bkeys, group, index, nee: bool, rr: bool):
    """The bits of a bounce's draws for rays of key rows `group` at
    element indices `index`: (R, C) columns unit vector x, y, z and the
    dielectric uniform, then the light sample's three and the roulette's
    where enabled; one threefry call for all of them."""
    kinds, stride, lanes = _draw_layout(nee, rr, index.device)
    counter = index[:, None] * stride + lanes
    return rng.bits_at(bkeys[group[:, None] * 4 + kinds], counter)


@functools.lru_cache(maxsize=16)
def _draw_layout(nee: bool, rr: bool, device):
    """(key kind, counter stride, counter lane) of each column of
    ``_draws``, as (1, C) tensors on `device`."""
    cols = ([(0, 3, 0), (0, 3, 1), (0, 3, 2), (1, 1, 0)]
            + ([(2, 3, 0), (2, 3, 1), (2, 3, 2)] if nee else [])
            + ([(3, 1, 0)] if rr else []))
    return tuple(torch.tensor([c[i] for c in cols], device=device)[None]
                 for i in range(3))


#: ray segments traced (one per alive path per bounce, shadow rays not
#: counted), summed over every call since it was last set to 0
ray_segments = [0]


def trace_rays(scene, o: torch.Tensor, d: torch.Tensor, keys: torch.Tensor,
               group: torch.Tensor, index: torch.Tensor, cfg,
               intersect: Optional[IntersectFn] = None, lights=None,
               batch: Optional[int] = None) -> torch.Tensor:
    """Path-trace R rays to completion; returns (R, 3) radiance.

    Ray i draws under key `keys[group[i]]` ((G, 2) int64 uint32 words) at
    element index `index[i]` of each draw (int64), so rays of many keys
    (samples, tiles) trace together.  Batches of `batch` rays (default
    ``cfg.ray_tile``) keep the (rays x chunk) intersection transients
    bounded; a ray's result does not depend on its batch."""
    if intersect is None:
        intersect = make_brute_force_intersector(cfg)
    bkeys = _bounce_keys(keys, cfg.max_depth).to(o.device)
    out = torch.empty_like(o)
    tile = max(1, int(batch or cfg.ray_tile))
    for s in range(0, o.shape[0], tile):
        e = min(s + tile, o.shape[0])
        out[s:e] = _trace_batch(scene, o[s:e], d[s:e], bkeys, group[s:e],
                                index[s:e], cfg, intersect, lights)
    return out


def _trace_batch(scene, o, d, bkeys, group, index, cfg, intersect, lights):
    dev = o.device
    nee = lights is not None
    radiance = torch.zeros_like(o)
    # the alive paths' state, compacted after every bounce
    slot = torch.arange(o.shape[0], device=dev)
    throughput = torch.ones_like(o)
    no_emit = torch.zeros(o.shape[0], dtype=torch.bool, device=dev)
    group = group.to(device=dev, dtype=torch.int64)
    index = index.to(device=dev, dtype=torch.int64)
    for depth in range(cfg.max_depth):
        if slot.numel() == 0:
            break
        ray_segments[0] += slot.numel()
        hit = intersect(scene, o, d)
        rad = radiance[slot]
        miss = ~hit.hit
        rad = rad + torch.where(miss[:, None], throughput * sky_radiance(scene, d),
                                0.0)
        lit = hit.hit
        rad = rad + torch.where((lit & ~no_emit)[:, None],
                                throughput * emitted(scene, hit.mat), 0.0)

        rr = 0 < cfg.russian_roulette_depth <= depth
        bits = _draws(bkeys[depth], group, index, nee, rr)
        unit = unit_vectors(rng.normal_from_bits(bits[:, 0:3]))
        uni = rng.uniform_from_bits(bits[:, 3])
        new_d, atten, scat_alive = scatter(scene, d, hit, unit, uni)

        is_lam = scene.mat_type[hit.mat] == MAT_LAMBERTIAN
        if nee:
            u3 = rng.uniform_from_bits(bits[:, 4:7])
            wi, pdf, lvalid, lkind, lidx, lemit = sample_light(lights, hit.pos,
                                                               u3)
            cos_s = (hit.normal * wi).sum(dim=1)
            cand = lit & is_lam & lvalid & (cos_s > 0.0)
            vis = torch.zeros_like(cand)
            ci = torch.nonzero(cand)[:, 0]
            if ci.numel():
                sh = intersect(scene, hit.pos[ci], wi[ci])
                vis[ci] = sh.hit & (sh.kind == lkind[ci]) & (sh.idx == lidx[ci])
            albedo = surface_albedo(scene, hit)
            w = (cos_s / (math.pi * torch.clamp_min(pdf, 1e-12)))[:, None]
            contrib = throughput * albedo * w * lemit
            rad = rad + torch.where((cand & vis)[:, None], contrib, 0.0)
        radiance[slot] = rad

        cont = lit & scat_alive
        throughput = torch.where(cont[:, None], throughput * atten, throughput)
        if rr:
            p = torch.clamp(throughput.max(dim=1).values, 0.05, 1.0)
            survive = rng.uniform_from_bits(bits[:, -1]) < p
            throughput = torch.where((cont & survive)[:, None],
                                     throughput / p[:, None], throughput)
            cont = cont & survive

        keep = torch.nonzero(cont)[:, 0]
        slot, group, index = slot[keep], group[keep], index[keep]
        o, d = hit.pos[keep], new_d[keep]
        throughput = throughput[keep]
        # emission at the next vertex is already counted by this vertex's
        # light sample when the bounce was diffuse
        no_emit = is_lam[keep] if nee else torch.zeros_like(keep, dtype=torch.bool)
    return radiance


def trace_paths(scene, o: torch.Tensor, d: torch.Tensor, key, cfg,
                intersect: Optional[IntersectFn] = None, lights=None
                ) -> torch.Tensor:
    """Path-trace the rays (o, d), each (R, 3), under one key (a host
    key or a (2,) tensor): ray i draws element i.  Returns (R, 3)."""
    r = o.shape[0]
    keys = rng.as_key(key)[None]
    group = torch.zeros(r, dtype=torch.int64, device=o.device)
    index = torch.arange(r, dtype=torch.int64, device=o.device)
    return trace_rays(scene, o, d, keys, group, index, cfg, intersect, lights)


def count_bounce_rays(scene, cam_params: torch.Tensor, key, cfg) -> float:
    """Total rays traced in one frame, the camera rays plus the rays still
    alive entering each later bounce: the JAX package's count, the
    numerator of its Mrays/s.  Pixel-center camera rays in tiles of
    ``cfg.ray_tile``, the tile starting at ray s keyed ``fold_in(key, s)``;
    the last tile is padded with dummy rays (o 0, d (1, 1, 1)), traced too,
    and its count pro-rated to its real rays.  No NEE, no roulette."""
    from parallelraytracing_tpu_torch.ops.rays import generate_camera_rays
    o, d = generate_camera_rays(cam_params, cfg.width, cfg.height, None, False)
    n = o.shape[0]
    tile = min(cfg.ray_tile, n)
    intersect = make_brute_force_intersector(cfg)
    total = 0
    for s in range(0, n, tile):
        e = min(s + tile, n)
        ot = torch.zeros((tile, 3), dtype=o.dtype, device=o.device)
        dt = torch.ones_like(ot)
        ot[:e - s], dt[:e - s] = o[s:e], d[s:e]
        c = _count_tile(scene, ot, dt, rng.fold_in(key, s), cfg, intersect)
        if e - s < tile:
            c = int(c * (e - s) / tile)  # the dummy rays pro-rated
        total += c
    return float(total)


def _count_tile(scene, o, d, key, cfg, intersect) -> int:
    """The alive rays summed over the bounces of one tile under `key`
    (ray i draws element i), the paths compacted after each bounce."""
    bkeys = _bounce_keys(rng.as_key(key)[None], cfg.max_depth).to(o.device)
    index = torch.arange(o.shape[0], device=o.device)
    group = torch.zeros_like(index)
    count = 0
    for depth in range(cfg.max_depth):
        if index.numel() == 0:
            break
        count += index.numel()
        hit = intersect(scene, o, d)
        bits = _draws(bkeys[depth], group, index, False, False)
        unit = unit_vectors(rng.normal_from_bits(bits[:, 0:3]))
        uni = rng.uniform_from_bits(bits[:, 3])
        new_d, _, scat_alive = scatter(scene, d, hit, unit, uni)
        keep = torch.nonzero(hit.hit & scat_alive)[:, 0]
        index, group = index[keep], group[keep]
        o, d = hit.pos[keep], new_d[keep]
    return count


def tile_streams(key, r: int, ray_tile: int):
    """The JAX ``trace_paths_tiled`` streams of r rays under `key`: tiles
    of min(ray_tile, r) rays, tile t keyed ``fold_in(key, t)`` (the key
    itself when there is one tile), a ray's element index its place in
    its tile.  Returns (keys (T, 2), tile of each ray (r,), index (r,)),
    on the CPU."""
    tile = min(ray_tile, r)
    n_tiles = -(-r // tile)
    key = rng.as_key(key)
    if n_tiles == 1:
        keys = key[None]
    else:
        keys = rng.fold_in_t(key, torch.arange(n_tiles, dtype=torch.int64))
    ray = torch.arange(r, dtype=torch.int64)
    return keys, ray // tile, ray % tile


def trace_paths_tiled(scene, o: torch.Tensor, d: torch.Tensor, key, cfg,
                      intersect: Optional[IntersectFn] = None, lights=None,
                      batch: Optional[int] = None) -> torch.Tensor:
    """``trace_paths`` with the JAX package's tiling of the streams:
    tiles of ``cfg.ray_tile`` rays, each under ``fold_in(key, tile)``
    (``tile_streams``); `batch` as in ``trace_rays``."""
    keys, group, index = tile_streams(key, o.shape[0], cfg.ray_tile)
    return trace_rays(scene, o, d, keys, group, index, cfg, intersect, lights,
                      batch)
