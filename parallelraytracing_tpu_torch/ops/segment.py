"""The segment: `n_bounces` bounces over a compacted ray queue.

The counterpart of ``pallas_segment`` (``parallelraytracing_tpu/ops/
pallas_trace.py``), the wavefront_fused engine's kernel, on the same
subset as ``ops/trace.py``.  Two functions of one signature:

- ``segment``: the wrapper.  On a CUDA tensor it launches the hand-written
  kernel ``csrc/segment.cu`` (built at first use, ops/_build.py) or
  raises; on a CPU tensor it runs ``segment_reference``.
  ``segment.launches`` counts kernel launches.
- ``segment_reference``: the plain PyTorch version.  Its bounce is
  ``ops/trace._bounce``, the plain version of the trace kernel's bounce,
  as the two kernels share ``csrc/bounce.cuh``.

Inputs: ``pix`` (R,) int32 pixel ids keying the PCG streams; ``state``
(13, R) float32 planes [ox oy oz dx dy dz tr tg tb rr rg rb alive];
``scalars`` (3,) int32 [seed, depth0, count] on the state's device (the
kernel reads `count` there, so a frame needs no host sync between
segments); the tables of ops/pack.py, with ``nee`` the light table, with
``inst`` the instance tables, and the sky spec and the ``checker`` /
``itex`` / ``itex_tab`` textures (as in ops/trace.py).  The material id
and texture coordinates of a hit live inside one bounce only: the state
stays 13 planes.  Returns a new (13, R) state: the 12 planes after
the segment and alive: 0.0 ended, 1.0 goes on, 2.0 goes on from a
diffuse vertex under NEE (the next vertex adds no emission, whichever
segment traces it: an incoming 2.0 is honoured).  Radiance rides the
state and accumulates across segments.  A slot at or past `count`, or
not alive, is dead: its planes pass through and its alive is 0.  Bounce
i of the segment draws the streams of absolute depth depth0 + i, and
Russian roulette (``rr_depth`` > 0) starts at absolute depth
``rr_depth``, so no permutation of the queue changes the image.
"""

from __future__ import annotations

import ctypes

import torch

from parallelraytracing_tpu_torch.ops import rng
from parallelraytracing_tpu_torch.ops.trace import (_bounce, _check_sky,
                                                    _check_textures,
                                                    _light_table, _t_cap,
                                                    check_tensors, scene_arg,
                                                    stream_of)

#: planes of the segment state: origin, direction, throughput, radiance, alive
PLANES = 13


def segment(pix, state, scalars, sph, quad, tri, sph_cl, quad_cl, tri_cl,
            mats, *, n_bounces: int, t_min: float, t_max: float, sky,
            tri_live: bool, rr_depth: int = 0, nee: bool = False,
            lights=None, inst=None, checker=(), itex=(),
            itex_tab=None) -> torch.Tensor:
    """Run `n_bounces` bounces over the queue; the new (13, R) state."""
    if state.device.type == "cpu":
        return segment_reference(pix, state, scalars, sph, quad, tri, sph_cl,
                                 quad_cl, tri_cl, mats, n_bounces=n_bounces,
                                 t_min=t_min, t_max=t_max, sky=sky,
                                 tri_live=tri_live, rr_depth=rr_depth,
                                 nee=nee, lights=lights, inst=inst,
                                 checker=checker, itex=itex,
                                 itex_tab=itex_tab)
    if state.device.type != "cuda":
        raise ValueError(f"segment runs on cpu or cuda tensors, not {state.device}")
    r = int(state.shape[1])
    if state.shape != (PLANES, r):
        raise ValueError(f"state {tuple(state.shape)}: want ({PLANES}, R)")
    check_tensors(state.device, {"state": state},
                  {"pix": (pix, (r,)), "scalars": (scalars, (3,))})
    scene = scene_arg(state.device, sph, quad, tri, sph_cl, quad_cl, tri_cl,
                      mats, t_min=t_min, t_max=t_max, sky=sky,
                      tri_live=tri_live, rr_depth=rr_depth, nee=nee,
                      lights=lights, inst=inst, checker=checker, itex=itex,
                      itex_tab=itex_tab)

    from parallelraytracing_tpu_torch.ops import _build
    launch = _build.load("segment")
    out = torch.empty_like(state)
    ptr = torch.Tensor.data_ptr
    err = launch(*stream_of(state.device), ctypes.byref(scene), ptr(pix),
                 ptr(state), ptr(out), ptr(scalars), r, int(n_bounces))
    if err != 0:
        raise RuntimeError(f"segment kernel launch failed: cudaError_t {err}")
    segment.launches += 1
    return out


segment.launches = 0


def segment_reference(pix, state, scalars, sph, quad, tri, sph_cl, quad_cl,
                      tri_cl, mats, *, n_bounces: int, t_min: float,
                      t_max: float, sky, tri_live: bool, rr_depth: int = 0,
                      nee: bool = False, lights=None, inst=None, checker=(),
                      itex=(), itex_tab=None) -> torch.Tensor:
    """Plain PyTorch version of ``segment`` (same signature and result).
    Each bounce runs on the slots still alive; a dead slot's state is left
    as it was."""
    lights = _light_table(nee, lights)
    sky = _check_sky(sky)
    _check_textures(checker, itex, itex_tab, tri, inst, int(mats.shape[1]))
    seed, depth0, count = (int(v) for v in scalars.tolist())
    r = state.shape[1]
    dev = state.device
    t_cap = _t_cap(t_max)
    out = state.clone()
    planes = [out[k] for k in range(PLANES - 1)]
    alive = out[12]
    alive[(alive <= 0.0) | (torch.arange(r, device=dev) >= count)] = 0.0
    idx = torch.nonzero(alive > 0.0)[:, 0]
    rng_base = rng.pcg_hash((pix.to(torch.int64) & rng.MASK32)
                            ^ (seed & rng.MASK32))
    for i in range(n_bounces):
        if idx.numel() == 0:
            break
        depth = depth0 + i
        rng_d = (rng_base[idx] + depth * rng.DEPTH_STEP) & rng.MASK32
        new, alive_out = _bounce([p[idx] for p in planes], alive[idx], rng_d,
                                 depth, sph, quad, tri if tri_live else None,
                                 mats, t_min, t_cap, sky, lights, rr_depth,
                                 inst, checker, itex, itex_tab)
        for p, v in zip(planes, new):
            p[idx] = v
        alive[idx] = alive_out
        idx = idx[alive_out > 0.0]
    return out
