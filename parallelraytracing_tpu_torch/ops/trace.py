"""The fused trace: every bounce of every ray in one kernel launch.

The counterpart of ``pallas_trace`` (``parallelraytracing_tpu/ops/pallas_trace.py``)
on sphere/quad scenes with the constant sky.  Two functions of one
signature:

- ``trace``: the wrapper.  On a CUDA tensor it launches the hand-written
  kernel ``csrc/trace.cu`` (built at first use, ops/_build.py) or raises;
  on a CPU tensor it runs ``trace_reference``.  ``trace.launches`` counts
  kernel launches.
- ``trace_reference``: the plain PyTorch version, vectorised over rays.
  Its closest hit is a brute-force fold over every sphere and quad column
  (an independent check of the kernel's tree walk); everything after the
  fold follows the order of operations of ``_make_bounce_step``.

Rays: o, d (R, 3) float32; pix (R,) int32 pixel ids keying the PCG
streams; seed the frame's int32 path seed.  Tables: the (C, N) float32
tables of ops/pack.py (or of the JAX package, via convert.py).  Returns
(R, 3) float32 radiance.

Not in this port yet, refused with NotImplementedError: live triangles
(a triangle kind of never-hit pad columns is skipped), NEE, Russian
roulette, instances, checker and image textures, the directional sky,
``depth_out`` and ``collect_stats``.
"""

from __future__ import annotations

import math

import torch

from parallelraytracing_tpu_torch.core.scene import (MAT_DIELECTRIC, MAT_EMISSIVE,
                                                  MAT_LAMBERTIAN, MAT_METAL)
from parallelraytracing_tpu_torch.ops import ieee, rng
from parallelraytracing_tpu_torch.ops.pack import CLUSTER

BIG = 3.0e38
TWO_PI = 2.0 * math.pi
#: t_max at or above this is the "infinite" horizon: no upper-bound test
T_MAX_INF = 1e30
#: rays x primitives per chunk of the plain version's brute-force fold
CHUNK_ELEMS = 1 << 23

_ROADMAP = {
    "tri_live": "the triangle body: ROADMAP Queue 1 item 8 (mesh path)",
    "nee": "NEE: ROADMAP Queue 1 item 9",
    "rr_depth": "Russian roulette: ROADMAP Queue 1 item 11",
    "inst": "instances: ROADMAP Queue 1 item 10",
    "checker": "checker textures: ROADMAP Queue 1 item 11",
    "itex": "image textures: ROADMAP Queue 1 item 11",
    "depth_out": "the depth_out probe: ROADMAP Queue 1 item 17",
    "collect_stats": "collect_stats counters: ROADMAP Queue 1 item 17",
}


def _refuse(sky, **features) -> None:
    for name, value in features.items():
        if value:
            raise NotImplementedError(f"{_ROADMAP[name]} (not ported yet)")
    if len(sky) != 3:
        raise NotImplementedError(
            "the directional sky: ROADMAP Queue 1 item 11 (not ported yet)")


def _t_cap(t_max: float) -> float:
    return math.inf if t_max >= T_MAX_INF else float(t_max)


def trace(o, d, pix, seed: int, sph, quad, tri, sph_cl, quad_cl, tri_cl,
          mats, *, max_depth: int, t_min: float, t_max: float, sky,
          tri_live: bool, rr_depth: int = 0, nee: bool = False, inst=None,
          checker=(), itex=(), depth_out: bool = False,
          collect_stats: bool = False) -> torch.Tensor:
    """Trace R rays through up to `max_depth` bounces; (R, 3) radiance.

    `tri_live` says whether the triangle table holds any hittable column
    (engines/tables.py and convert.py compute it on the host)."""
    _refuse(sky, tri_live=tri_live, rr_depth=rr_depth, nee=nee, inst=inst,
            checker=checker, itex=itex, depth_out=depth_out,
            collect_stats=collect_stats)
    if o.device.type == "cpu":
        return trace_reference(o, d, pix, seed, sph, quad, tri, sph_cl,
                               quad_cl, tri_cl, mats, max_depth=max_depth,
                               t_min=t_min, t_max=t_max, sky=sky,
                               tri_live=tri_live)
    if o.device.type != "cuda":
        raise ValueError(f"trace runs on cpu or cuda tensors, not {o.device}")
    r = _check_inputs(o, d, pix, sph, quad, sph_cl, quad_cl, mats)

    from parallelraytracing_tpu_torch.ops import _build
    launch = _build.load("trace")
    out = torch.empty((r, 3), dtype=torch.float32, device=o.device)
    stream = torch.cuda.current_stream(o.device).cuda_stream
    ptr = torch.Tensor.data_ptr
    err = launch(
        o.device.index if o.device.index is not None else torch.cuda.current_device(),
        stream, ptr(o), ptr(d), ptr(pix), ptr(out), r,
        ptr(sph), sph.shape[1], ptr(sph_cl), sph_cl.shape[0], sph_cl.shape[1],
        ptr(quad), quad.shape[1], ptr(quad_cl), quad_cl.shape[0],
        quad_cl.shape[1], ptr(mats), mats.shape[1], CLUSTER,
        int(seed) & rng.MASK32, int(max_depth), float(t_min),
        _t_cap(t_max), float(sky[0]), float(sky[1]), float(sky[2]))
    if err != 0:
        raise RuntimeError(f"trace kernel launch failed: cudaError_t {err}")
    trace.launches += 1
    return out


trace.launches = 0


def _check_inputs(o, d, pix, sph, quad, sph_cl, quad_cl, mats) -> int:
    """Validate what the kernel reads; returns the ray count."""
    r = int(o.shape[0])
    if o.shape != (r, 3) or d.shape != (r, 3) or pix.shape != (r,):
        raise ValueError(f"rays: o {tuple(o.shape)}, d {tuple(d.shape)}, "
                         f"pix {tuple(pix.shape)}; want (R,3), (R,3), (R,)")
    if pix.dtype != torch.int32:
        raise TypeError(f"pix must be int32, got {pix.dtype}")
    tabs = {"o": o, "d": d, "sph": sph, "quad": quad, "sph_cl": sph_cl,
            "quad_cl": quad_cl, "mats": mats}
    for name, t in tabs.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in {**tabs, "pix": pix}.items():
        if t.device != o.device:
            raise ValueError(f"{name} is on {t.device}, rays on {o.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sph.shape[0] != 6 or quad.shape[0] != 14 or mats.shape[0] != 5:
        raise ValueError("tables: want sph (6,N), quad (14,N), mats (5,N)")
    for name, cl, n in (("sph_cl", sph_cl, sph.shape[1]),
                        ("quad_cl", quad_cl, quad.shape[1])):
        n_cl = max(1, -(-int(n) // CLUSTER))
        if not (cl.shape[0] == 8
                or (cl.shape[0] == 6 and cl.shape[1] == n_cl + 1)):
            raise ValueError(f"{name} {tuple(cl.shape)}: want an (8, M) "
                             f"tree or a (6, {n_cl + 1}) linear table")
    return r


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _sphere_hits(ox, oy, oz, dx, dy, dz, sph, t_min, t_cap):
    """(B, Ns) hit distance, accept mask and front flag of every sphere."""
    cx, cy, cz, r2 = sph[0], sph[1], sph[2], sph[3]
    ocx = ox[:, None] - cx
    ocy = oy[:, None] - cy
    ocz = oz[:, None] - cz
    b2 = dx[:, None] * ocx + dy[:, None] * ocy + dz[:, None] * ocz
    cterm = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = b2 * b2 - cterm
    sq = ieee.sqrt(torch.clamp_min(disc, 0.0))
    t_near = -b2 - sq
    t_far = -b2 + sq
    fr = t_near >= t_min
    t = torch.where(fr, t_near, t_far)
    ok = (disc >= 0.0) & (t >= t_min) & (t <= t_cap)
    return t, ok, fr


def _quad_hits(ox, oy, oz, dx, dy, dz, quad, t_min, t_cap):
    """(B, Nq) hit distance, accept mask and front flag of every quad."""
    qnx, qny, qnz, cn = quad[0], quad[1], quad[2], quad[3]
    usx, usy, usz, cu = quad[4], quad[5], quad[6], quad[7]
    vsx, vsy, vsz, cv = quad[8], quad[9], quad[10], quad[11]
    ox, oy, oz = ox[:, None], oy[:, None], oz[:, None]
    dx, dy, dz = dx[:, None], dy[:, None], dz[:, None]
    dn = dx * qnx + dy * qny + dz * qnz
    on = ox * qnx + oy * qny + oz * qnz
    denom_ok = torch.abs(dn) >= 1e-8
    inv_dn = torch.where(denom_ok, 1.0 / torch.where(denom_ok, dn, 1.0), 0.0)
    t = (cn - on) * inv_dn
    a = (ox * usx + oy * usy + oz * usz) \
        + t * (dx * usx + dy * usy + dz * usz) - cu
    b = (ox * vsx + oy * vsy + oz * vsz) \
        + t * (dx * vsx + dy * vsy + dz * vsz) - cv
    ok = denom_ok & (t > t_min) & (a * a < 1.0) & (b * b < 1.0) & (t <= t_cap)
    fr = on - cn > 0.0
    return t, ok, fr


def _closest_hit(ox, oy, oz, dx, dy, dz, sph, quad, t_min, t_cap):
    """Brute-force closest hit of B rays against every sphere and quad:
    the lexicographic minimum of (t, ordinal) over accepted primitives,
    which is what the strict-< / lowest-ordinal fold computes in any
    visit order.  Returns (best_t, col, front): best_t = BIG on a miss,
    col the winner's column in [spheres | quads]."""
    n_prims = sph.shape[1] + quad.shape[1]
    ords = torch.cat([sph[5], quad[13]])
    step = max(1, CHUNK_ELEMS // n_prims)
    best_t, cols, fronts = [], [], []
    for lo in range(0, ox.shape[0], step):
        ray = tuple(v[lo:lo + step] for v in (ox, oy, oz, dx, dy, dz))
        ts, oks, frs = _sphere_hits(*ray, sph, t_min, t_cap)
        tq, okq, frq = _quad_hits(*ray, quad, t_min, t_cap)
        # A candidate must beat the fold's initial (BIG, 2^24) carry.
        t = torch.cat([ts, tq], 1)
        ok = torch.cat([oks, okq], 1) & (t <= BIG)
        t = torch.where(ok, t, math.inf)
        tmin = t.min(1).values
        tie_ord = torch.where(t == tmin[:, None], ords, math.inf)
        col = tie_ord.argmin(1)
        best_t.append(torch.where(tmin < BIG, tmin, BIG))
        cols.append(col)
        fronts.append(torch.cat([frs, frq], 1).gather(1, col[:, None])[:, 0])
    return torch.cat(best_t), torch.cat(cols), torch.cat(fronts)


def _bounce(state, rng_d, sph, quad, mats, t_min, t_cap, sky):
    """One bounce of the alive rays; returns the new state and `cont`."""
    ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb = state
    best_t, col, fr = _closest_hit(ox, oy, oz, dx, dy, dz, sph, quad,
                                   t_min, t_cap)
    hit = best_t < BIG
    n_sph = sph.shape[1]
    is_sph_k = hit & (col < n_sph)
    cs = col.clamp(max=n_sph - 1)
    cq = (col - n_sph).clamp(min=0)
    gx = torch.where(hit, torch.where(is_sph_k, sph[0, cs], quad[0, cq]), 0.0)
    gy = torch.where(hit, torch.where(is_sph_k, sph[1, cs], quad[1, cq]), 0.0)
    gz = torch.where(hit, torch.where(is_sph_k, sph[2, cs], quad[2, cq]), 0.0)
    mid = torch.where(is_sph_k, sph[4, cs], quad[12, cq]).long()
    m_type = torch.where(hit, mats[0, mid].long(), 0)
    m_c0 = torch.where(hit, mats[1, mid], 0.0)
    m_c1 = torch.where(hit, mats[2, mid], 0.0)
    m_c2 = torch.where(hit, mats[3, mid], 0.0)
    m_extra = torch.where(hit, mats[4, mid], 0.0)
    front = (hit & fr).to(torch.float32)

    px = ox + best_t * dx
    py = oy + best_t * dy
    pz = oz + best_t * dz
    nrx = torch.where(is_sph_k, px - gx, gx)
    nry = torch.where(is_sph_k, py - gy, gy)
    nrz = torch.where(is_sph_k, pz - gz, gz)
    n_ilen = ieee.rsqrt(torch.clamp_min(nrx * nrx + nry * nry + nrz * nrz,
                                        1e-30))
    sgn_n = (front * 2.0 - 1.0) * n_ilen
    nx = nrx * sgn_n
    ny = nry * sgn_n
    nz = nrz * sgn_n

    # miss: sky * throughput; emission before the scatter test
    mw = (~hit).to(torch.float32)
    rr = rr + mw * tr * sky[0]
    rg = rg + mw * tg * sky[1]
    rb = rb + mw * tb * sky[2]
    lw = hit.to(torch.float32) * (m_type == MAT_EMISSIVE).to(torch.float32)
    rr = rr + lw * tr * m_c0
    rg = rg + lw * tg * m_c1
    rb = rb + lw * tb * m_c2

    u1 = rng.uniform01(rng_d, 1)
    u2 = rng.uniform01(rng_d, 2)
    u3 = rng.uniform01(rng_d, 3)
    z = 1.0 - 2.0 * u1
    rxy = ieee.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    ux = rxy * ieee.cos(phi)
    uy = rxy * ieee.sin(phi)
    uz = z

    is_lam = m_type == MAT_LAMBERTIAN
    is_met = m_type == MAT_METAL
    is_die = m_type == MAT_DIELECTRIC

    lx = nx + ux
    ly = ny + uy
    lz = nz + uz
    degen = (torch.abs(lx) < 1e-8) & (torch.abs(ly) < 1e-8) \
        & (torch.abs(lz) < 1e-8)
    lx = torch.where(degen, nx, lx)
    ly = torch.where(degen, ny, ly)
    lz = torch.where(degen, nz, lz)

    dn_ = dx * nx + dy * ny + dz * nz
    rxm = dx - 2.0 * dn_ * nx + m_extra * ux
    rym = dy - 2.0 * dn_ * ny + m_extra * uy
    rzm = dz - 2.0 * dn_ * nz + m_extra * uz

    ri = torch.where(front > 0, 1.0 / m_extra, m_extra)
    cos_t = torch.clamp_max(-(dx * nx + dy * ny + dz * nz), 1.0)
    sin_t = ieee.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot = ri * sin_t > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    one_mc = 1.0 - cos_t
    schl = r0 + (1.0 - r0) * one_mc * one_mc * one_mc * one_mc * one_mc
    refl_choice = cannot | (schl > u3)
    qx = ri * (dx + cos_t * nx)
    qy = ri * (dy + cos_t * ny)
    qz = ri * (dz + cos_t * nz)
    qpar = -ieee.sqrt(torch.abs(1.0 - (qx * qx + qy * qy + qz * qz)))
    fx = qx + qpar * nx
    fy = qy + qpar * ny
    fz = qz + qpar * nz
    gx = dx - 2.0 * dn_ * nx
    gy = dy - 2.0 * dn_ * ny
    gz = dz - 2.0 * dn_ * nz
    ex = torch.where(refl_choice, gx, fx)
    ey = torch.where(refl_choice, gy, fy)
    ez = torch.where(refl_choice, gz, fz)

    sx = torch.where(is_lam, lx, torch.where(is_met, rxm, ex))
    sy = torch.where(is_lam, ly, torch.where(is_met, rym, ey))
    sz = torch.where(is_lam, lz, torch.where(is_met, rzm, ez))
    ilen = ieee.rsqrt(torch.clamp_min(sx * sx + sy * sy + sz * sz, 1e-30))
    sx = sx * ilen
    sy = sy * ilen
    sz = sz * ilen

    met_ok = (sx * nx + sy * ny + sz * nz) > 0.0
    scat_ok = torch.where(is_met, met_ok, is_lam | is_die)
    att_r = torch.where(is_die, 1.0, m_c0)
    att_g = torch.where(is_die, 1.0, m_c1)
    att_b = torch.where(is_die, 1.0, m_c2)

    cont = hit & scat_ok
    cw = cont.to(torch.float32)
    ncw = 1.0 - cw
    tr = tr * (ncw + cw * att_r)
    tg = tg * (ncw + cw * att_g)
    tb = tb * (ncw + cw * att_b)
    ox = torch.where(cont, px, ox)
    oy = torch.where(cont, py, oy)
    oz = torch.where(cont, pz, oz)
    dx = torch.where(cont, sx, dx)
    dy = torch.where(cont, sy, dy)
    dz = torch.where(cont, sz, dz)
    return (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb), cont


def trace_reference(o, d, pix, seed: int, sph, quad, tri, sph_cl, quad_cl,
                    tri_cl, mats, *, max_depth: int, t_min: float,
                    t_max: float, sky, tri_live: bool, rr_depth: int = 0,
                    nee: bool = False, inst=None, checker=(), itex=(),
                    depth_out: bool = False,
                    collect_stats: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``trace`` (same signature and result).
    Each bounce runs on the rays still alive: a dead ray's bounce leaves
    its state unchanged, as in the TPU kernel's dead-tile exit."""
    _refuse(sky, tri_live=tri_live, rr_depth=rr_depth, nee=nee, inst=inst,
            checker=checker, itex=itex, depth_out=depth_out,
            collect_stats=collect_stats)
    r = o.shape[0]
    dev = o.device
    t_cap = _t_cap(t_max)
    sky = tuple(float(s) for s in sky)
    ones = torch.ones(r, dtype=torch.float32, device=dev)
    zeros = torch.zeros(r, dtype=torch.float32, device=dev)
    state = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
             ones, ones.clone(), ones.clone(), zeros, zeros.clone(),
             zeros.clone()]
    state = [s.contiguous().clone() for s in state]
    rng_base = rng.pcg_hash((pix.to(torch.int64) & rng.MASK32)
                            ^ (int(seed) & rng.MASK32))
    alive = torch.arange(r, device=dev)
    for depth in range(max_depth):
        if alive.numel() == 0:
            break
        rng_d = (rng_base[alive] + depth * rng.DEPTH_STEP) & rng.MASK32
        new, cont = _bounce([s[alive] for s in state], rng_d, sph, quad,
                            mats, t_min, t_cap, sky)
        for s, v in zip(state, new):
            s[alive] = v
        alive = alive[cont]
    return torch.stack(state[9:12], dim=1)
