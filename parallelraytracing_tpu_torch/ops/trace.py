"""The fused trace: every bounce of every ray in one kernel launch.

The counterpart of ``pallas_trace`` (``parallelraytracing_tpu/ops/pallas_trace.py``)
on sphere, quad and triangle scenes with the constant sky.  Two functions
of one signature:

- ``trace``: the wrapper.  On a CUDA tensor it launches the hand-written
  kernel ``csrc/trace.cu`` (built at first use, ops/_build.py) or raises;
  on a CPU tensor it runs ``trace_reference``.  ``trace.launches`` counts
  kernel launches.
- ``trace_reference``: the plain PyTorch version, vectorised over rays.
  Its closest hit is a brute-force fold over every sphere, quad and
  triangle column (an independent check of the kernel's tree walk);
  everything after the fold follows the order of operations of
  ``_make_bounce_step``.  ``_bounce`` is shared with the segment
  kernel's plain version (ops/segment.py).

Rays: o, d (R, 3) float32; pix (R,) int32 pixel ids keying the PCG
streams; seed the frame's int32 path seed.  Tables: the (C, N) float32
tables of ops/pack.py (or of the JAX package, via convert.py).  Returns
(R, 3) float32 radiance.

A triangle kind of never-hit pad columns (``tri_live`` False) is skipped.
Not in this port yet, refused with NotImplementedError: NEE, Russian
roulette, instances, checker and image textures, the directional sky,
``depth_out`` and ``collect_stats``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from parallelraytracing_tpu_torch.core.scene import (MAT_DIELECTRIC, MAT_EMISSIVE,
                                                  MAT_LAMBERTIAN, MAT_METAL)
from parallelraytracing_tpu_torch.ops import ieee, rng
from parallelraytracing_tpu_torch.ops.pack import CLUSTER, TRI_CLUSTER

BIG = 3.0e38
TWO_PI = 2.0 * math.pi
#: t_max at or above this is the "infinite" horizon: no upper-bound test
T_MAX_INF = 1e30
#: rays x primitives per chunk of the plain version's brute-force fold
CHUNK_ELEMS = 1 << 23

_ROADMAP = {
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
    _refuse(sky, rr_depth=rr_depth, nee=nee, inst=inst, checker=checker,
            itex=itex, depth_out=depth_out, collect_stats=collect_stats)
    if o.device.type == "cpu":
        return trace_reference(o, d, pix, seed, sph, quad, tri, sph_cl,
                               quad_cl, tri_cl, mats, max_depth=max_depth,
                               t_min=t_min, t_max=t_max, sky=sky,
                               tri_live=tri_live)
    if o.device.type != "cuda":
        raise ValueError(f"trace runs on cpu or cuda tensors, not {o.device}")
    r = int(o.shape[0])
    if o.shape != (r, 3) or d.shape != (r, 3):
        raise ValueError(f"rays: o {tuple(o.shape)}, d {tuple(d.shape)}; "
                         f"want (R,3), (R,3)")
    check_tensors(o.device, {"o": o, "d": d}, {"pix": (pix, (r,))})
    scene = scene_arg(o.device, sph, quad, tri, sph_cl, quad_cl, tri_cl,
                      mats, t_min=t_min, t_max=t_max, sky=sky,
                      tri_live=tri_live)

    from parallelraytracing_tpu_torch.ops import _build
    launch = _build.load("trace")
    out = torch.empty((r, 3), dtype=torch.float32, device=o.device)
    ptr = torch.Tensor.data_ptr
    err = launch(*stream_of(o.device), ctypes.byref(scene), ptr(o), ptr(d),
                 ptr(pix), ptr(out), r, int(seed) & rng.MASK32,
                 int(max_depth))
    if err != 0:
        raise RuntimeError(f"trace kernel launch failed: cudaError_t {err}")
    trace.launches += 1
    return out


trace.launches = 0


def stream_of(device) -> tuple:
    """(device index, PyTorch's current stream) for a kernel launch."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def check_tensors(device, floats: dict, ints: dict) -> None:
    """Validate what a kernel reads: float32 `floats` and int32 `ints`
    ({name: (tensor, shape)}), all contiguous and on `device`."""
    for name, (t, shape) in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}: want {shape}")
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in {**floats, **{k: v[0] for k, v in ints.items()}}.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, rays on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def scene_arg(device, sph, quad, tri, sph_cl, quad_cl, tri_cl, mats, *,
              t_min: float, t_max: float, sky, tri_live: bool):
    """Validate the tables a kernel reads and pack them into the
    ``PrtScene`` struct of csrc/bounce.cuh.  The struct holds raw device
    pointers: the tables must outlive the launch."""
    from parallelraytracing_tpu_torch.ops import _build
    check_tensors(device, {"sph": sph, "quad": quad, "tri": tri,
                           "sph_cl": sph_cl, "quad_cl": quad_cl,
                           "tri_cl": tri_cl, "mats": mats}, {})
    if (sph.shape[0] != 6 or quad.shape[0] != 14 or tri.shape[0] != 27
            or mats.shape[0] != 5):
        raise ValueError("tables: want sph (6,N), quad (14,N), tri (27,N), "
                         "mats (5,N)")
    # Each kind's linear table has one column per run of its own cluster
    # size (TRI_CLUSTER for triangles) plus the root pretest column.
    for name, cl, n, csize in (("sph_cl", sph_cl, sph.shape[1], CLUSTER),
                               ("quad_cl", quad_cl, quad.shape[1], CLUSTER),
                               ("tri_cl", tri_cl, tri.shape[1], TRI_CLUSTER)):
        n_cl = max(1, -(-int(n) // csize))
        if not (cl.shape[0] == 8
                or (cl.shape[0] == 6 and cl.shape[1] == n_cl + 1)):
            raise ValueError(f"{name} {tuple(cl.shape)}: want an (8, M) "
                             f"tree or a (6, {n_cl + 1}) linear table")
    ptr = torch.Tensor.data_ptr
    return _build.PrtScene(
        ptr(sph), ptr(sph_cl), sph.shape[1], *sph_cl.shape,
        ptr(quad), ptr(quad_cl), quad.shape[1], *quad_cl.shape,
        ptr(tri), ptr(tri_cl), tri.shape[1] if tri_live else 0,
        *tri_cl.shape,
        ptr(mats), mats.shape[1], CLUSTER, TRI_CLUSTER,
        float(t_min), _t_cap(t_max), float(sky[0]), float(sky[1]),
        float(sky[2]))


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


def _tri_hits(ox, oy, oz, dx, dy, dz, tri, t_min, t_cap):
    """(B, Nt) hit distance, accept mask and barycentrics b1, b2 of every
    triangle: the triple-product Moller-Trumbore of ``make_tri_body``."""
    ngx, ngy, ngz, p0ng = tri[0], tri[1], tri[2], tri[3]
    e1x, e1y, e1z = tri[4], tri[5], tri[6]
    e2x, e2y, e2z = tri[7], tri[8], tri[9]
    xpx, xpy, xpz = tri[10], tri[11], tri[12]   # e2 x p0
    pex, pey, pez = tri[13], tri[14], tri[15]   # p0 x e1
    wx = (oy * dz - oz * dy)[:, None]
    wy = (oz * dx - ox * dz)[:, None]
    wz = (ox * dy - oy * dx)[:, None]
    ox, oy, oz = ox[:, None], oy[:, None], oz[:, None]
    dx, dy, dz = dx[:, None], dy[:, None], dz[:, None]
    div = -(dx * ngx + dy * ngy + dz * ngz)
    div_ok = div != 0.0
    inv = torch.where(div_ok, 1.0 / torch.where(div_ok, div, 1.0), 0.0)
    t = (ox * ngx + oy * ngy + oz * ngz - p0ng) * inv
    b1 = ((wx * e2x + wy * e2y + wz * e2z)
          - (dx * xpx + dy * xpy + dz * xpz)) * inv
    b2 = (-(wx * e1x + wy * e1y + wz * e1z)
          - (dx * pex + dy * pey + dz * pez)) * inv
    ok = div_ok & (t >= t_min) & (b1 >= 0.0) & (b2 >= 0.0) \
        & (b1 + b2 <= 1.0) & (t <= t_cap)
    return t, ok, b1, b2


def _closest_hit(ox, oy, oz, dx, dy, dz, sph, quad, tri, t_min, t_cap):
    """Brute-force closest hit of B rays against every sphere, quad and
    (when `tri` is not None) triangle: the lexicographic minimum of (t,
    ordinal) over accepted primitives, which is what the strict-< /
    lowest-ordinal fold computes in any visit order.

    Returns (best_t, gx, gy, gz, front, is_sph, mid): best_t = BIG on a
    miss; the winner's raw geometry (sphere center, quad normal, or the
    unnormalised barycentric blend of the triangle's vertex normals), its
    front flag, kind and material id.  Fields of a missing ray are
    arbitrary."""
    n_s, n_q = sph.shape[1], quad.shape[1]
    n_t = 0 if tri is None else tri.shape[1]
    ords = torch.cat([sph[5], quad[13]] + ([tri[17]] if n_t else []))
    step = max(1, CHUNK_ELEMS // (n_s + n_q + n_t))
    outs = []
    for lo in range(0, ox.shape[0], step):
        ray = tuple(v[lo:lo + step] for v in (ox, oy, oz, dx, dy, dz))
        ts, oks, frs = _sphere_hits(*ray, sph, t_min, t_cap)
        tq, okq, frq = _quad_hits(*ray, quad, t_min, t_cap)
        ts, oks = [ts, tq], [oks, okq]
        if n_t:
            tt, okt, b1, b2 = _tri_hits(*ray, tri, t_min, t_cap)
            ts.append(tt)
            oks.append(okt)
        # A candidate must beat the fold's initial (BIG, 2^24) carry.
        t = torch.cat(ts, 1)
        ok = torch.cat(oks, 1) & (t <= BIG)
        t = torch.where(ok, t, math.inf)
        tmin = t.min(1).values
        tie_ord = torch.where(t == tmin[:, None], ords, math.inf)
        col = tie_ord.argmin(1)

        is_sph = col < n_s
        cs = col.clamp(max=n_s - 1)
        cq = (col - n_s).clamp(min=0, max=n_q - 1)
        front = torch.cat([frs, frq], 1).gather(
            1, col.clamp(max=n_s + n_q - 1)[:, None])[:, 0]
        g = [torch.where(is_sph, sph[k, cs], quad[k, cq]) for k in range(3)]
        mid = torch.where(is_sph, sph[4, cs], quad[12, cq])
        if n_t:
            is_tri = col >= n_s + n_q
            ct = (col - n_s - n_q).clamp(min=0)
            b1 = b1.gather(1, ct[:, None])[:, 0]
            b2 = b2.gather(1, ct[:, None])[:, 0]
            b0 = 1.0 - b1 - b2
            inrm = [b0 * tri[18 + k, ct] + b1 * tri[21 + k, ct]
                    + b2 * tri[24 + k, ct] for k in range(3)]
            back = (ray[3] * inrm[0] + ray[4] * inrm[1] + ray[5] * inrm[2]) > 0.0
            g = [torch.where(is_tri, a, b) for a, b in zip(inrm, g)]
            front = torch.where(is_tri, ~back, front)
            mid = torch.where(is_tri, tri[16, ct], mid)
        outs.append((torch.where(tmin < BIG, tmin, BIG), *g, front, is_sph,
                     mid.long()))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _bounce(state, rng_d, sph, quad, tri, mats, t_min, t_cap, sky):
    """One bounce of the alive rays; returns the new state and `cont`.
    `tri` is None when the scene has no hittable triangle."""
    ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb = state
    best_t, gx, gy, gz, fr, is_sph, mid = _closest_hit(
        ox, oy, oz, dx, dy, dz, sph, quad, tri, t_min, t_cap)
    hit = best_t < BIG
    is_sph_k = hit & is_sph
    gx = torch.where(hit, gx, 0.0)
    gy = torch.where(hit, gy, 0.0)
    gz = torch.where(hit, gz, 0.0)
    m_type = torch.where(hit, mats[0, mid].long(), 0)
    m_c0 = torch.where(hit, mats[1, mid], 0.0)
    m_c1 = torch.where(hit, mats[2, mid], 0.0)
    m_c2 = torch.where(hit, mats[3, mid], 0.0)
    m_extra = torch.where(hit, mats[4, mid], 0.0)
    front = (hit & fr).to(torch.float32)

    # Deferred shading normal: spheres carried their center, quads the
    # unit plane normal, triangles the raw interpolated normal.
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
    _refuse(sky, rr_depth=rr_depth, nee=nee, inst=inst, checker=checker,
            itex=itex, depth_out=depth_out, collect_stats=collect_stats)
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
                            tri if tri_live else None, mats, t_min, t_cap,
                            sky)
        for s, v in zip(state, new):
            s[alive] = v
        alive = alive[cont]
    return torch.stack(state[9:12], dim=1)
