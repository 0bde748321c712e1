"""The plain reference that decides ``correct``: the renderer's image
worked out again from the benchmark's own inputs.

Plain PyTorch and numpy, importing nothing of the renderer.  From a
configuration's expanded scene (``scenes.expand``) and a camera it
derives everything the renderer derives: the scene baked to world space
and packed into per-kind tables, the per-frame seeds (threefry2x32 on the
host: ``fold_in(fold_in(PRNGKey(seed), frame), 0)``, split, one randint
each), the pixel-keyed jittered camera rays (a PCG hash of the pixel id
and the frame's jitter seed), the paths (closest hit over spheres, quads
and triangles; Lambertian, metal, dielectric and emissive materials; the
constant sky; streams keyed on the pixel id and the absolute depth), the
film's per-pixel sum and its tonemap (Reinhard, gamma 1/2.2, 8 bits).
The arithmetic is written to round as the renderer's kernels round
(sqrt and the transcendentals taken in float64 and rounded once), so the
two agree ray by ray except where a path grazes a primitive.

Triangles are found through clusters of the benchmark's own making (32
consecutive triangles of a Morton order, each behind a padded box): a
cluster whose box a ray misses holds no triangle the ray can hit, so the
closest hit is the brute-force fold's over every triangle.

``dtype`` computes a path in another precision: the control
(``torch.bfloat16``) is this reference a precision below the
configuration's float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
SALT_STEP = 0x9E3779B9
DEPTH_STEP = 0x85EBCA6B
BIG = 3.0e38
TWO_PI = 2.0 * math.pi
TAN_FOVY = math.tan(0.5)
LAMBERTIAN, METAL, DIELECTRIC, EMISSIVE = 0, 1, 2, 3
MAT_CODES = {"lambertian": LAMBERTIAN, "metal": METAL,
             "dielectric": DIELECTRIC, "emissive": EMISSIVE}
#: triangles a cluster holds, and the padding of its box (world units)
CLUSTER = 32
BOX_PAD = 1e-3
#: elements (rays x primitives) of one block of the closest-hit fold
BLOCK_ELEMS = 1 << 25
#: a t_max at or above this has no upper-bound test (the renderer's rule)
T_MAX_INF = 1e30


def t_cap(t_max: float) -> float:
    return math.inf if t_max >= T_MAX_INF else float(t_max)


# --------------------------------------------------------------------------
# seeds: threefry2x32 on the host, as jax.random derives them
# --------------------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    with np.errstate(over="ignore"):
        k0, k1 = np.uint32(key[0]), np.uint32(key[1])
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _fold_in(key, data: int):
    a, b = threefry2x32(key, np.uint32(0), np.uint32(int(data) & MASK32))
    return int(a), int(b)


def _split(key):
    a, b = threefry2x32(key, np.zeros(2, np.uint32), np.arange(2, dtype=np.uint32))
    return [(int(a[i]), int(b[i])) for i in range(2)]


def _bits32(key) -> int:
    a, b = threefry2x32(key, np.uint32(0), np.uint32(0))
    return int(a ^ b)


def _randint(key, maxval: int = 2**31 - 1) -> int:
    """randint(key, (), 0, maxval, int32): the two-word modular draw."""
    hi_key, lo_key = _split(key)
    higher, lower = _bits32(hi_key), _bits32(lo_key)
    multiplier = (1 << 16) % maxval
    multiplier = ((multiplier * multiplier) & MASK32) % maxval
    offset = (((higher % maxval) * multiplier) & MASK32) + lower % maxval
    return (offset & MASK32) % maxval


def frame_seeds(seed: int, frame: int):
    """(jitter seed, path seed) of sample 0 of progressive frame `frame`
    under the run's seed."""
    key = _fold_in(_fold_in((0, int(seed) & MASK32), frame), 0)
    k_jit, k_path = _split(key)
    return _randint(k_jit), _randint(k_path)


# --------------------------------------------------------------------------
# per-ray streams: the PCG hash
# --------------------------------------------------------------------------

def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def uniform01(counter: torch.Tensor, salt: int, dt) -> torch.Tensor:
    bits = pcg_hash(counter ^ ((salt * SALT_STEP) & MASK32))
    return (bits >> 8).to(dt) * (1.0 / (1 << 24))


def _sqrt(x):
    return torch.sqrt(x.double()).to(x.dtype)


def _rsqrt(x):
    return 1.0 / _sqrt(x)


def _cos(x):
    return torch.cos(x.double()).to(x.dtype)


def _sin(x):
    return torch.sin(x.double()).to(x.dtype)


# --------------------------------------------------------------------------
# the scene, baked and packed
# --------------------------------------------------------------------------

def make_transform(scale, euler_deg, translation) -> np.ndarray:
    """4x4 affine T * Rx Ry Rz * S (angles in degrees)."""
    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)

    x, y, z = np.radians(np.asarray(euler_deg, np.float64))
    m = np.eye(4)
    m[:3, :3] = (rx(x) @ ry(y) @ rz(z)) * np.asarray(scale, np.float64)[None, :]
    m[:3, 3] = np.asarray(translation, np.float64)
    return m


def _matrix(t) -> np.ndarray:
    return np.eye(4) if t is None else make_transform(*t)


def _point(m, p):
    return m[:3, :3] @ np.asarray(p, np.float64) + m[:3, 3]


def _normal(inv, n):
    out = inv[:3, :3].T @ np.asarray(n, np.float64)
    return out / np.linalg.norm(out)


def _morton(points: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points quantised to 1024 cells an axis of
    their bounding box."""
    lo, hi = points.min(0), points.max(0)
    q = ((points - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64)
    code = np.zeros(len(points), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


@dataclasses.dataclass
class RefScene:
    """The packed scene on one device: sph (6, Ns) = center, r^2,
    material, ordinal; quad (14, Nq) = unit normal, n.c, u / |u|^2, u.c,
    v / |v|^2, v.c, material, ordinal; tri (27, Nt) = the triple-product
    test's rows (n_g, p0.n_g, e1, e2, e2 x p0, p0 x e1), material,
    ordinal, the three vertex normals; mats (5, Nm) = type, color
    (emission for an emitter, else albedo), extra (roughness, ior or 1);
    the triangles' clusters: boxes (C, 6), members (C, CLUSTER) with -1
    pads.  An ordinal numbers spheres, then quads, then triangles, in the
    order the scene lists them: the closest hit takes the lowest one on
    equal distances."""
    sph: torch.Tensor
    quad: torch.Tensor
    tri: Optional[torch.Tensor]
    boxes: Optional[torch.Tensor]
    members: Optional[torch.Tensor]
    mats: torch.Tensor
    sky: tuple
    #: bytes of the scene as its description gives it (the roofline's
    #: floor reads them once)
    scene_bytes: int = 0

    @classmethod
    def build(cls, sky, mats, objs, device, dtype=torch.float32) -> "RefScene":
        sph, quad, tri = [], [], []
        for o in objs:
            m = _matrix(o["transform"])
            if o["kind"] == "sphere":
                lens = np.linalg.norm(m[:3, :3], axis=0)
                sph.append((_point(m, (0, 0, 0)), o["radius"] * float(lens[0]),
                            o["material"]))
            elif o["kind"] == "quad":
                inv = np.linalg.inv(m)
                c = _point(m, (0, 0, 0))
                u = _point(m, (o["width"] / 2.0, 0, 0)) - c
                v = _point(m, (0, 0, o["height"] / 2.0)) - c
                quad.append((c, u, v, _normal(inv, (0, 1, 0)), o["material"]))
            else:
                verts, idx, nrm = o["mesh"]
                inv = np.linalg.inv(m)
                w = verts.astype(np.float64) @ m[:3, :3].T + m[:3, 3]
                n = nrm.astype(np.float64) @ inv[:3, :3]
                n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
                f = idx.reshape(-1, 3).astype(np.int64)
                tri.append((w[f[:, 0]], w[f[:, 1]], w[f[:, 2]], n[f[:, 0]],
                            n[f[:, 1]], n[f[:, 2]],
                            np.full(len(f), o["material"])))
        f32 = np.float32
        ns, nq = len(sph), len(quad)

        c = np.array([s[0] for s in sph], np.float64).astype(f32).reshape(-1, 3)
        r = np.array([s[1] for s in sph], np.float64).astype(f32)
        sph_t = np.concatenate([c.T, (r * r)[None],
                                np.array([[s[2] for s in sph]], f32),
                                np.arange(ns, dtype=f32)[None]])
        qc, qu, qv, qn = (np.array([q[k] for q in quad], np.float64).astype(f32)
                          .reshape(-1, 3) for k in range(4))
        us = qu / np.maximum((qu * qu).sum(1, keepdims=True), 1e-30)
        vs = qv / np.maximum((qv * qv).sum(1, keepdims=True), 1e-30)
        quad_t = np.concatenate([qn.T, (qc * qn).sum(1)[None], us.T,
                                 (qc * us).sum(1)[None], vs.T,
                                 (qc * vs).sum(1)[None],
                                 np.array([[q[4] for q in quad]], f32),
                                 (ns + np.arange(nq, dtype=f32))[None]])
        tri_t = boxes = members = None
        nbytes = ns * 5 * 4 + nq * 13 * 4 + len(mats) * 5 * 4
        if tri:
            v0, v1, v2, n0, n1, n2, tm = (np.concatenate(p) for p in zip(*tri))
            v0, v1, v2 = (v.astype(f32) for v in (v0, v1, v2))
            e1, e2 = v1 - v0, v2 - v0
            ng = np.cross(e1, e2)
            nt = len(v0)
            tri_t = np.concatenate([
                ng.T, (v0 * ng).sum(1)[None], e1.T, e2.T, np.cross(e2, v0).T,
                np.cross(v0, e1).T, tm.astype(f32)[None],
                (ns + nq + np.arange(nt, dtype=f32))[None],
                n0.astype(f32).T, n1.astype(f32).T, n2.astype(f32).T])
            order = np.argsort(_morton((v0 + v1 + v2).astype(np.float64) / 3.0),
                               kind="stable")
            n_cl = -(-nt // CLUSTER)
            members = np.full(n_cl * CLUSTER, -1, np.int64)
            members[:nt] = order
            members = members.reshape(n_cl, CLUSTER)
            vv = np.stack([v0, v1, v2], 1).astype(np.float64)  # (Nt, 3, 3)
            lo = np.full((n_cl, 3), np.inf)
            hi = np.full((n_cl, 3), -np.inf)
            for k in range(CLUSTER):
                sel = members[:, k] >= 0
                mem = members[sel, k]
                lo[sel] = np.minimum(lo[sel], vv[mem].min(1))
                hi[sel] = np.maximum(hi[sel], vv[mem].max(1))
            boxes = np.concatenate([lo - BOX_PAD, hi + BOX_PAD], 1)
            nbytes += nt * (9 + 9 + 1) * 4

        mt = np.array([MAT_CODES[m["type"]] for m in mats], f32)
        color = np.array([m.get("emission") if m["type"] == "emissive"
                          else m.get("albedo", (0.0, 0.0, 0.0)) for m in mats],
                         np.float64).astype(f32)
        extra = np.array([m["roughness"] if m["type"] == "metal" else
                          m["ior"] if m["type"] == "dielectric" else 1.0
                          for m in mats], np.float64).astype(f32)
        mats_t = np.concatenate([mt[None], color.T, extra[None]])

        def dev(a):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a)).to(device=device, dtype=dtype)

        sky32 = tuple(float(np.float32(s)) for s in sky)
        return cls(dev(sph_t), dev(quad_t), dev(tri_t), dev(boxes),
                   None if members is None else torch.from_numpy(members).to(device),
                   dev(mats_t), sky32, nbytes)


# --------------------------------------------------------------------------
# camera rays
# --------------------------------------------------------------------------

def camera_params(eye, view, width: int, height: int) -> np.ndarray:
    """[eye, right, up, front, width, height] float32 of a camera at
    `eye` looking along `view`, its basis from the world's +Y."""
    y = np.array([0.0, 1.0, 0.0])
    eye = np.asarray(eye, np.float64)
    front = np.asarray(view, np.float64)
    front = front / np.linalg.norm(front)
    right = np.cross(front, y)
    right = right / np.linalg.norm(right)
    up = np.cross(right, front)
    up = up / np.linalg.norm(up)
    return np.concatenate([eye, right, up, front,
                           [float(width), float(height)]]).astype(np.float32)


def camera_rays(cam: torch.Tensor, width: int, height: int,
                idx: torch.Tensor, jseed: torch.Tensor, dt):
    """(o, d), each (R, 3), of pixel ids `idx` (int64) jittered under the
    per-ray jitter seeds `jseed` (int64 uint32 words)."""
    base = (idx & MASK32) ^ (jseed & MASK32)
    jx, jy = uniform01(base, 101, dt), uniform01(base, 102, dt)
    pos, right, up, front = cam[0:3], cam[3:6], cam[6:9], cam[9:12]
    x = (idx % width).to(dt)
    y = torch.div(idx, width, rounding_mode="floor").to(dt)
    ndc_x = ((x + jx) / width) * 2.0 - 1.0
    ndc_y = 1.0 - ((y + jy) / height) * 2.0
    dx = ndc_x * (width / height * TAN_FOVY)
    dy = ndc_y * TAN_FOVY
    dz = -torch.ones_like(dx)
    inv_len = _rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv_len, dy * inv_len, dz * inv_len
    d = dx[:, None] * right + dy[:, None] * up + dz[:, None] * (-front)
    norm = _sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    d = d / norm[:, None]
    return pos.expand(d.shape).contiguous(), d


# --------------------------------------------------------------------------
# closest hit
# --------------------------------------------------------------------------

def _sphere_hits(ox, oy, oz, dx, dy, dz, sph, t_min, t_cap):
    ocx = ox[:, None] - sph[0]
    ocy = oy[:, None] - sph[1]
    ocz = oz[:, None] - sph[2]
    b2 = dx[:, None] * ocx + dy[:, None] * ocy + dz[:, None] * ocz
    cterm = ocx * ocx + ocy * ocy + ocz * ocz - sph[3]
    disc = b2 * b2 - cterm
    sq = _sqrt(torch.clamp_min(disc, 0.0))
    t_near = -b2 - sq
    fr = t_near >= t_min
    t = torch.where(fr, t_near, -b2 + sq)
    ok = (disc >= 0.0) & (t >= t_min) & (t <= t_cap)
    return t, ok, fr


def _quad_hits(ox, oy, oz, dx, dy, dz, quad, t_min, t_cap):
    ox, oy, oz = ox[:, None], oy[:, None], oz[:, None]
    dx, dy, dz = dx[:, None], dy[:, None], dz[:, None]
    dn = dx * quad[0] + dy * quad[1] + dz * quad[2]
    on = ox * quad[0] + oy * quad[1] + oz * quad[2]
    denom_ok = torch.abs(dn) >= 1e-8
    inv_dn = torch.where(denom_ok, 1.0 / torch.where(denom_ok, dn, 1.0), 0.0)
    t = (quad[3] - on) * inv_dn
    a = (ox * quad[4] + oy * quad[5] + oz * quad[6]) \
        + t * (dx * quad[4] + dy * quad[5] + dz * quad[6]) - quad[7]
    b = (ox * quad[8] + oy * quad[9] + oz * quad[10]) \
        + t * (dx * quad[8] + dy * quad[9] + dz * quad[10]) - quad[11]
    ok = denom_ok & (t > t_min) & (a * a < 1.0) & (b * b < 1.0) & (t <= t_cap)
    return t, ok, on - quad[3] > 0.0


def _tri_hits(ray, tri, t_min, t_cap):
    """(B, K) distance, accept mask and barycentrics of rays (each (B,)
    or (B, 1)) against triangles whose rows are (K,) or (B, K)."""
    ox, oy, oz, dx, dy, dz = ray
    wx = oy * dz - oz * dy
    wy = oz * dx - ox * dz
    wz = ox * dy - oy * dx
    div = -(dx * tri[0] + dy * tri[1] + dz * tri[2])
    div_ok = div != 0.0
    inv = torch.where(div_ok, 1.0 / torch.where(div_ok, div, 1.0), 0.0)
    t = (ox * tri[0] + oy * tri[1] + oz * tri[2] - tri[3]) * inv
    b1 = ((wx * tri[7] + wy * tri[8] + wz * tri[9])
          - (dx * tri[10] + dy * tri[11] + dz * tri[12])) * inv
    b2 = (-(wx * tri[4] + wy * tri[5] + wz * tri[6])
          - (dx * tri[13] + dy * tri[14] + dz * tri[15])) * inv
    ok = div_ok & (t >= t_min) & (b1 >= 0.0) & (b2 >= 0.0) \
        & (b1 + b2 <= 1.0) & (t <= t_cap)
    return t, ok, b1, b2


def _lexmin(t, ords):
    """(B,) smallest t of (B, N) candidates (inf where none is accepted)
    and the lowest ordinal among those at it."""
    tmin = t.min(1).values
    tie = torch.where(t == tmin[:, None], ords, math.inf)
    return tmin, tie.min(1).values


def _safe_inv(v):
    eps = 1e-20
    return 1.0 / torch.where(torch.abs(v) < eps, torch.where(v < 0, -eps, eps), v)


def _tri_closest(ray, sc: RefScene, t_min, t_cap):
    """(B,) closest accepted triangle distance (inf on none) and its
    ordinal: candidate clusters by their boxes, then the fold over their
    triangles."""
    ox, oy, oz, dx, dy, dz = ray
    b = ox.shape[0]
    dt = ox.dtype
    best_t = torch.full((b,), math.inf, dtype=dt, device=ox.device)
    best_o = torch.full((b,), math.inf, dtype=dt, device=ox.device)
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    bx = sc.boxes
    n_cl = bx.shape[0]
    step = max(1, BLOCK_ELEMS // n_cl)
    pr, pc = [], []
    for lo in range(0, b, step):
        s = slice(lo, lo + step)
        tx0 = (bx[:, 0] - ox[s, None]) * ix[s, None]
        tx1 = (bx[:, 3] - ox[s, None]) * ix[s, None]
        ty0 = (bx[:, 1] - oy[s, None]) * iy[s, None]
        ty1 = (bx[:, 4] - oy[s, None]) * iy[s, None]
        tz0 = (bx[:, 2] - oz[s, None]) * iz[s, None]
        tz1 = (bx[:, 5] - oz[s, None]) * iz[s, None]
        tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                         torch.minimum(ty0, ty1)),
                           torch.minimum(tz0, tz1))
        tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                         torch.maximum(ty0, ty1)),
                           torch.maximum(tz0, tz1))
        r_i, c_i = torch.nonzero((tf >= tn) & (tf >= t_min), as_tuple=True)
        pr.append(r_i + lo)
        pc.append(c_i)
    pr, pc = torch.cat(pr), torch.cat(pc)
    tri = sc.tri
    pstep = max(1, BLOCK_ELEMS // CLUSTER)
    for lo in range(0, pr.shape[0], pstep):
        rr, cc = pr[lo:lo + pstep], pc[lo:lo + pstep]
        mem = sc.members[cc]                         # (P, K)
        valid = mem >= 0
        cols = tri[:, mem.clamp(min=0)]              # (27, P, K)
        t, ok, _, _ = _tri_hits(tuple(v[rr][:, None] for v in ray), cols,
                                t_min, t_cap)
        t = torch.where(ok & valid, t, math.inf)
        tp, op = _lexmin(t, torch.where(valid, cols[17], math.inf))
        cur = torch.full_like(best_t, math.inf).scatter_reduce(
            0, rr, tp, "amin", include_self=True)
        new_t = torch.minimum(best_t, cur)
        # the lowest ordinal among every candidate at the new best distance
        keep = torch.where(best_t == new_t, best_o, math.inf)
        at = torch.where(tp == new_t[rr], op, math.inf)
        best_o = keep.scatter_reduce(0, rr, at, "amin", include_self=True)
        best_t = new_t
    return best_t, best_o


def closest_hit(ray, sc: RefScene, t_min: float, t_cap: float):
    """Closest hit of B rays: (t (BIG on a miss), geometry gx, gy, gz
    (sphere center, quad normal, or the triangle's blended vertex
    normal), front flag, the hit's kind (0 sphere, 1 quad, 2 triangle;
    any on a miss), material id)."""
    ox, oy, oz, dx, dy, dz = ray
    sph, quad = sc.sph, sc.quad
    ns, nq = sph.shape[1], quad.shape[1]
    dt = ox.dtype
    step = max(1, BLOCK_ELEMS // (ns + nq))
    ts, os_, fronts, cols = [], [], [], []
    for lo in range(0, ox.shape[0], step):
        r = tuple(v[lo:lo + step] for v in ray)
        t_s, ok_s, fr_s = _sphere_hits(*r, sph, t_min, t_cap)
        t_q, ok_q, fr_q = _quad_hits(*r, quad, t_min, t_cap)
        t = torch.cat([t_s, t_q], 1)
        ok = torch.cat([ok_s, ok_q], 1) & (t <= BIG)
        t = torch.where(ok, t, math.inf)
        ords = torch.cat([sph[5], quad[13]])
        tmin, omin = _lexmin(t, ords)
        col = torch.where(t == tmin[:, None], ords, math.inf).argmin(1)
        ts.append(tmin)
        os_.append(omin)
        cols.append(col)
        fronts.append(torch.cat([fr_s, fr_q], 1).gather(1, col[:, None])[:, 0])
    t, o, col, front = (torch.cat(x) for x in (ts, os_, cols, fronts))
    is_sph = col < ns
    cs = col.clamp(max=ns - 1)
    cq = (col - ns).clamp(min=0, max=nq - 1)
    g = [torch.where(is_sph, sph[k, cs], quad[k, cq]) for k in range(3)]
    mid = torch.where(is_sph, sph[4, cs], quad[12, cq])
    kind = (~is_sph).long()
    if sc.tri is not None:
        tt, to = _tri_closest(ray, sc, t_min, t_cap)
        win = (tt < t) | ((tt == t) & (to < o))
        is_tri = win & (tt < math.inf)
        tri = sc.tri
        ct = torch.where(is_tri, to - float(ns + nq), 0.0).long().clamp(
            0, tri.shape[1] - 1)
        rows = tri[:, ct]
        _, _, b1, b2 = _tri_hits(ray, rows, t_min, t_cap)
        b0 = 1.0 - b1 - b2
        inrm = [b0 * rows[18 + k] + b1 * rows[21 + k] + b2 * rows[24 + k]
                for k in range(3)]
        back = (dx * inrm[0] + dy * inrm[1] + dz * inrm[2]) > 0.0
        g = [torch.where(is_tri, a, bb) for a, bb in zip(inrm, g)]
        front = torch.where(is_tri, ~back, front)
        mid = torch.where(is_tri, rows[16], mid)
        kind = torch.where(is_tri, 2, kind)
        t = torch.where(is_tri, tt, t)
    t = torch.where(t < BIG, t, torch.tensor(BIG, dtype=dt, device=t.device))
    # ids come back exact in float32; a lower precision may round them
    return t, g, front, kind, mid.long().clamp(0, sc.mats.shape[1] - 1)


# --------------------------------------------------------------------------
# one bounce, and whole paths
# --------------------------------------------------------------------------

def bounce(state, rng_d, sc: RefScene, t_min: float, t_cap: float, counts):
    """One bounce of B live paths: (new state, continue mask).  state =
    [ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb]."""
    ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb = state
    dt = ox.dtype
    best_t, (gx, gy, gz), fr, kind, mid = closest_hit(
        (ox, oy, oz, dx, dy, dz), sc, t_min, t_cap)
    hit = best_t < BIG
    is_sph_k = hit & (kind == 0)
    mats = sc.mats
    m_type = torch.where(hit, mats[0, mid].long(), 0)
    m_c0 = torch.where(hit, mats[1, mid], 0.0)
    m_c1 = torch.where(hit, mats[2, mid], 0.0)
    m_c2 = torch.where(hit, mats[3, mid], 0.0)
    m_extra = torch.where(hit, mats[4, mid], 0.0)
    front = (hit & fr).to(dt)
    gx = torch.where(hit, gx, 0.0)
    gy = torch.where(hit, gy, 0.0)
    gz = torch.where(hit, gz, 0.0)

    px = ox + best_t * dx
    py = oy + best_t * dy
    pz = oz + best_t * dz
    nrx = torch.where(is_sph_k, px - gx, gx)
    nry = torch.where(is_sph_k, py - gy, gy)
    nrz = torch.where(is_sph_k, pz - gz, gz)
    n_ilen = _rsqrt(torch.clamp_min(nrx * nrx + nry * nry + nrz * nrz, 1e-30))
    sgn_n = (front * 2.0 - 1.0) * n_ilen
    nx, ny, nz = nrx * sgn_n, nry * sgn_n, nrz * sgn_n

    mw = (~hit).to(dt)
    rr = rr + mw * tr * sc.sky[0]
    rg = rg + mw * tg * sc.sky[1]
    rb = rb + mw * tb * sc.sky[2]
    lw = hit.to(dt) * (m_type == EMISSIVE).to(dt)
    rr = rr + lw * tr * m_c0
    rg = rg + lw * tg * m_c1
    rb = rb + lw * tb * m_c2

    is_lam = m_type == LAMBERTIAN
    is_met = m_type == METAL
    is_die = m_type == DIELECTRIC
    u1 = uniform01(rng_d, 1, dt)
    u2 = uniform01(rng_d, 2, dt)
    u3 = uniform01(rng_d, 3, dt)
    z = 1.0 - 2.0 * u1
    rxy = _sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    ux = rxy * _cos(phi)
    uy = rxy * _sin(phi)
    uz = z

    lx, ly, lz = nx + ux, ny + uy, nz + uz
    degen = (torch.abs(lx) < 1e-8) & (torch.abs(ly) < 1e-8) & (torch.abs(lz) < 1e-8)
    lx = torch.where(degen, nx, lx)
    ly = torch.where(degen, ny, ly)
    lz = torch.where(degen, nz, lz)

    dn_ = dx * nx + dy * ny + dz * nz
    rxm = dx - 2.0 * dn_ * nx + m_extra * ux
    rym = dy - 2.0 * dn_ * ny + m_extra * uy
    rzm = dz - 2.0 * dn_ * nz + m_extra * uz

    ri = torch.where(front > 0, 1.0 / m_extra, m_extra)
    cos_t = torch.clamp_max(-(dx * nx + dy * ny + dz * nz), 1.0)
    sin_t = _sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot = ri * sin_t > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    one_mc = 1.0 - cos_t
    schl = r0 + (1.0 - r0) * one_mc * one_mc * one_mc * one_mc * one_mc
    refl = cannot | (schl > u3)
    qx = ri * (dx + cos_t * nx)
    qy = ri * (dy + cos_t * ny)
    qz = ri * (dz + cos_t * nz)
    qpar = -_sqrt(torch.abs(1.0 - (qx * qx + qy * qy + qz * qz)))
    ex = torch.where(refl, dx - 2.0 * dn_ * nx, qx + qpar * nx)
    ey = torch.where(refl, dy - 2.0 * dn_ * ny, qy + qpar * ny)
    ez = torch.where(refl, dz - 2.0 * dn_ * nz, qz + qpar * nz)

    sx = torch.where(is_lam, lx, torch.where(is_met, rxm, ex))
    sy = torch.where(is_lam, ly, torch.where(is_met, rym, ey))
    sz = torch.where(is_lam, lz, torch.where(is_met, rzm, ez))
    ilen = _rsqrt(torch.clamp_min(sx * sx + sy * sy + sz * sz, 1e-30))
    sx, sy, sz = sx * ilen, sy * ilen, sz * ilen

    met_ok = (sx * nx + sy * ny + sz * nz) > 0.0
    scat_ok = torch.where(is_met, met_ok, is_lam | is_die)
    cont = hit & scat_ok
    cw = cont.to(dt)
    ncw = 1.0 - cw
    tr = tr * (ncw + cw * torch.where(is_die, 1.0, m_c0))
    tg = tg * (ncw + cw * torch.where(is_die, 1.0, m_c1))
    tb = tb * (ncw + cw * torch.where(is_die, 1.0, m_c2))
    if counts is not None:
        counts["segments"] += int(hit.shape[0])
        for k, name in enumerate(("sphere", "quad", "triangle")):
            counts[name] += int((hit & (kind == k)).sum())
        counts["scatter"] += int(cont.sum())
    ox = torch.where(cont, px, ox)
    oy = torch.where(cont, py, oy)
    oz = torch.where(cont, pz, oz)
    dx = torch.where(cont, sx, dx)
    dy = torch.where(cont, sy, dy)
    dz = torch.where(cont, sz, dz)
    return [ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb], cont


def trace_paths(o, d, pix, path_seed, sc: RefScene, max_depth: int,
                t_min: float, t_cap: float, counts=None) -> torch.Tensor:
    """(R, 3) radiance of R camera rays: pixel ids `pix` and per-ray path
    seeds `path_seed` (int64) key each bounce's stream."""
    r = o.shape[0]
    dt = o.dtype
    ones = torch.ones(r, dtype=dt, device=o.device)
    zeros = torch.zeros(r, dtype=dt, device=o.device)
    state = [o[:, 0].clone(), o[:, 1].clone(), o[:, 2].clone(),
             d[:, 0].clone(), d[:, 1].clone(), d[:, 2].clone(),
             ones.clone(), ones.clone(), ones.clone(),
             zeros.clone(), zeros.clone(), zeros.clone()]
    rng_base = pcg_hash((pix & MASK32) ^ (path_seed & MASK32))
    idx = torch.arange(r, device=o.device)
    for depth in range(max_depth):
        if idx.numel() == 0:
            break
        rng_d = (rng_base[idx] + depth * DEPTH_STEP) & MASK32
        new, cont = bounce([s[idx] for s in state], rng_d, sc, t_min, t_cap,
                           counts)
        for s, v in zip(state, new):
            s[idx] = v
        idx = idx[cont]
    return torch.stack(state[9:12], 1)


def new_counts() -> dict:
    """The paths' tally for the roofline's floor: ray segments traced,
    hits by the kind of the primitive hit, and scatters."""
    return {"segments": 0, "sphere": 0, "quad": 0, "triangle": 0,
            "scatter": 0}


# --------------------------------------------------------------------------
# the film
# --------------------------------------------------------------------------

def tonemap(hdr: torch.Tensor) -> torch.Tensor:
    """float32 HDR means -> uint8: Reinhard x / (1 + x), gamma 1 / 2.2,
    x 255 + 0.5 truncated."""
    x = hdr.float()
    x = x / (1.0 + x)
    x = torch.pow(torch.clamp_min(x, 0.0),
                  torch.tensor(1.0 / 2.2, dtype=torch.float32))
    return (torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def pixel_radiance(sc: RefScene, cam: np.ndarray, width: int, height: int,
                   pixels: np.ndarray, frames, seed: int, max_depth: int,
                   t_min: float, t_cap: float, device, dtype=torch.float32,
                   counts=None, rays_per_call: int = 1 << 21) -> np.ndarray:
    """(len(frames), len(pixels), 3) float64 radiance of sample 0 of each
    progressive frame in `frames` at each pixel id of `pixels`, under the
    camera parameters `cam` (``camera_params``)."""
    frames = list(frames)
    pix = torch.from_numpy(np.asarray(pixels, np.int64)).to(device)
    cam_t = torch.from_numpy(cam).to(device=device, dtype=dtype)
    seeds = np.array([frame_seeds(seed, f) for f in frames], np.int64)
    out = np.empty((len(frames), len(pixels), 3), np.float64)
    per = max(1, rays_per_call // max(1, len(pixels)))
    for lo in range(0, len(frames), per):
        s = torch.from_numpy(seeds[lo:lo + per]).to(device)
        nf = s.shape[0]
        idx = pix.repeat(nf)
        jseed = s[:, 0].repeat_interleave(len(pixels))
        pseed = s[:, 1].repeat_interleave(len(pixels))
        o, d = camera_rays(cam_t, width, height, idx, jseed, dtype)
        rad = trace_paths(o, d, idx, pseed, sc, max_depth, t_min, t_cap, counts)
        out[lo:lo + nf] = rad.double().reshape(nf, len(pixels), 3).cpu().numpy()
    return out
