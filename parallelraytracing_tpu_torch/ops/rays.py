"""Camera ray generation (the counterpart of ``parallelraytracing_tpu.ops.rays``).

Replica of Camera::GetCameraRay (reference src/core/camera.h:104-132):
pinhole with a vertical FoV of 1 radian, Y-flipped NDC, looking down -Z,
world dir = x*right + y*up + z*(-front).  Jitter is pixel-keyed: a PCG hash
of (pixel id, frame seed), so a pixel's sample does not depend on the ray
order.  Two extensions over the reference, as in the JAX package: a
thin lens (defocus blur, ``apply_thin_lens``, its aperture drawn from
salts 103/104) and QMC sampling (each pixel's draws rotate the sample's
shared 4D Halton point, ``halton_qpt``, by the pixel's own uniforms under
the frame-independent ``qmc_rotation_seed``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from parallelraytracing_tpu_torch.ops import ieee, rng

TAN_FOVY = math.tan(0.5)
#: float32 2 pi of the lens's polar sample
_TWO_PI32 = float(np.float32(2.0 * math.pi))


def frame_stream_seeds(skey) -> Tuple[int, int]:
    """Split the (frame, sample) key into the pixel-jitter seed (uint32)
    and the in-kernel path seed (int32), as the JAX package's
    ``frame_stream_seeds`` does: ``split``, then one ``randint`` each."""
    k_jit, k_path = rng.split(skey)
    jseed = rng.randint(k_jit, 0, 2**31 - 1)
    seed = rng.randint(k_path, 0, 2**31 - 1)
    return jseed, seed


def sample_key(seed: int, frame_index: int, sample: int):
    """The key of sample `sample` of frame `frame_index`:
    fold_in(fold_in(PRNGKey(seed), frame), sample)."""
    return rng.fold_in(rng.fold_in(rng.prng_key(seed), frame_index), sample)


def radical_inverse(i: int, base: int) -> float:
    """Van der Corput radical inverse of the integer i in `base` (host,
    float64)."""
    f, inv, r = 1.0 / base, 1.0 / base, 0.0
    while i > 0:
        r += (i % base) * f
        i //= base
        f *= inv
    return r


def halton_qpt(g: int) -> np.ndarray:
    """The (4,) float32 Halton point of global sample index g: bases 2
    and 3 drive the sub-pixel jitter, 5 and 7 the lens aperture."""
    return np.array([radical_inverse(g, b) for b in (2, 3, 5, 7)], np.float32)


def qmc_rotation_seed(seed: int) -> int:
    """The frame-independent seed (uint32) of the QMC rotations:
    randint(fold_in(PRNGKey(seed), 0x514D43), 0, 2**31 - 1), the JAX
    package's threefry draw.  Every engine uses this one seed, so the
    engines' films stay bit-identical with QMC on."""
    return rng.randint(rng.fold_in(rng.prng_key(seed), 0x514D43), 0,
                       2**31 - 1)


def _rot(u: torch.Tensor, off: float) -> torch.Tensor:
    """Cranley-Patterson rotation: (u + off) mod 1."""
    v = u + off
    return v - torch.floor(v)


def _pixel_u01(idx: torch.Tensor, seed: int, salt: int) -> torch.Tensor:
    """[0,1) uniform from PCG(pixel id ^ seed ^ salt word); salts 101/102
    are the sub-pixel jitter, 103/104 the lens aperture."""
    base = (idx.to(torch.int64) & rng.MASK32) ^ (int(seed) & rng.MASK32)
    return rng.uniform01(base, salt)


def pixel_keyed_jitter(idx: torch.Tensor, seed: int):
    """(jx, jy) in [0,1) keyed on the pixel id and the frame seed only."""
    return _pixel_u01(idx, seed, 101), _pixel_u01(idx, seed, 102)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """Rows of (R, 3) v over their float32 lengths."""
    norm = ieee.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])
    return v / norm[:, None]


def apply_thin_lens(o, d, cam_params, lens, u1, u2):
    """Thin-lens defocus of pinhole rays (an extension: the reference's
    cameras are all pinholes).  lens = (aperture radius, focus distance)
    in world units; (u1, u2) per-ray uniforms in [0, 1).  Each ray (o, d),
    d unit, is re-aimed from a point of the lens disk (area-uniform,
    radius R sqrt(u1), angle 2 pi u2, in the camera's right/up plane) at
    the point where it crosses the focal plane (perpendicular to `front`
    at the focus distance), so that plane stays sharp."""
    radius, fdist = (float(np.float32(x)) for x in lens)
    right = cam_params[3:6]
    up = cam_params[6:9]
    front = cam_params[9:12]
    r = radius * ieee.sqrt(u1)
    theta = _TWO_PI32 * u2
    lx = r * ieee.cos(theta)
    ly = r * ieee.sin(theta)
    t_f = fdist / torch.clamp_min(
        d[:, 0] * front[0] + d[:, 1] * front[1] + d[:, 2] * front[2], 1e-6)
    p = o + d * t_f[:, None]
    o2 = o + lx[:, None] * right + ly[:, None] * up
    return o2, _normalize(p - o2)


def generate_camera_rays_ids(cam_params: torch.Tensor, width: int,
                             height: int, idx: torch.Tensor,
                             jitter: bool = True, pix_seed=None,
                             lens=None, qpt=None):
    """Rays (o, d), each (R, 3) float32, for an explicit flat pixel-id
    vector `idx` (R,) int32 on the rays' device.  `cam_params` is
    ``Camera.ray_params()`` as a float32 tensor on that device.  With
    `jitter`, `pix_seed` (a uint32 int) keys the per-pixel jitter; without
    it rays go through pixel centers.

    lens = (aperture radius, focus distance) with a radius > 0 applies
    the thin lens, its aperture sample keyed on (pixel, pix_seed) by
    salts 103/104 (the lens center without a pix_seed).  qpt, the (4,)
    Halton point of ``halton_qpt`` (QMC sampling, with pix_seed the
    ``qmc_rotation_seed``), rotates each pixel's jitter and aperture
    draws by it."""
    if jitter and pix_seed is None:
        raise ValueError("jittered raygen needs pix_seed")
    if qpt is not None and pix_seed is None:
        raise ValueError("QMC raygen (qpt) needs pix_seed")
    qpt = None if qpt is None else [float(x) for x in np.asarray(qpt,
                                                                 np.float32)]
    pos = cam_params[0:3]
    right = cam_params[3:6]
    up = cam_params[6:9]
    front = cam_params[9:12]

    x = (idx % width).to(torch.float32)
    y = torch.div(idx, width, rounding_mode="floor").to(torch.float32)
    if jitter:
        jx, jy = pixel_keyed_jitter(idx, pix_seed)
        if qpt is not None:
            jx, jy = _rot(jx, qpt[0]), _rot(jy, qpt[1])
        px, py = x + jx, y + jy
    else:
        px, py = x + 0.5, y + 0.5

    ndc_x = (px / width) * 2.0 - 1.0
    ndc_y = 1.0 - (py / height) * 2.0
    dx = ndc_x * (width / height * TAN_FOVY)
    dy = ndc_y * TAN_FOVY
    dz = -torch.ones_like(dx)
    inv_len = ieee.rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv_len, dy * inv_len, dz * inv_len

    d = _normalize(dx[:, None] * right + dy[:, None] * up
                   + dz[:, None] * (-front))
    o = pos.expand(d.shape).contiguous()
    if lens is not None and lens[0] > 0.0:
        if pix_seed is not None:
            u1 = _pixel_u01(idx, pix_seed, 103)
            u2 = _pixel_u01(idx, pix_seed, 104)
            if qpt is not None:
                u1, u2 = _rot(u1, qpt[2]), _rot(u2, qpt[3])
        else:  # no seed: the lens center (a pinhole)
            u1 = u2 = torch.zeros_like(x)
        o, d = apply_thin_lens(o, d, cam_params, lens, u1, u2)
    return o, d
