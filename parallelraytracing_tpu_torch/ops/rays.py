"""Camera ray generation (the counterpart of ``parallelraytracing_tpu.ops.rays``).

Replica of Camera::GetCameraRay (reference src/core/camera.h:104-132):
pinhole with a vertical FoV of 1 radian, Y-flipped NDC, looking down -Z,
world dir = x*right + y*up + z*(-front).  Jitter is pixel-keyed: a PCG hash
of (pixel id, frame seed), so a pixel's sample does not depend on the ray
order.  Thin-lens and QMC sampling are not in this port yet.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from parallelraytracing_tpu_torch.ops import ieee, rng

TAN_FOVY = math.tan(0.5)

_LENS_QMC = "thin-lens and QMC raygen: ROADMAP Queue 1 item 11"


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


def _pixel_u01(idx: torch.Tensor, seed: int, salt: int) -> torch.Tensor:
    """[0,1) uniform from PCG(pixel id ^ seed ^ salt word); salts 101/102
    are the sub-pixel jitter."""
    base = (idx.to(torch.int64) & rng.MASK32) ^ (int(seed) & rng.MASK32)
    return rng.uniform01(base, salt)


def pixel_keyed_jitter(idx: torch.Tensor, seed: int):
    """(jx, jy) in [0,1) keyed on the pixel id and the frame seed only."""
    return _pixel_u01(idx, seed, 101), _pixel_u01(idx, seed, 102)


def generate_camera_rays_ids(cam_params: torch.Tensor, width: int,
                             height: int, idx: torch.Tensor,
                             jitter: bool = True, pix_seed=None,
                             lens=None, qpt=None):
    """Rays (o, d), each (R, 3) float32, for an explicit flat pixel-id
    vector `idx` (R,) int32 on the rays' device.  `cam_params` is
    ``Camera.ray_params()`` as a float32 tensor on that device.  With
    `jitter`, `pix_seed` (a uint32 int) keys the per-pixel jitter; without
    it rays go through pixel centers."""
    if (lens is not None and lens[0] > 0.0) or qpt is not None:
        raise NotImplementedError(_LENS_QMC)
    if jitter and pix_seed is None:
        raise ValueError("jittered raygen needs pix_seed")
    pos = cam_params[0:3]
    right = cam_params[3:6]
    up = cam_params[6:9]
    front = cam_params[9:12]

    x = (idx % width).to(torch.float32)
    y = torch.div(idx, width, rounding_mode="floor").to(torch.float32)
    if jitter:
        jx, jy = pixel_keyed_jitter(idx, pix_seed)
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

    d = (dx[:, None] * right + dy[:, None] * up + dz[:, None] * (-front))
    norm = ieee.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    d = d / norm[:, None]
    o = pos.expand(d.shape).contiguous()
    return o, d
