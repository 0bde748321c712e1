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

The pixel-keyed route has two versions of one signature:
``generate_camera_rays_ids`` dispatches by device: on CUDA tensors one
launch of the hand-written kernel ``csrc/raygen.cu`` (counted on
``generate_camera_rays_ids.launches``), on CPU tensors the plain chain
``generate_camera_rays_ids_reference`` (counted on ``.plain``), which is
also the kernel's reference on the card.  The threefry key-drawn routes
of ``generate_camera_rays_flat`` and ``generate_camera_rays`` stay plain
PyTorch on every device.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from parallelraytracing_tpu_torch.ops import ieee, rng

TAN_FOVY = math.tan(0.5)
#: float32 2 pi of the lens's polar sample
_TWO_PI32 = float(np.float32(2.0 * math.pi))
#: the lower clamp of cos(d, front) in the thin lens's focal distance
_MIN_COS = 1e-6


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
        d[:, 0] * front[0] + d[:, 1] * front[1] + d[:, 2] * front[2],
        _MIN_COS)
    p = o + d * t_f[:, None]
    o2 = o + lx[:, None] * right + ly[:, None] * up
    return o2, _normalize(p - o2)


def _camera_rays(cam_params, width: int, height: int, idx, jxy, lens, lens_u):
    """Rays (o, d) through pixels `idx` at sub-pixel offsets `jxy` =
    (jx, jy), or the pixel centers for None; with a lens of radius > 0,
    its aperture sample at the uniforms `lens_u` = (u1, u2), or the lens
    center for None."""
    pos = cam_params[0:3]
    right = cam_params[3:6]
    up = cam_params[6:9]
    front = cam_params[9:12]

    x = (idx % width).to(torch.float32)
    y = torch.div(idx, width, rounding_mode="floor").to(torch.float32)
    if jxy is not None:
        px, py = x + jxy[0], y + jxy[1]
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
        if lens_u is None:  # the lens center (a pinhole)
            lens_u = (torch.zeros_like(x), torch.zeros_like(x))
        o, d = apply_thin_lens(o, d, cam_params, lens, *lens_u)
    return o, d


def _check_draws(jitter: bool, pix_seed, qpt) -> None:
    if jitter and pix_seed is None:
        raise ValueError("jittered raygen needs pix_seed")
    if qpt is not None and pix_seed is None:
        raise ValueError("QMC raygen (qpt) needs pix_seed")


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
    draws by it.

    On CUDA tensors one launch of csrc/raygen.cu (``.launches``), bit for
    bit the plain chain's rays on the card; on CPU tensors the plain chain
    (``.plain``)."""
    _check_draws(jitter, pix_seed, qpt)
    if idx.device.type == "cpu":
        generate_camera_rays_ids.plain += 1
        return generate_camera_rays_ids_reference(
            cam_params, width, height, idx, jitter, pix_seed, lens, qpt)
    return _raygen_kernel(cam_params, width, height, idx, jitter, pix_seed,
                          lens, qpt)


generate_camera_rays_ids.launches = 0
generate_camera_rays_ids.plain = 0


def generate_camera_rays_ids_reference(cam_params: torch.Tensor, width: int,
                                       height: int, idx: torch.Tensor,
                                       jitter: bool = True, pix_seed=None,
                                       lens=None, qpt=None):
    """``generate_camera_rays_ids`` as a chain of PyTorch operations on
    any device: the CPU's raygen and the kernel's reference."""
    _check_draws(jitter, pix_seed, qpt)
    qpt = None if qpt is None else [float(x) for x in np.asarray(qpt,
                                                                 np.float32)]
    jxy = lens_u = None
    if jitter:
        jxy = pixel_keyed_jitter(idx, pix_seed)
        if qpt is not None:
            jxy = _rot(jxy[0], qpt[0]), _rot(jxy[1], qpt[1])
    if lens is not None and lens[0] > 0.0 and pix_seed is not None:
        lens_u = _pixel_u01(idx, pix_seed, 103), _pixel_u01(idx, pix_seed, 104)
        if qpt is not None:
            lens_u = _rot(lens_u[0], qpt[2]), _rot(lens_u[1], qpt[3])
    return _camera_rays(cam_params, width, height, idx, jxy, lens, lens_u)


#: the kernel's draw and camera flags (csrc/raygen.cu)
_JITTER, _QMC, _LENS, _LENS_DRAW = 1, 2, 4, 8


def kernel_constants(width: int, height: int, lens=None,
                     qpt=None) -> np.ndarray:
    """The (9,) float32 scalars of a launch that depend on its inputs,
    each the float32 that ATen forms on the card from the plain chain's
    Python scalar: 1 / width and 1 / height (a CUDA tensor over a Python
    number is a multiply by the float32 reciprocal), width / height *
    tan(1/2), the Halton point (zeros without QMC), the lens's radius and
    focus distance (zeros without a lens).  The fixed ones (TAN_FOVY,
    _TWO_PI32, _MIN_COS) are constants of csrc/raygen.cu."""
    one = np.float32(1.0)
    q = np.zeros(4, np.float32) if qpt is None else np.asarray(qpt,
                                                               np.float32)
    radius, fdist = (0.0, 0.0) if lens is None else lens
    return np.array([one / np.float32(width), one / np.float32(height),
                     width / height * TAN_FOVY, *q, radius, fdist],
                    np.float32)


def _raygen_kernel(cam_params, width: int, height: int, idx, jitter: bool,
                   pix_seed, lens, qpt):
    """One launch of csrc/raygen.cu over `idx` on PyTorch's current
    stream."""
    from parallelraytracing_tpu_torch.ops import _build
    from parallelraytracing_tpu_torch.ops.pack import check_tensors
    from parallelraytracing_tpu_torch.ops.trace import stream_of
    r = int(idx.shape[0])
    check_tensors(idx.device, {"cam_params": cam_params},
                  {"idx": (idx, (r,))})
    if cam_params.numel() < 12:
        raise ValueError(f"cam_params has {cam_params.numel()} values; want "
                         f"Camera.ray_params()'s position, right, up, front")
    lens_on = lens is not None and lens[0] > 0.0
    flags = ((_JITTER if jitter else 0) | (_QMC if qpt is not None else 0)
             | (_LENS if lens_on else 0)
             | (_LENS_DRAW if lens_on and pix_seed is not None else 0))
    consts = kernel_constants(width, height, lens if lens_on else None, qpt)
    o = torch.empty((r, 3), dtype=torch.float32, device=idx.device)
    d = torch.empty((r, 3), dtype=torch.float32, device=idx.device)
    ptr = torch.Tensor.data_ptr
    err = _build.load("raygen")(
        *stream_of(idx.device), ptr(cam_params), ptr(idx), ptr(o), ptr(d), r,
        int(width), 0 if pix_seed is None else int(pix_seed) & rng.MASK32,
        flags, consts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if err != 0:
        raise RuntimeError(f"raygen kernel launch failed: cudaError_t {err}")
    generate_camera_rays_ids.launches += 1
    return o, d


def generate_camera_rays_flat(cam_params: torch.Tensor, width: int,
                              height: int, start: int, count: int, key=None,
                              jitter: bool = True, lens=None, pix_seed=None,
                              qpt=None):
    """Rays (o, d), each (count, 3), for the flat pixel range [start,
    start + count): the raygen of a block of the frame (ids past H*W give
    harmless dummy rays).  With `pix_seed` the draws are pixel-keyed as in
    ``generate_camera_rays_ids``; otherwise a threefry `key` draws the
    block's jitter (``uniform(key, (count, 2))``: x then y per ray) and a
    thin lens its aperture (``uniform(fold_in(key, 1), (count, 2))``), as
    the JAX package's ``generate_camera_rays_ids`` does with a key.
    Without a key and a seed, rays go through pixel centers and the lens
    center."""
    idx = torch.arange(count, dtype=torch.int32,
                       device=cam_params.device) + int(start)
    if pix_seed is not None:
        return generate_camera_rays_ids(cam_params, width, height, idx,
                                        jitter, pix_seed, lens, qpt)
    jxy = lens_u = None
    if key is not None:
        if jitter:
            u = rng.uniform(key, (count, 2), cam_params.device)
            jxy = u[:, 0], u[:, 1]
        if lens is not None and lens[0] > 0.0:
            u = rng.uniform(rng.fold_in(key, 1), (count, 2), cam_params.device)
            lens_u = u[:, 0], u[:, 1]
    return _camera_rays(cam_params, width, height, idx, jxy, lens, lens_u)


def generate_camera_rays(cam_params: torch.Tensor, width: int, height: int,
                         key=None, jitter: bool = True, lens=None,
                         pix_seed=None, qpt=None):
    """Rays (o, d), each (H*W, 3), of the whole frame in scanline order
    (pixel y * W + x), the megakernel engine's raygen.  With `pix_seed`
    the draws are pixel-keyed as in ``generate_camera_rays_ids``;
    otherwise a jittered frame draws its offsets from the threefry `key`
    (``uniform(key, (2, H, W))``: x offsets, then y) and a thin lens its
    aperture from ``uniform(fold_in(key, 1), (H*W, 2))``, as the JAX
    package's ``generate_camera_rays`` does.  Without a key and a seed,
    rays go through pixel centers and the lens center.  `key` may also be
    an (S, 2) tensor of S keys: then the S frames' rays, key-major
    ((S*H*W, 3)), each equal to its key's frame."""
    n = width * height
    dev = cam_params.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    if pix_seed is not None:
        return generate_camera_rays_ids(cam_params, width, height, idx,
                                        jitter, pix_seed, lens, qpt)
    keys = None if key is None else rng.as_key(key).reshape(-1, 2)
    counter = torch.arange(2 * n, dtype=torch.int64, device=dev)

    def draws(k):  # (S, 2n) uniforms of each key's draw of 2n elements
        return rng.uniform_from_bits(rng.bits_at(k.to(dev)[:, None], counter))

    jxy = lens_u = None
    if jitter and keys is not None:
        u = draws(keys)
        jxy = u[:, :n].reshape(-1), u[:, n:].reshape(-1)
    if lens is not None and lens[0] > 0.0 and keys is not None:
        u = draws(rng.fold_in_t(keys.cpu(), 1))
        lens_u = u[:, 0::2].reshape(-1), u[:, 1::2].reshape(-1)
    if keys is not None:
        idx = idx.repeat(keys.shape[0])
    return _camera_rays(cam_params, width, height, idx, jxy, lens, lens_u)
