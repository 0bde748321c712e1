"""Edge-aware à-trous denoiser with SVGF-style guide weights (the
counterpart of ``parallelraytracing_tpu.postfx.denoise``).

Dammertz et al. 2010, "Edge-Avoiding À-Trous Wavelet Transform", with
the guides of SVGF: the first hit's normal, albedo and depth, from one
deterministic pass of pixel-center rays through the brute-force
intersector (``aux_buffers``), so the guides carry no noise.  Each level
is a 5x5 sparse-tap filter whose tap spacing doubles from level to level,
its weights the B3-spline tap times a normal, a depth and a luminance
edge-stopper; the luminance sigma scales with the local 3x3 noise level,
and the albedo is divided out before filtering and put back after, so
texture detail survives.  The filter runs on the film's HDR mean in plain
PyTorch (elementwise work on (H, W) planes; a fused kernel for it is
queued, ROADMAP).  ``--denoise N`` on the CLI applies N levels before the
PNG is encoded.
"""

from __future__ import annotations

import torch

#: the 1D B3-spline kernel of the à-trous wavelet (outer product: 5x5)
_H = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def aux_buffers(scene, cam_params: torch.Tensor, cfg):
    """The noise-free guides of one pass of pixel-center rays: (normal
    (H, W, 3), unit or 0 on a miss; albedo (H, W, 3), the surface's with
    its texture or the sky's radiance on a miss; depth (H, W), the hit
    distance, +inf on a miss).  The rays are intersected in tiles of
    ``cfg.ray_tile``, which bound the (rays x chunk) transients and do not
    change a ray's result."""
    from parallelraytracing_tpu_torch.ops.intersect import (intersect_scene,
                                                            prepare_scene)
    from parallelraytracing_tpu_torch.ops.materials import surface_albedo
    from parallelraytracing_tpu_torch.ops.rays import generate_camera_rays
    from parallelraytracing_tpu_torch.ops.sky import sky_radiance

    h, w = cfg.height, cfg.width
    o, d = generate_camera_rays(cam_params, w, h, None, jitter=False)
    normal = torch.empty_like(o)
    albedo = torch.empty_like(o)
    depth = torch.empty(o.shape[0], device=o.device)
    tile = max(1, int(cfg.ray_tile))
    prepared = prepare_scene(scene, cfg.intersect_chunk)
    for s in range(0, o.shape[0], tile):
        e = min(s + tile, o.shape[0])
        hit = intersect_scene(scene, o[s:e], d[s:e], cfg.t_min, cfg.t_max,
                              cfg.intersect_chunk, prepared)
        normal[s:e] = hit.normal
        albedo[s:e] = torch.where(hit.hit[:, None], surface_albedo(scene, hit),
                                  sky_radiance(scene, d[s:e]))
        depth[s:e] = hit.t
    return normal.reshape(h, w, 3), albedo.reshape(h, w, 3), depth.reshape(h, w)


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img shifted by (dy, dx), edges clamped (the same size; any
    trailing channel dims)."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


def _luma(rgb: torch.Tensor) -> torch.Tensor:
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def _local_std(lum: torch.Tensor) -> torch.Tensor:
    """Each pixel's luminance std over its 3x3 box: SVGF's tracked
    variance, recomputed at every level so the luminance edge-stopper
    adapts (noisy regions mix, converged ones keep their edges)."""
    s1 = torch.zeros_like(lum)
    s2 = torch.zeros_like(lum)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            t = _shift(lum, dy, dx)
            s1 = s1 + t
            s2 = s2 + t * t
    m = s1 / 9.0
    return torch.sqrt(torch.clamp_min(s2 / 9.0 - m * m, 0.0))


def atrous_denoise(rad: torch.Tensor, normal: torch.Tensor,
                   albedo: torch.Tensor, depth: torch.Tensor,
                   iterations: int = 4, sigma_n: float = 64.0,
                   sigma_d: float = 1.0, sigma_l: float = 4.0) -> torch.Tensor:
    """Edge-avoiding à-trous filter of an (H, W, 3) HDR image.

    A tap's weight: h(tap) * max(dot(n, n'), 0)^sigma_n * exp(-|z - z'| /
    (sigma_d |z|)) * exp(-|luma - luma'| / (sigma_l local_std + eps)); sky
    pixels mix only with sky.  The albedo is divided out before and
    multiplied back after."""
    eps = 1e-4
    out = rad / (albedo + eps)
    miss = ~torch.isfinite(depth)
    zsafe = torch.where(miss, 0.0, depth)
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2], dtype=out.dtype, device=out.device)
        lum0 = _luma(out)
        inv_sl = 1.0 / (sigma_l * _local_std(lum0) + eps)
        for iy, hy in enumerate(_H):
            for ix, hx in enumerate(_H):
                dy, dx = (iy - 2) * step, (ix - 2) * step
                n_t = _shift(normal, dy, dx)
                z_t = _shift(zsafe, dy, dx)
                m_t = _shift(miss, dy, dx)
                c_t = _shift(out, dy, dx)
                w_n = torch.pow(torch.clamp_min((normal * n_t).sum(dim=-1), 0.0),
                                sigma_n)
                w_n = torch.where(miss & m_t, 1.0,
                                  torch.where(miss ^ m_t, 0.0, w_n))
                w_z = torch.exp(-torch.abs(zsafe - z_t)
                                / (sigma_d * torch.abs(zsafe) + eps))
                w_z = torch.where(miss & m_t, 1.0, w_z)
                w_l = torch.exp(-torch.abs(lum0 - _luma(c_t)) * inv_sl)
                wgt = (hy * hx) * w_n * w_z * w_l
                acc = acc + c_t * wgt[..., None]
                wsum = wsum + wgt
        out = acc / torch.clamp_min(wsum, eps)[..., None]
    return out * (albedo + eps)


def denoise_film(film, scene, cam_params: torch.Tensor, cfg,
                 iterations: int = 4) -> torch.Tensor:
    """(H, W, 3) denoised HDR mean of the film's accumulation."""
    rad = film.hdr_average().reshape(cfg.height, cfg.width, 3)
    normal, albedo, depth = aux_buffers(scene, cam_params, cfg)
    return atrous_denoise(rad, normal, albedo, depth, iterations)


def save_denoised_png(path: str, film, scene, cam_params: torch.Tensor, cfg,
                      iterations: int = 4, exposure: float = 1.0,
                      gamma: float = 2.2) -> None:
    """Denoise the film and write a PNG through Film.save_png's display
    transform (Reinhard, gamma, +0.5 rounding to u8)."""
    from parallelraytracing_tpu_torch.core.film import display_rgba
    from parallelraytracing_tpu_torch.utils.png import write_png
    hdr = denoise_film(film, scene, cam_params, cfg, iterations)
    write_png(path, display_rgba(hdr, exposure, gamma).cpu().numpy())
