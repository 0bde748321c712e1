"""Texture codes and the texture evaluation of the megakernel engine
(the counterpart of ``parallelraytracing_tpu.ops.textures``).

``SceneData.mat_tex`` holds one code per material: ``TEX_NONE``, the
procedural 3D checker ``TEX_CHECKER`` (``mat_tex_param`` = [cell scale,
odd rgb]), or an image, ``TEX_IMAGE_BASE`` + its texture id.  The trace
and segment kernels evaluate both kinds themselves (csrc/bounce.cuh, and
the plain versions in ops/trace.py); ``checker_weight``,
``sample_atlas`` and ``textured_albedo`` here serve the megakernel
engine (engines/megakernel.py) and the denoiser's albedo guide.
"""

from __future__ import annotations

import torch

TEX_NONE = 0
TEX_CHECKER = 1
TEX_IMAGE_BASE = 2

#: the checker lattice's offset (1/pi): cell boundaries land at
#: (k - 0.3183) / scale, so surfaces at common coordinates (a y = 0
#: floor, integer walls) sit mid-cell rather than on a boundary, where the
#: hit point's rounding would flip the parity from pixel to pixel
CHECKER_OFFSET = 0.3183098861


def checker_weight(pos: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(R,) in {0, 1}: the parity of the world-space checker cell at pos
    (cells are cubes of edge 1 / scale)."""
    c = torch.floor(pos * scale[:, None] + CHECKER_OFFSET)
    return torch.abs(torch.remainder(c[:, 0] + c[:, 1] + c[:, 2], 2.0))


def sample_atlas(atlas: torch.Tensor, size: torch.Tensor, tex_id: torch.Tensor,
                 uv: torch.Tensor) -> torch.Tensor:
    """Bilinear, repeat-wrapped sample of atlas[tex_id] at uv.

    atlas (T, TH, TW, 3) zero-padded; size (T, 2) the true (h, w); tex_id
    (R,) int; uv (R, 2) with v up (image row 0 is v = 1).  Returns
    (R, 3)."""
    tex_id = tex_id.long()
    h = size[tex_id, 0].to(torch.float32)
    w = size[tex_id, 1].to(torch.float32)
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def fetch(yi, xi):
        # repeat-wrap into the texture's true extent, then gather
        yi = torch.remainder(yi, h).to(torch.int64)
        xi = torch.remainder(xi, w).to(torch.int64)
        return atlas[tex_id, yi, xi]

    c00 = fetch(y0, x0)
    c01 = fetch(y0, x0 + 1.0)
    c10 = fetch(y0 + 1.0, x0)
    c11 = fetch(y0 + 1.0, x0 + 1.0)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def textured_albedo(scene, hit, albedo: torch.Tensor) -> torch.Tensor:
    """`albedo` (R, 3) with each textured material's texture applied at
    the hit (``hit.uv`` is read only when the scene has image textures,
    where ``resolve_hit`` fills it)."""
    tex = scene.mat_tex[hit.mat]
    param = scene.mat_tex_param[hit.mat]
    odd = (tex == TEX_CHECKER) & (checker_weight(hit.pos, param[:, 0]) > 0.5)
    albedo = torch.where(odd[:, None], param[:, 1:4], albedo)
    if scene.tex_atlas is not None:
        is_img = tex >= TEX_IMAGE_BASE
        tid = torch.clamp(tex - TEX_IMAGE_BASE, 0, scene.tex_atlas.shape[0] - 1)
        img = sample_atlas(scene.tex_atlas, scene.tex_size, tid, hit.uv)
        albedo = torch.where(is_img[:, None], img * albedo, albedo)
    return albedo
