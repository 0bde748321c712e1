"""Scene tables for the fused engine.

The counterpart of ``parallelraytracing_tpu/engines/tables.py``: the
packed per-kind tables, acceleration tables and material table of
ops/pack.py as float32 tensors on one device, plus the host-side facts the
trace needs (the constant sky, whether any triangle can be hit).  The TPU
package's SMEM/VMEM placement planning has no Hopper analogue: every table
is plain read-only device memory.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from parallelraytracing_tpu_torch.config import RenderConfig


@dataclasses.dataclass(frozen=True)
class SceneTables:
    sph: torch.Tensor      # (6, Ns)
    quad: torch.Tensor     # (14, Nq)
    tri: torch.Tensor      # (27, Nt)
    sph_cl: torch.Tensor   # (8, M) tree or (6, n_cl + 1) linear
    quad_cl: torch.Tensor
    tri_cl: torch.Tensor
    mats: torch.Tensor     # (5, Nm)
    #: the constant sky radiance
    sky: Tuple[float, float, float]
    #: True iff some triangle column has a non-zero geometric normal (a
    #: kind of never-hit pad columns is skipped by the trace)
    tri_live: bool
    #: the scene box as ((lo xyz), (1 / extent xyz)): the frame of
    #: wavefront_fused's origin-Morton sort key (ops/pack.scene_bbox)
    bb: Tuple[Tuple[float, float, float], Tuple[float, float, float]]


def build_scene_tables(scene, device):
    """Pack a Scene for the trace and segment kernels on `device`.

    Returns (SceneTables, SceneData).  What the kernels cannot render yet
    (NEE, Russian roulette) they refuse when called."""
    from parallelraytracing_tpu_torch.convert import tables_from_numpy
    from parallelraytracing_tpu_torch.ops.pack import pack_scene_tables, scene_bbox
    scene_data = scene.build(device)
    host = scene_data.numpy()
    tables = tables_from_numpy(*pack_scene_tables(host), host["sky"], device,
                               bb=scene_bbox(host))
    return tables, scene_data


def trace_tables(t: SceneTables, o, d, pix, seed: int,
                 cfg: RenderConfig) -> torch.Tensor:
    """ops.trace.trace with every table and flag taken from `t`."""
    from parallelraytracing_tpu_torch.ops.trace import trace
    return trace(o, d, pix, seed, t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl,
                 t.tri_cl, t.mats, max_depth=cfg.max_depth, t_min=cfg.t_min,
                 t_max=cfg.t_max, sky=t.sky, tri_live=t.tri_live,
                 rr_depth=cfg.russian_roulette_depth, nee=cfg.nee)
