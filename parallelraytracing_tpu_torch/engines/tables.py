"""Scene tables for the fused engine.

The counterpart of ``parallelraytracing_tpu/engines/tables.py``: the
packed per-kind tables, acceleration tables, material table, light
table and, for a scene with instances, the four instance tables of
ops/pack.py as float32 tensors on one device, plus the host-side facts
the trace needs (the constant sky, whether any triangle can be hit,
whether NEE runs, each instance's triangle run).  The TPU package's
SMEM/VMEM placement planning and its hot/cold table splits have no
Hopper analogue: every table is plain read-only device memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from parallelraytracing_tpu_torch.config import RenderConfig


@dataclasses.dataclass(frozen=True)
class InstanceTables:
    """The instance block's tables (ops/pack.pack_instance_tables) on one
    device, and the host facts the plain versions need."""
    itri: torch.Tensor     # (25, Nt) unique meshes' local triangles
    iacc: torch.Tensor     # (8, Mb) their concatenated threaded trees
    ibox: torch.Tensor     # (6, Ni) instance world boxes
    inst: torch.Tensor     # (24, Ni) instance records
    #: each instance's run of itri columns, ((lo, hi), ...)
    #: (ops/pack.instance_ranges): the plain versions test an instance
    #: against its own mesh's triangles only
    ranges: Tuple[Tuple[int, int], ...]

    @property
    def n_inst(self) -> int:
        return int(self.inst.shape[1])


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
    lights: torch.Tensor   # (28, Nl), a (28, 1) zero table without lights
    #: NEE runs: the config asks for it and the scene has a light
    nee: bool
    #: the scene box as ((lo xyz), (1 / extent xyz)): the frame of
    #: wavefront_fused's origin-Morton sort key (ops/pack.scene_bbox)
    bb: Tuple[Tuple[float, float, float], Tuple[float, float, float]]
    #: the instance tables; None for a scene without instances
    inst: Optional[InstanceTables] = None


def build_scene_tables(scene, device, nee: bool = False):
    """Pack a Scene for the trace and segment kernels on `device`.

    Returns (SceneTables, SceneData).  `nee` is the config's request: the
    tables run NEE only when the scene has a light, as in the JAX
    package, so a scene without one renders without it.  A scene with
    instances packs its unbaked base scene (SceneData without the
    instanced triangles) and the instance tables, whose ordinals start
    after every column of the flat kinds; lights come from the base scene
    (instanced meshes are not emitters NEE samples)."""
    from parallelraytracing_tpu_torch.convert import tables_from_numpy
    from parallelraytracing_tpu_torch.ops.nee import extract_lights
    from parallelraytracing_tpu_torch.ops.pack import (pack_instance_tables,
                                                       pack_lights_table,
                                                       pack_scene_tables,
                                                       scene_bbox)
    inst = None
    if scene.instances:
        scene_data = scene.build(device, bake_instances=False)
        host = scene_data.numpy()
        ord_base = float(host["sph_valid"].shape[0]
                         + host["quad_valid"].shape[0]
                         + host["tri_valid"].shape[0])
        inst = pack_instance_tables(scene._inst_meshes, scene.instances,
                                    ord_base)
    else:
        scene_data = scene.build(device)
        host = scene_data.numpy()
    tables = tables_from_numpy(
        *pack_scene_tables(host), host["sky"], device,
        bb=scene_bbox(host, None if inst is None else inst[2]),
        lights=pack_lights_table(host),
        nee=nee and extract_lights(host) is not None, inst=inst)
    return tables, scene_data


def trace_tables(t: SceneTables, o, d, pix, seed: int,
                 cfg: RenderConfig) -> torch.Tensor:
    """ops.trace.trace with every table and flag taken from `t`."""
    from parallelraytracing_tpu_torch.ops.trace import trace
    return trace(o, d, pix, seed, t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl,
                 t.tri_cl, t.mats, max_depth=cfg.max_depth, t_min=cfg.t_min,
                 t_max=cfg.t_max, sky=t.sky, tri_live=t.tri_live,
                 rr_depth=cfg.russian_roulette_depth, nee=t.nee,
                 lights=t.lights, inst=t.inst)
