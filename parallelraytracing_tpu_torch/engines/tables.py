"""Scene tables for the fused engine.

The counterpart of ``parallelraytracing_tpu/engines/tables.py``: the
packed per-kind tables, acceleration tables, material table, light
table and, for a scene with instances, the four instance tables of
ops/pack.py as float32 tensors on one device, plus the host-side facts
the trace needs (the sky spec, whether any triangle can be hit, whether
NEE runs, each instance's triangle run, the checker and image-texture
materials with the packed texel rows), and a mesh on the stream route's
mini-trees; beside the column tables, the kernels' copy of them as
16-byte records (``records``, ops/pack.scene_records), made once per
scene.  The TPU package's SMEM/VMEM placement planning and its hot/cold
table splits have no Hopper analogue: every table is plain read-only
device memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from parallelraytracing_tpu_torch.config import RenderConfig
from parallelraytracing_tpu_torch.ops import pack
from parallelraytracing_tpu_torch.ops.pack import SceneRecords, StreamTables
from parallelraytracing_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class InstanceTables:
    """The instance block's tables (ops/pack.pack_instance_tables) on one
    device, and the host facts the plain versions need."""
    itri: torch.Tensor     # (25 or 31, Nt) unique meshes' local triangles
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
    tri: torch.Tensor      # (27, Nt), or (33, Nt) with texture coordinates
    sph_cl: torch.Tensor   # (8, M) tree or (6, n_cl + 1) linear
    quad_cl: torch.Tensor
    tri_cl: torch.Tensor
    mats: torch.Tensor     # (5, Nm)
    #: the sky spec: the constant sky (3 floats), or for ``Scene.set_sky``
    #: the 13-tuple (bottom(3), top(3), sun direction(3), sun color(3),
    #: sun power) of ``sky_spec``
    sky: Tuple
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
    #: checker materials ((material id, cell scale, odd r, g, b), ...)
    checker: Tuple = ()
    #: image-textured materials ((material id, first row, height, width),
    #: ...) of ``pack_kernel_textures``, and its (Rt, 128) texel rows
    itex: Tuple = ()
    itex_tab: Optional[torch.Tensor] = None
    #: a mesh on the stream route (ops/pack.py): its mini-trees (a tensor)
    #: and integers; `tri` then holds its slots and `tri_cl` its top tree.
    #: None on the dense route
    stream: Optional[StreamTables] = None
    #: the kernels' copy of every table the kernels read, as 16-byte
    #: records (``with_records``); None until made
    records: Optional[SceneRecords] = None


def with_records(t: SceneTables) -> SceneTables:
    """`t` with the records of its tables (ops/pack.scene_records), on
    the tables' device."""
    return dataclasses.replace(t, records=pack.scene_records(
        t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl, t.tri_cl, t.mats,
        lights=t.lights, inst=t.inst, stream=t.stream))


def sky_spec(host: dict) -> tuple:
    """The sky spec of a scene's arrays (the JAX package's ``_sky_spec``):
    its constant sky as 3 floats, or with a gradient top or a sun the
    13-tuple (bottom(3), top(3), sun direction(3), sun color(3), power)
    with the top defaulting to the bottom and an absent sun as direction
    (0, 1, 0), color 0, power 1."""
    bot = tuple(float(x) for x in np.asarray(host["sky"]))
    top, sun = host.get("sky_top"), host.get("sun")
    if top is None and sun is None:
        return bot
    top = bot if top is None else tuple(float(x) for x in np.asarray(top))
    if sun is None:
        sd, sc, p = (0.0, 1.0, 0.0), (0.0, 0.0, 0.0), 1
    else:
        sun = np.asarray(sun)
        sd = tuple(float(x) for x in sun[0:3])
        sc = tuple(float(x) for x in sun[3:6])
        p = int(sun[6])
    return bot + top + sd + sc + (p,)


def checker_spec(scene) -> tuple:
    """((material id, cell scale, odd r, g, b), ...) of a Scene's checker
    materials, from its host parameters (the JAX engine tables'
    ``checker``)."""
    from parallelraytracing_tpu_torch.ops.textures import TEX_CHECKER
    return tuple((float(i), *(float(x) for x in pr))
                 for i, (tx, pr) in enumerate(zip(scene._mat_tex,
                                                  scene._mat_tex_param))
                 if tx == TEX_CHECKER)


def build_scene_tables(scene, device, nee: bool = False):
    """Pack a Scene for the trace and segment kernels on `device`.

    Returns (SceneTables, SceneData).  `nee` is the config's request: the
    tables run NEE only when the scene has a light, as in the JAX
    package, so a scene without one renders without it.  A scene with
    instances packs its unbaked base scene (SceneData without the
    instanced triangles) and the instance tables, whose ordinals start
    after every column of the flat kinds; lights come from the base scene
    (instanced meshes are not emitters NEE samples).  A scene with an
    image texture packs its texel rows and texture coordinates (the
    triangle table's rows 27-32, the instanced triangles' 25-30); images
    above ``ops/pack.KTEX_MAX`` texels on a side raise
    NotImplementedError.  A scene of more than ``ops/pack.STREAM_THRESHOLD``
    triangles takes the stream route in chunks of ``STREAM_CHUNK`` slots
    (``ops/pack.pack_scene_tables``); instanced meshes stay dense, as in
    the JAX package.  The tables carry their records (``with_records``),
    made here once for the scene.  The span ``prt.build_tables`` holds
    the whole of it (``prt.pack_stream`` inside, on the stream route)."""
    from parallelraytracing_tpu_torch.convert import tables_from_numpy
    from parallelraytracing_tpu_torch.ops.nee import extract_lights
    from parallelraytracing_tpu_torch.ops.pack import (pack_instance_tables,
                                                       pack_kernel_textures,
                                                       pack_lights_table,
                                                       pack_scene_tables,
                                                       scene_bbox)
    from parallelraytracing_tpu_torch.ops.textures import TEX_IMAGE_BASE
    has_img = any(t >= TEX_IMAGE_BASE for t in scene._mat_tex)
    inst = None
    with annotate("prt.build_tables"):
        if scene.instances:
            scene_data = scene.build(device, bake_instances=False)
            host = scene_data.numpy()
            ord_base = float(host["sph_valid"].shape[0]
                             + host["quad_valid"].shape[0]
                             + host["tri_valid"].shape[0])
            inst = pack_instance_tables(scene._inst_meshes, scene.instances,
                                        ord_base, with_uv=has_img)
        else:
            scene_data = scene.build(device)
            host = scene_data.numpy()
        itex, itex_rows = pack_kernel_textures(host) if has_img else ((), None)
        packed = pack_scene_tables(host)
        tables = tables_from_numpy(
            *packed, sky_spec(host), device,
            bb=scene_bbox(host, None if inst is None else inst[2]),
            lights=pack_lights_table(host),
            nee=nee and extract_lights(host) is not None, inst=inst,
            checker=checker_spec(scene), itex=itex, itex_tab=itex_rows,
            stream=packed.stream)
        return with_records(tables), scene_data


def stream_counters(t: SceneTables) -> Optional[dict]:
    """The stream route's table sizes (None on the dense route): the
    triangles (slots with a non-zero geometric normal), chunks, slots,
    top-tree nodes, mini-tree columns, and the bytes of the slot, top-tree
    and mini-tree tables as the columns hold them."""
    s = t.stream
    if s is None:
        return None
    tabs = (t.tri, t.tri_cl, s.mini)
    return {"triangles": int(t.tri[0:3].ne(0).any(0).sum()),
            "chunks": int(t.tri.shape[1]) // s.chunk,
            "slots": int(t.tri.shape[1]),
            "top_nodes": int(t.tri_cl.shape[1]),
            "mini_columns": int(s.mini.shape[1]),
            "table_bytes": sum(a.numel() * a.element_size() for a in tabs)}


def trace_tables(t: SceneTables, o, d, pix, seed: int, cfg: RenderConfig,
                 depth_out: bool = False, collect_stats: bool = False):
    """ops.trace.trace with every table and flag taken from `t`; the
    probes as ``trace`` returns them."""
    from parallelraytracing_tpu_torch.ops.trace import trace
    with annotate("prt.trace"):
        return trace(o, d, pix, seed, t.sph, t.quad, t.tri, t.sph_cl,
                     t.quad_cl, t.tri_cl, t.mats, max_depth=cfg.max_depth,
                     t_min=cfg.t_min, t_max=cfg.t_max, sky=t.sky,
                     tri_live=t.tri_live, rr_depth=cfg.russian_roulette_depth,
                     nee=t.nee, lights=t.lights, inst=t.inst,
                     checker=t.checker, itex=t.itex, itex_tab=t.itex_tab,
                     stream=t.stream, depth_out=depth_out,
                     collect_stats=collect_stats, records=t.records)


def trace_launch(t: SceneTables, cfg: RenderConfig,
                 kernel: str = "trace") -> dict:
    """The launch of persistent kernel `kernel` ("trace" or "segment") for
    tables `t` (on a CUDA device) under `cfg`: its instantiation
    ("variant", csrc/bounce.cuh kernel_variant, the same index in both
    libraries) and what that runs with (ops/_build.launch_config: the
    persistent grid, threads a block, registers, local and shared
    memory)."""
    from parallelraytracing_tpu_torch.ops import _build
    from parallelraytracing_tpu_torch.ops.trace import (scene_arg,
                                                        stream_of,
                                                        trace_variant)
    device = t.sph.device
    scene = scene_arg(device, t.sph, t.quad, t.tri, t.sph_cl,
                      t.quad_cl, t.tri_cl, t.mats, t_min=cfg.t_min,
                      t_max=cfg.t_max, sky=t.sky, tri_live=t.tri_live,
                      rr_depth=cfg.russian_roulette_depth, nee=t.nee,
                      lights=t.lights, inst=t.inst, checker=t.checker,
                      itex=t.itex, itex_tab=t.itex_tab, stream=t.stream,
                      records=t.records)
    variant = trace_variant(scene)
    return dict(variant=variant, **_build.launch_config(
        kernel, stream_of(device)[0], variant))
