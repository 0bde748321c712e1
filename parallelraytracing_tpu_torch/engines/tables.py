"""Scene tables for the fused engines.

The counterpart of ``parallelraytracing_tpu/engines/tables.py``:
``build_scene_tables`` packs a Scene into the table set the trace and
segment kernels read (``ops/pack.SceneTables``, made by
``convert.tables_from_numpy``, validated then and carrying its records),
with the host facts of the scene (its sky spec, checker materials);
``trace_launch`` says which kernel instantiation a table set runs and
with what; ``stream_counters`` gives the stream route's sizes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from parallelraytracing_tpu_torch.config import RenderConfig
from parallelraytracing_tpu_torch.convert import tables_from_numpy
from parallelraytracing_tpu_torch.ops.nee import extract_lights
from parallelraytracing_tpu_torch.ops.pack import (SceneTables,
                                                   pack_instance_tables,
                                                   pack_kernel_textures,
                                                   pack_lights_table,
                                                   pack_scene_tables,
                                                   scene_bbox)
from parallelraytracing_tpu_torch.ops.textures import TEX_CHECKER, TEX_IMAGE_BASE
from parallelraytracing_tpu_torch.utils.profiling import annotate


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
    the JAX package.  The tables carry their records, made here once for
    the scene.  The span ``prt.build_tables`` holds the whole of it
    (``prt.pack_stream`` inside, on the stream route)."""
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
        return tables, scene_data


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


def trace_launch(t: SceneTables, cfg: RenderConfig,
                 kernel: str = "trace") -> dict:
    """The launch of persistent kernel `kernel` ("trace" or "segment") for
    tables `t` (on a CUDA device) under `cfg`: its instantiation
    ("variant", csrc/bounce.cuh kernel_variant, the same index in both
    libraries) and what that runs with (ops/_build.launch_config: the
    persistent grid, threads a block, registers, local and shared
    memory)."""
    from parallelraytracing_tpu_torch.ops import _build
    from parallelraytracing_tpu_torch.ops.trace import (scene_struct,
                                                        stream_of,
                                                        trace_variant)
    variant = trace_variant(scene_struct(t, cfg))
    return dict(variant=variant, **_build.launch_config(
        kernel, stream_of(t.sph.device)[0], variant))
