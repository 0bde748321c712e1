"""State carried across from the JAX package.

The port's counterpart of weights: a scene's flat arrays and its packed
trace tables.  Both come in as numpy arrays (``np.asarray`` of the JAX
package's arrays), so this module imports nothing of JAX, and the tests
can run the JAX package's own tables through the port's trace — which
holds the kernel to the reference independently of the port's packer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parallelraytracing_tpu_torch.core.scene import SceneData
from parallelraytracing_tpu_torch.ops.pack import (LIGHT_ROWS, InstanceTables,
                                                   SceneTables, StreamTables,
                                                   check_instance_layout,
                                                   check_sky, instance_ranges)


def stream_from_blocks(blocks, n_attr: int, chunk: int, pack: int,
                       node_rows: int):
    """The JAX package's streamed triangle blocks as the port's stream
    tables: (slots (n_attr, n_chunks * chunk), StreamTables).

    `blocks` is its (n_chunks * block, 128) table, block = chunk / pack +
    node_rows rows per chunk, and chunk, pack, node_rows are its
    ``pack_scene_tables``' last three outputs (tri_stream, tri_pack,
    tri_snode); n_attr is the triangle table's rows (27, or 33 with
    texture coordinates).  Slot s of chunk c lies in row c * block +
    s / pack at lanes [(s % pack) * 128 / pack, + n_attr); the chunk's
    mini-tree in rows c * block + chunk / pack + k, lanes 0-7."""
    blocks = np.asarray(blocks, np.float32)
    lanes = blocks.shape[1]
    rows = chunk // pack
    block = rows + node_rows
    n_chunks = blocks.shape[0] // block
    if blocks.shape[0] != n_chunks * block or n_attr > lanes // pack:
        raise ValueError(f"blocks {blocks.shape}: want whole blocks of "
                         f"{block} rows with {n_attr} of {lanes // pack} "
                         f"lanes a slot")
    b = blocks.reshape(n_chunks, block, lanes)
    slots = b[:, :rows].reshape(n_chunks, rows, pack, lanes // pack)
    slots = slots[..., :n_attr].reshape(n_chunks * chunk, n_attr).T
    mini = b[:, rows:, :8].reshape(n_chunks * node_rows, 8).T
    return (np.ascontiguousarray(slots),
            StreamTables(mini=np.ascontiguousarray(mini), chunk=int(chunk),
                         node_rows=int(node_rows)))


def scene_data_from_numpy(arrays: dict, device) -> SceneData:
    """SceneData on `device` from the JAX package's SceneData fields as
    numpy, keyed by field name (e.g. ``{f: np.asarray(getattr(sd, f))}``);
    an extension field that is absent or None stays None."""
    return SceneData(**{
        f.name: (None if arrays.get(f.name) is None
                 else torch.from_numpy(np.array(arrays[f.name])).to(device))
        for f in dataclasses.fields(SceneData)})


def tables_from_numpy(sph, quad, tri, sph_cl, quad_cl, tri_cl, mats, sky,
                      device, bb=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
                      lights=None, nee: bool = False, inst=None,
                      checker=(), itex=(), itex_tab=None,
                      stream=None) -> SceneTables:
    """SceneTables on `device` from packed host tables (either package's
    ``pack_scene_tables``), the sky spec (3 floats, or the 13-tuple of
    ``engines/tables.sky_spec``) and the scene box ``bb`` =
    ((lo), (1 / extent)) of the sort key (the JAX engine tables' ``bb``;
    it only orders the wavefront queue, never changes an image).
    `lights` is either package's ``pack_lights_table`` (default: the
    (28, 1) zero table of a scene without lights) and `nee` whether the
    trace samples it: pass True only for a table of real lights (the JAX
    engine tables' ``nee``).  `inst` is either package's
    ``pack_instance_tables`` output (itri, iacc, ibox, inst), or None for
    a scene without instances; take the JAX package's unsplit (25, Nt)
    itri from ``pack_instance_tables``, not the engine tables' ``inst[0]``,
    which may be only the 16-row hot half of a hot/cold split.
    ``checker`` and ``itex`` are the engine tables' material specs and
    ``itex_tab`` the texel rows of ``pack_kernel_textures`` (None without
    image textures).  ``stream`` is the StreamTables of a mesh on the
    stream route (``pack_scene_tables(...).stream``, or the second value
    of ``stream_from_blocks``, whose slots are then `tri`), else None.
    Making the SceneTables validates the tables and makes their records:
    a table the kernels cannot read raises ValueError (NotImplementedError
    for a layout left out)."""
    def dev(a):
        return torch.from_numpy(
            np.array(a, dtype=np.float32, order="C")).to(device)

    tri = np.asarray(tri, np.float32)
    if lights is None:
        if nee:
            raise ValueError("nee needs the light table")
        lights = np.zeros((LIGHT_ROWS, 1), np.float32)
    if inst is not None:
        itri, iacc, ibox, irec = (np.asarray(a, np.float32) for a in inst)
        check_instance_layout(itri.shape[0], iacc.shape[0])
        inst = InstanceTables(itri=dev(itri), iacc=dev(iacc), ibox=dev(ibox),
                              inst=dev(irec),
                              ranges=instance_ranges(iacc, irec))
    return SceneTables(
        sph=dev(sph), quad=dev(quad), tri=dev(tri), sph_cl=dev(sph_cl),
        quad_cl=dev(quad_cl), tri_cl=dev(tri_cl), mats=dev(mats),
        sky=_sky(sky), tri_live=bool(np.any(tri[0:3] != 0.0)),
        lights=dev(lights), nee=bool(nee),
        bb=tuple(tuple(float(x) for x in v) for v in bb), inst=inst,
        checker=tuple(tuple(float(x) for x in c) for c in checker),
        itex=tuple((float(m), int(o), int(h), int(w)) for m, o, h, w in itex),
        itex_tab=None if itex_tab is None else dev(itex_tab),
        stream=(None if stream is None
                else dataclasses.replace(stream, mini=dev(stream.mini))))


def _sky(sky) -> tuple:
    """A sky spec with its colors rounded to float32; the sun power of a
    13-value spec stays an integer."""
    return check_sky(tuple(float(np.float32(s)) for s in sky[:12])
                      + tuple(sky[12:]))
