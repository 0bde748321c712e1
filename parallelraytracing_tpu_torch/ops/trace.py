"""The fused trace: every bounce of every ray in one kernel launch.

The counterpart of ``pallas_trace`` (``parallelraytracing_tpu/ops/pallas_trace.py``)
on sphere, quad, triangle and instanced-mesh scenes, with next-event
estimation (NEE), Russian roulette and the scene extensions: checker and
image textures and the directional sky.  Two functions of one signature:

- ``trace``: the wrapper.  On a CUDA tensor it launches the hand-written
  kernel ``csrc/trace.cu`` (built at first use, ops/_build.py) or raises;
  on a CPU tensor it runs ``trace_reference``.  ``trace.launches`` counts
  kernel launches.  The kernel is persistent: ``trace_config`` says with
  which grid, block and resources each instantiation runs.
- ``trace_reference``: the plain PyTorch version, vectorised over rays.
  Its closest hit is a brute-force fold over every sphere, quad and
  triangle column, and over each instance's own mesh triangles behind
  the instance's world-box test (an independent check of the kernel's
  tree walks);
  everything after the fold follows the order of operations of
  ``_make_bounce_step``.  Its NEE shadow test is the closest-hit
  formulation (the light is visible iff the brute-force closest hit along
  the shadow ray is the light itself, the JAX package's
  ``PRT_NEE_ANYHIT=0``), an independent check of the kernel's any-hit
  walk.  ``_bounce`` is shared with the segment kernel's plain version
  (ops/segment.py).

Rays: o, d (R, 3) float32; pix (R,) int32 pixel ids keying the PCG
streams; seed the frame's int32 path seed.  Tables: the (C, N) float32
tables of ops/pack.py (or of the JAX package, via convert.py); ``sky``
the constant sky (3 floats) or the 13-tuple of
``engines/tables.sky_spec`` (gradient and sun); ``checker`` the checker
materials ((material id, cell scale, odd r, g, b), ...) and ``itex`` the
image-textured ones ((material id, first row, height, width), ...) of
``pack_kernel_textures``, whose (Rt, 128) texel rows are ``itex_tab``
(the triangle tables then carry texture coordinates: tri 33 rows, itri
31); with
``nee`` the (28, Nl) light table of ``pack_lights_table`` too, whose
every column is sampled (as in ``pallas_trace``, which takes
``lights.shape[1]`` lights: pass ``nee`` only for a scene with lights,
as engines/tables.py does).  ``rr_depth`` > 0 plays Russian roulette
from that absolute depth on.  ``inst`` is the scene's
``engines/tables.InstanceTables`` (the four tables of
``pack_instance_tables`` and each instance's triangle run), or None.
``records`` is the ``ops/pack.SceneRecords`` of those tables, the copy
the kernels read (``SceneTables.records``, made once per scene); without
it the wrapper makes them at each call (``ops/pack.scene_records``: one
stack of row views a table on the device, ~15 small launches, no host
sync; the plain version reads the columns and ignores them).  Returns
(R, 3) float32 radiance.

A triangle kind of never-hit pad columns (``tri_live`` False) is skipped.
``stream`` is the ``ops/pack.StreamTables`` of a mesh on the stream route
(then ``tri`` holds its chunks' slots and ``tri_cl`` its top tree), or
None: the kernel walks the top tree to a chunk and the chunk's mini-tree
to its slots (the stream instantiations of csrc/bounce.cuh), while the
plain version's brute-force fold over every slot column, pad slots never
hit, gives the dense answer, which holds the two-level walk to missing
nothing.

The probes, as ``pallas_trace`` has them: ``depth_out`` adds each ray's
depth, the bounces it entered alive, (R,) float32; ``collect_stats`` adds
its walk counters [nodes, leaves entered, primitives tested, alive
bounces], (R, 4) int32, with the rules of ``WalkCount`` in
csrc/bounce.cuh.  The JAX kernel's counters are (n_tiles, 8) per lockstep
(rows, 128) tile; SIMT walks one ray per thread and has no tile, so the
port's are per ray (a tile of identical rays is one ray's walk).  With
either probe, ``trace`` launches the probe kernel (csrc/probe.cu, counted
on ``trace.probe_launches``) and returns ``(rad, depth)``, ``(rad,
stats)`` or ``(rad, depth, stats)``; the radiance is the trace kernel's
bit for bit.  ``trace_reference`` counts its depth in its own loop and
its counters by replaying the kernel's walks over the ray states it
records (ops/walk_stats.py), while its radiance stays the brute-force
fold.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from parallelraytracing_tpu_torch.core.scene import (MAT_DIELECTRIC, MAT_EMISSIVE,
                                                  MAT_LAMBERTIAN, MAT_METAL)
from parallelraytracing_tpu_torch.ops import ieee, rng
from parallelraytracing_tpu_torch.ops.pack import (CLUSTER, IACC_ROWS, IBOX_ROWS,
                                                   INST_ROWS, ITRI_ROWS,
                                                   ITRI_UV_ROWS, KTEX_MAX,
                                                   LIGHT_ROWS, RECORD_KINDS,
                                                   TEX_LANES, TREE_ROWS,
                                                   TRI_CLUSTER, TRI_ROWS,
                                                   TRI_UV_ROWS,
                                                   check_instance_layout,
                                                   record_columns,
                                                   record_rows, scene_records)
from parallelraytracing_tpu_torch.ops.textures import CHECKER_OFFSET

BIG = 3.0e38
TWO_PI = 2.0 * math.pi
#: t_max at or above this is the "infinite" horizon: no upper-bound test
T_MAX_INF = 1e30
#: rays x primitives per chunk of the plain version's brute-force fold
CHUNK_ELEMS = 1 << 23
#: float32 constants of the sphere's equirectangular map and the checker
#: (the JAX kernel's float32 roundings of the same float64 values)
INV_TWO_PI = float(np.float32(1.0 / (2.0 * math.pi)))
INV_PI = float(np.float32(1.0 / math.pi))
CHECKER_OFF = float(np.float32(CHECKER_OFFSET))
INV_255 = float(np.float32(1.0 / 255.0))
#: rows of the per-material texture table the kernels read
#: (``texture_table``)
MTEX_ROWS = 6

def _check_sky(sky) -> tuple:
    """The sky spec as Python numbers: 3 colors, or the 13-tuple of
    ``engines/tables.sky_spec`` whose last entry is the sun's integer
    power."""
    if len(sky) == 3:
        return tuple(float(s) for s in sky)
    if len(sky) == 13 and int(sky[12]) == sky[12] and int(sky[12]) >= 0:
        return tuple(float(s) for s in sky[:12]) + (int(sky[12]),)
    raise ValueError(f"sky spec of {len(sky)} values: want the constant sky "
                     f"(3) or the gradient and sun spec (13, integer power)")


def _t_cap(t_max: float) -> float:
    return math.inf if t_max >= T_MAX_INF else float(t_max)


def trace(o, d, pix, seed: int, sph, quad, tri, sph_cl, quad_cl, tri_cl,
          mats, *, max_depth: int, t_min: float, t_max: float, sky,
          tri_live: bool, rr_depth: int = 0, nee: bool = False,
          lights=None, inst=None, checker=(), itex=(), itex_tab=None,
          stream=None, depth_out: bool = False,
          collect_stats: bool = False, records=None):
    """Trace R rays through up to `max_depth` bounces; (R, 3) radiance,
    with the probes asked for after it (the module's note).

    `tri_live` says whether the triangle table holds any hittable column
    (engines/tables.py and convert.py compute it on the host)."""
    if o.device.type == "cpu":
        return trace_reference(o, d, pix, seed, sph, quad, tri, sph_cl,
                               quad_cl, tri_cl, mats, max_depth=max_depth,
                               t_min=t_min, t_max=t_max, sky=sky,
                               tri_live=tri_live, rr_depth=rr_depth, nee=nee,
                               lights=lights, inst=inst, checker=checker,
                               itex=itex, itex_tab=itex_tab, stream=stream,
                               depth_out=depth_out,
                               collect_stats=collect_stats)
    if o.device.type != "cuda":
        raise ValueError(f"trace runs on cpu or cuda tensors, not {o.device}")
    r = int(o.shape[0])
    if o.shape != (r, 3) or d.shape != (r, 3):
        raise ValueError(f"rays: o {tuple(o.shape)}, d {tuple(d.shape)}; "
                         f"want (R,3), (R,3)")
    check_tensors(o.device, {"o": o, "d": d}, {"pix": (pix, (r,))})
    scene = scene_arg(o.device, sph, quad, tri, sph_cl, quad_cl, tri_cl,
                      mats, t_min=t_min, t_max=t_max, sky=sky,
                      tri_live=tri_live, rr_depth=rr_depth, nee=nee,
                      lights=lights, inst=inst, checker=checker, itex=itex,
                      itex_tab=itex_tab, stream=stream, records=records)

    from parallelraytracing_tpu_torch.ops import _build
    out = torch.empty((r, 3), dtype=torch.float32, device=o.device)
    ptr = torch.Tensor.data_ptr
    if not (depth_out or collect_stats):
        # the persistent grid's ray counter, 0 at the launch
        nxt = torch.zeros((1,), dtype=torch.int32, device=o.device)
        err = _build.load("trace")(
            *stream_of(o.device), ctypes.byref(scene), ptr(o), ptr(d),
            ptr(pix), ptr(out), ptr(nxt), r, int(seed) & rng.MASK32,
            int(max_depth))
        if err != 0:
            raise RuntimeError(f"trace kernel launch failed: cudaError_t {err}")
        trace.launches += 1
        return out
    depth = torch.empty((r,), dtype=torch.float32, device=o.device)
    stats = torch.empty((r, 4), dtype=torch.int32, device=o.device)
    err = _build.load("probe")(
        *stream_of(o.device), ctypes.byref(scene), ptr(o), ptr(d), ptr(pix),
        ptr(out), ptr(depth), ptr(stats), r, int(seed) & rng.MASK32,
        int(max_depth))
    if err != 0:
        raise RuntimeError(f"probe kernel launch failed: cudaError_t {err}")
    trace.probe_launches += 1
    return _with_probes(out, depth, stats, depth_out, collect_stats)


trace.launches = 0
trace.probe_launches = 0

#: the fields of ``trace_config``, in csrc/trace.cu prt_trace_info's order
TRACE_INFO = ("grid", "threads", "blocks_per_sm", "registers",
              "local_bytes", "static_smem", "dynamic_smem", "sms")


def trace_variant(scene) -> int:
    """The instantiation a launch picks for a ``scene_arg`` struct
    (csrc/bounce.cuh kernel_variant)."""
    from parallelraytracing_tpu_torch.ops import _build
    lib = _build.load("trace").library
    lib.prt_trace_variant.argtypes = [_build.SCENE]
    lib.prt_trace_variant.restype = ctypes.c_int
    return int(lib.prt_trace_variant(ctypes.byref(scene)))


def trace_config(device, variant: int) -> dict:
    """What the trace kernel's instantiation `variant` runs with on CUDA
    `device` (the fields of TRACE_INFO): its persistent grid in blocks,
    threads a block, resident blocks per SM, registers and local memory a
    thread (bytes), static and dynamic shared memory a block (bytes), and
    the device's SMs."""
    from parallelraytracing_tpu_torch.ops import _build
    lib = _build.load("trace").library
    lib.prt_trace_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.prt_trace_info.restype = ctypes.c_int
    info = (ctypes.c_int * len(TRACE_INFO))()
    index = stream_of(torch.device(device))[0]
    err = lib.prt_trace_info(index, int(variant), info)
    if err != 0:
        raise RuntimeError(f"trace kernel query failed: cudaError_t {err}")
    return dict(zip(TRACE_INFO, info))


def _with_probes(rad, depth, stats, depth_out: bool, collect_stats: bool):
    """The trace's result in ``pallas_trace``'s order: rad, (rad, depth),
    (rad, stats) or (rad, depth, stats)."""
    if not (depth_out or collect_stats):
        return rad
    return ((rad,) + ((depth,) if depth_out else ())
            + ((stats,) if collect_stats else ()))


def stream_of(device) -> tuple:
    """(device index, PyTorch's current stream) for a kernel launch."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def check_tensors(device, floats: dict, ints: dict) -> None:
    """Validate what a kernel reads: float32 `floats` and int32 `ints`
    ({name: (tensor, shape)}), all contiguous and on `device`."""
    for name, (t, shape) in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}: want {shape}")
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in {**floats, **{k: v[0] for k, v in ints.items()}}.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, rays on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _light_table(nee: bool, lights):
    """The light table NEE samples, or None with NEE off."""
    if not nee:
        return None
    if lights is None or lights.dim() != 2 or lights.shape[0] != LIGHT_ROWS:
        raise ValueError("nee needs the (28, Nl) light table of "
                         "pack_lights_table as `lights`")
    return lights


def _instance_tables(device, inst):
    """Validate the instance tables a kernel reads: their widths for
    ``PrtScene``, all 0 without instances."""
    if inst is None:
        return (0,) * 3
    check_instance_layout(inst.itri.shape[0], inst.iacc.shape[0])
    tabs = {"itri": inst.itri, "iacc": inst.iacc, "ibox": inst.ibox,
            "inst": inst.inst}
    check_tensors(device, tabs, {})
    n_inst = inst.inst.shape[1]
    if (inst.itri.dim() != 2 or inst.iacc.dim() != 2 or n_inst < 1
            or tuple(inst.ibox.shape) != (IBOX_ROWS, n_inst)
            or inst.inst.shape[0] != INST_ROWS or len(inst.ranges) != n_inst):
        raise ValueError(
            f"instance tables: want itri ({ITRI_ROWS}, Nt), iacc "
            f"({IACC_ROWS}, Mb), ibox ({IBOX_ROWS}, Ni), inst ({INST_ROWS}, "
            f"Ni) with Ni >= 1 and one triangle run per instance")
    return inst.itri.shape[1], inst.iacc.shape[1], n_inst


def _check_stream(tri, tri_cl, stream) -> None:
    """Validate a stream route's tables: the top tree (8, M), the mini-trees
    (8, n_chunks * node_rows) and the slots (C, n_chunks * chunk)."""
    if stream is None:
        return
    chunk, node_rows = int(stream.chunk), int(stream.node_rows)
    mini = stream.mini
    n_chunks = mini.shape[1] // node_rows if node_rows > 0 else 0
    if (chunk < 1 or node_rows < 1 or mini.dim() != 2
            or mini.shape[0] != TREE_ROWS or n_chunks < 1
            or mini.shape[1] != n_chunks * node_rows
            or tri.shape[1] != n_chunks * chunk
            or tri_cl.shape[0] != TREE_ROWS):
        raise ValueError(
            f"stream tables: want mini ({TREE_ROWS}, n_chunks x node_rows "
            f"{node_rows}), tri (C, n_chunks x chunk {chunk}) and an "
            f"({TREE_ROWS}, M) top tree; got mini {tuple(mini.shape)}, tri "
            f"{tuple(tri.shape)}, tri_cl {tuple(tri_cl.shape)}")


def _check_textures(checker, itex, itex_tab, tri, inst, n_mats: int) -> None:
    """Validate the texture specs against the tables: material ids in
    range, image textures within KTEX_MAX and within the texel rows, and
    texture coordinates in the triangle tables when an image is used."""
    for c in checker:
        if len(c) != 5 or not 0 <= int(c[0]) < n_mats:
            raise ValueError(f"checker entry {c}: want (material id < "
                             f"{n_mats}, scale, r, g, b)")
    if not itex:
        return
    if itex_tab is None or itex_tab.dim() != 2 \
            or itex_tab.shape[1] != TEX_LANES:
        raise ValueError(f"image textures need their (Rt, {TEX_LANES}) texel "
                         f"rows as itex_tab (ops/pack.pack_kernel_textures)")
    for mid, toff, th, tw in itex:
        rows = -(-int(th) * int(tw) // TEX_LANES)
        if (not 0 <= int(mid) < n_mats or not 0 < th <= KTEX_MAX
                or not 0 < tw <= KTEX_MAX or toff < 0
                or toff + rows > itex_tab.shape[0]):
            raise ValueError(f"itex entry {(mid, toff, th, tw)}: want a "
                             f"material id < {n_mats} and an image of at "
                             f"most {KTEX_MAX}x{KTEX_MAX} inside itex_tab "
                             f"({itex_tab.shape[0]} rows)")
    if tri.shape[0] != TRI_UV_ROWS or (
            inst is not None and inst.itri.shape[0] != ITRI_UV_ROWS):
        raise ValueError(f"image textures need texture coordinates: tri of "
                         f"{TRI_UV_ROWS} rows and itri of {ITRI_UV_ROWS}")


@functools.lru_cache(maxsize=32)
def texture_table(checker: tuple, itex: tuple, n_mats: int,
                  device: torch.device) -> torch.Tensor:
    """The per-material texture table the kernels read, (6, n_mats)
    float32 on `device` (cached: built once per scene and device).  Row 0
    is the kind (0 none, 1 checker, 2 image); a checker's rows 1-4 its
    cell scale and odd color; an image's rows 1-5 its first texel row,
    height, width, 1/height and 1/width (float32 of the float64
    quotients, the JAX kernel's constants).  A material has at most one
    texture, so one lookup by material id stands for the JAX kernel's
    unrolled loops over the checker and image lists."""
    lut = np.zeros((MTEX_ROWS, n_mats), np.float32)
    for mid, scale, r, g, b in checker:
        lut[:5, int(mid)] = (1.0, scale, r, g, b)
    for mid, toff, th, tw in itex:
        lut[:, int(mid)] = (2.0, toff, th, tw, 1.0 / th, 1.0 / tw)
    return torch.from_numpy(lut).to(device)


def sky_mode(sky: tuple) -> int:
    """How the kernels shade a miss: 0 the constant sky, 1 the gradient,
    2 the gradient and the sun (a sun of color 0 is left out, as the JAX
    kernel leaves it out)."""
    if len(sky) == 3:
        return 0
    return 2 if any(sky[9:12]) else 1


def _check_records(records, device, cols: dict) -> None:
    """Validate `records` (ops/pack.SceneRecords) against the column
    tables `cols` ({field: table or None}) they stand for: each a
    contiguous float32 tensor on `device` with one record a column."""
    for name, kind in RECORD_KINDS:
        col, rec = cols.get(name), getattr(records, name)
        if col is None:
            continue
        want = (int(col.shape[1]), len(record_rows(kind, int(col.shape[0]))))
        if rec is None or tuple(rec.shape) != want:
            raise ValueError(f"records.{name}: want {want} for its "
                             f"{tuple(col.shape)} table, got "
                             f"{None if rec is None else tuple(rec.shape)}")
        check_tensors(device, {f"records.{name}": rec}, {})


def scene_arg(device, sph, quad, tri, sph_cl, quad_cl, tri_cl, mats, *,
              t_min: float, t_max: float, sky, tri_live: bool,
              rr_depth: int = 0, nee: bool = False, lights=None, inst=None,
              checker=(), itex=(), itex_tab=None, stream=None, records=None):
    """Validate the tables a kernel reads and pack their records
    (`records`, or ``ops/pack.scene_records`` of the tables when it is
    None) into the ``PrtScene`` struct of csrc/bounce.cuh.  The struct
    holds raw device pointers: the records must outlive the launch; the
    struct keeps them as its ``records`` attribute."""
    from parallelraytracing_tpu_torch.ops import _build
    sky = _check_sky(sky)
    lights = _light_table(nee, lights)
    inst_arg = _instance_tables(device, inst)
    check_tensors(device, {"sph": sph, "quad": quad, "tri": tri,
                           "sph_cl": sph_cl, "quad_cl": quad_cl,
                           "tri_cl": tri_cl, "mats": mats,
                           **({} if lights is None else {"lights": lights}),
                           **({} if not itex else {"itex_tab": itex_tab}),
                           **({} if stream is None else {"mini": stream.mini})},
                  {})
    if (sph.shape[0] != 6 or quad.shape[0] != 14
            or tri.shape[0] not in (TRI_ROWS, TRI_UV_ROWS)
            or mats.shape[0] != 5):
        raise ValueError("tables: want sph (6,N), quad (14,N), tri (27,N) "
                         "or (33,N), mats (5,N)")
    _check_textures(checker, itex, itex_tab, tri, inst, int(mats.shape[1]))
    _check_stream(tri, tri_cl, stream)
    # Each kind's linear table has one column per run of its own cluster
    # size (TRI_CLUSTER for triangles) plus the root pretest column.
    for name, cl, n, csize in (("sph_cl", sph_cl, sph.shape[1], CLUSTER),
                               ("quad_cl", quad_cl, quad.shape[1], CLUSTER),
                               ("tri_cl", tri_cl, tri.shape[1], TRI_CLUSTER)):
        n_cl = max(1, -(-int(n) // csize))
        if not (cl.shape[0] == 8
                or (cl.shape[0] == 6 and cl.shape[1] == n_cl + 1)):
            raise ValueError(f"{name} {tuple(cl.shape)}: want an (8, M) "
                             f"tree or a (6, {n_cl + 1}) linear table")
    tabs = (sph, quad, tri, sph_cl, quad_cl, tri_cl, mats)
    cols = record_columns(*tabs, lights=lights, inst=inst, stream=stream)
    if records is None:
        records = scene_records(*tabs, lights=lights, inst=inst,
                                stream=stream)
    else:
        _check_records(records, device, cols)

    def rec(name):
        return None if cols.get(name) is None else getattr(records,
                                                           name).data_ptr()

    def width(name):  # float4s a record
        return 0 if cols.get(name) is None else getattr(records,
                                                        name).shape[1] // 4

    textured = bool(checker) or bool(itex)
    mtex = (texture_table(tuple(tuple(float(x) for x in c) for c in checker),
                          tuple((float(m), int(o), int(h), int(w))
                                for m, o, h, w in itex),
                          int(mats.shape[1]), device) if textured else None)
    scene = _build.PrtScene(
        rec("sph"), rec("sph_cl"), sph.shape[1], *sph_cl.shape,
        rec("quad"), rec("quad_cl"), quad.shape[1], *quad_cl.shape,
        rec("tri"), rec("tri_tail"), rec("tri_cl"),
        tri.shape[1] if tri_live else 0, *tri_cl.shape, width("tri_tail"),
        rec("mats"), mats.shape[1], CLUSTER, TRI_CLUSTER,
        float(t_min), _t_cap(t_max),
        (ctypes.c_float * 13)(*(sky + (0.0,) * 10)[:13]),
        sky_mode(sky), rec("lights"),
        0 if lights is None else lights.shape[1], max(int(rr_depth), 0),
        rec("itri"), rec("itri_tail"), rec("iacc"), rec("ibox"), rec("inst"),
        *inst_arg, width("itri_tail"),
        None if mtex is None else mtex.data_ptr(),
        itex_tab.data_ptr() if itex else None,
        *((None, 0, 0, 0, 0) if stream is None else
          (rec("mini"), stream.mini.shape[1], int(stream.chunk),
           int(stream.node_rows), stream.shift)))
    scene.records = records
    return scene


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _sphere_hits(ox, oy, oz, dx, dy, dz, sph, t_min, t_cap):
    """(B, Ns) hit distance, accept mask and front flag of every sphere."""
    cx, cy, cz, r2 = sph[0], sph[1], sph[2], sph[3]
    ocx = ox[:, None] - cx
    ocy = oy[:, None] - cy
    ocz = oz[:, None] - cz
    b2 = dx[:, None] * ocx + dy[:, None] * ocy + dz[:, None] * ocz
    cterm = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = b2 * b2 - cterm
    sq = ieee.sqrt(torch.clamp_min(disc, 0.0))
    t_near = -b2 - sq
    t_far = -b2 + sq
    fr = t_near >= t_min
    t = torch.where(fr, t_near, t_far)
    ok = (disc >= 0.0) & (t >= t_min) & (t <= t_cap)
    return t, ok, fr


def _quad_hits(ox, oy, oz, dx, dy, dz, quad, t_min, t_cap):
    """(B, Nq) hit distance, accept mask, front flag and half-extent
    coordinates a, b of every quad."""
    qnx, qny, qnz, cn = quad[0], quad[1], quad[2], quad[3]
    usx, usy, usz, cu = quad[4], quad[5], quad[6], quad[7]
    vsx, vsy, vsz, cv = quad[8], quad[9], quad[10], quad[11]
    ox, oy, oz = ox[:, None], oy[:, None], oz[:, None]
    dx, dy, dz = dx[:, None], dy[:, None], dz[:, None]
    dn = dx * qnx + dy * qny + dz * qnz
    on = ox * qnx + oy * qny + oz * qnz
    denom_ok = torch.abs(dn) >= 1e-8
    inv_dn = torch.where(denom_ok, 1.0 / torch.where(denom_ok, dn, 1.0), 0.0)
    t = (cn - on) * inv_dn
    a = (ox * usx + oy * usy + oz * usz) \
        + t * (dx * usx + dy * usy + dz * usz) - cu
    b = (ox * vsx + oy * vsy + oz * vsz) \
        + t * (dx * vsx + dy * vsy + dz * vsz) - cv
    ok = denom_ok & (t > t_min) & (a * a < 1.0) & (b * b < 1.0) & (t <= t_cap)
    fr = on - cn > 0.0
    return t, ok, fr, a, b


def _tri_hits(ox, oy, oz, dx, dy, dz, tri, t_min, t_cap):
    """(B, Nt) hit distance, accept mask and barycentrics b1, b2 of every
    triangle: the triple-product Moller-Trumbore of ``make_tri_body``."""
    ngx, ngy, ngz, p0ng = tri[0], tri[1], tri[2], tri[3]
    e1x, e1y, e1z = tri[4], tri[5], tri[6]
    e2x, e2y, e2z = tri[7], tri[8], tri[9]
    xpx, xpy, xpz = tri[10], tri[11], tri[12]   # e2 x p0
    pex, pey, pez = tri[13], tri[14], tri[15]   # p0 x e1
    wx = (oy * dz - oz * dy)[:, None]
    wy = (oz * dx - ox * dz)[:, None]
    wz = (ox * dy - oy * dx)[:, None]
    ox, oy, oz = ox[:, None], oy[:, None], oz[:, None]
    dx, dy, dz = dx[:, None], dy[:, None], dz[:, None]
    div = -(dx * ngx + dy * ngy + dz * ngz)
    div_ok = div != 0.0
    inv = torch.where(div_ok, 1.0 / torch.where(div_ok, div, 1.0), 0.0)
    t = (ox * ngx + oy * ngy + oz * ngz - p0ng) * inv
    b1 = ((wx * e2x + wy * e2y + wz * e2z)
          - (dx * xpx + dy * xpy + dz * xpz)) * inv
    b2 = (-(wx * e1x + wy * e1y + wz * e1z)
          - (dx * pex + dy * pey + dz * pez)) * inv
    ok = div_ok & (t >= t_min) & (b1 >= 0.0) & (b2 >= 0.0) \
        & (b1 + b2 <= 1.0) & (t <= t_cap)
    return t, ok, b1, b2


def _safe_inv(v):
    """1 / v with |v| clamped to >= 1e-20 (``safe_inv`` of bounce.cuh)."""
    eps = 1e-20
    return 1.0 / torch.where(torch.abs(v) < eps,
                             torch.where(v < 0, -eps, eps), v)


def _slab(box, k, ox, oy, oz, ix, iy, iz, t_min, best_t):
    """(B,) does each ray hit column k of a (6, N) box table at a t in
    [t_min, best_t]: ``slab_hit`` of bounce.cuh, the exact (b - o) * inv
    form."""
    tx0 = (box[0, k] - ox) * ix
    ty0 = (box[1, k] - oy) * iy
    tz0 = (box[2, k] - oz) * iz
    tx1 = (box[3, k] - ox) * ix
    ty1 = (box[4, k] - oy) * iy
    tz1 = (box[5, k] - oz) * iz
    tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                     torch.minimum(ty0, ty1)),
                       torch.clamp_min(torch.minimum(tz0, tz1), t_min))
    tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                     torch.maximum(ty0, ty1)),
                       torch.clamp_max(torch.maximum(tz0, tz1), best_t))
    return tf - tn >= 0.0


def _instance_hits(ox, oy, oz, dx, dy, dz, inst, t_min, t_cap):
    """Per instance k, the (B, n_k) hit distance, accept mask and
    barycentrics of the world rays against the instance's own mesh
    triangles (its run of itri columns), tested in mesh-local space with
    the instance's world->local affine (direction not renormalised, so
    local t is world t), and only for rays that pass the instance's
    world-box test (the kernel's gate, at [t_min, BIG])."""
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    parts = []
    for k, (lo, hi) in enumerate(inst.ranges):
        g = inst.inst[:, k]
        gate = _slab(inst.ibox, k, ox, oy, oz, ix, iy, iz, t_min, BIG)
        lox = g[1] * ox + g[2] * oy + g[3] * oz + g[4]
        loy = g[5] * ox + g[6] * oy + g[7] * oz + g[8]
        loz = g[9] * ox + g[10] * oy + g[11] * oz + g[12]
        ldx = g[1] * dx + g[2] * dy + g[3] * dz
        ldy = g[5] * dx + g[6] * dy + g[7] * dz
        ldz = g[9] * dx + g[10] * dy + g[11] * dz
        t, ok, b1, b2 = _tri_hits(lox, loy, loz, ldx, ldy, ldz,
                                  inst.itri[:, lo:hi], t_min, t_cap)
        parts.append((t, ok & gate[:, None], b1, b2))
    return parts


def _closest_hit(ox, oy, oz, dx, dy, dz, sph, quad, tri, t_min, t_cap,
                 inst=None, uv: bool = False):
    """Brute-force closest hit of B rays against every sphere, quad and
    (when `tri` is not None) triangle, and every instance's triangles
    (when `inst` is not None): the lexicographic minimum of (t, ordinal)
    over accepted primitives, which is what the strict-< / lowest-ordinal
    fold computes in any visit order.  An instanced triangle's ordinal is
    its instance's base (row 23) plus its itri column.

    Returns (best_t, gx, gy, gz, front, is_sph, mid, ord, u, v): best_t
    = BIG on a miss; the winner's raw geometry (sphere center, quad
    normal, the unnormalised barycentric blend of the triangle's vertex
    normals, or for an instanced triangle that blend taken to world space
    by the instance's rows 13-21), its front flag, kind, material id and
    global ordinal; with `uv` its texture coordinates (a quad's 0.5 +
    0.5 a, 0.5 + 0.5 b, a triangle's barycentric blend of its rows 27-32,
    an instanced triangle's of itri rows 25-30, 0 for a sphere, whose
    map the bounce computes), else zeros.  Fields of a missing ray are
    arbitrary."""
    n_s, n_q = sph.shape[1], quad.shape[1]
    n_t = 0 if tri is None else tri.shape[1]
    ranges = () if inst is None else inst.ranges
    ords = torch.cat(
        [sph[5], quad[13]] + ([tri[17]] if n_t else [])
        + [inst.inst[23, k] + torch.arange(lo, hi, dtype=torch.float32,
                                           device=sph.device)
           for k, (lo, hi) in enumerate(ranges)])
    n_all = int(ords.shape[0])
    step = max(1, CHUNK_ELEMS // n_all)
    outs = []
    for lo in range(0, ox.shape[0], step):
        ray = tuple(v[lo:lo + step] for v in (ox, oy, oz, dx, dy, dz))
        ts, oks, frs = _sphere_hits(*ray, sph, t_min, t_cap)
        tq, okq, frq, qa, qb = _quad_hits(*ray, quad, t_min, t_cap)
        ts, oks = [ts, tq], [oks, okq]
        if n_t:
            tt, okt, b1, b2 = _tri_hits(*ray, tri, t_min, t_cap)
            ts.append(tt)
            oks.append(okt)
        iparts = [] if inst is None else _instance_hits(*ray, inst, t_min,
                                                        t_cap)
        for ti, oki, _, _ in iparts:
            ts.append(ti)
            oks.append(oki)
        # A candidate must beat the fold's initial (BIG, 2^24) carry.
        t = torch.cat(ts, 1)
        ok = torch.cat(oks, 1) & (t <= BIG)
        t = torch.where(ok, t, math.inf)
        tmin = t.min(1).values
        tie_ord = torch.where(t == tmin[:, None], ords, math.inf)
        col = tie_ord.argmin(1)

        is_sph = col < n_s
        cs = col.clamp(max=n_s - 1)
        cq = (col - n_s).clamp(min=0, max=n_q - 1)
        front = torch.cat([frs, frq], 1).gather(
            1, col.clamp(max=n_s + n_q - 1)[:, None])[:, 0]
        g = [torch.where(is_sph, sph[k, cs], quad[k, cq]) for k in range(3)]
        mid = torch.where(is_sph, sph[4, cs], quad[12, cq])
        u = v = torch.zeros_like(tmin)
        if uv:
            is_q = (col >= n_s) & (col < n_s + n_q)
            u = torch.where(is_q, 0.5 + 0.5 * qa.gather(1, cq[:, None])[:, 0],
                            u)
            v = torch.where(is_q, 0.5 + 0.5 * qb.gather(1, cq[:, None])[:, 0],
                            v)
        if n_t:
            is_tri = col >= n_s + n_q
            ct = (col - n_s - n_q).clamp(min=0, max=n_t - 1)
            b1 = b1.gather(1, ct[:, None])[:, 0]
            b2 = b2.gather(1, ct[:, None])[:, 0]
            b0 = 1.0 - b1 - b2
            inrm = [b0 * tri[18 + k, ct] + b1 * tri[21 + k, ct]
                    + b2 * tri[24 + k, ct] for k in range(3)]
            back = (ray[3] * inrm[0] + ray[4] * inrm[1] + ray[5] * inrm[2]) > 0.0
            g = [torch.where(is_tri, a, b) for a, b in zip(inrm, g)]
            front = torch.where(is_tri, ~back, front)
            mid = torch.where(is_tri, tri[16, ct], mid)
            if uv:
                u = torch.where(is_tri, b0 * tri[27, ct] + b1 * tri[29, ct]
                                + b2 * tri[31, ct], u)
                v = torch.where(is_tri, b0 * tri[28, ct] + b1 * tri[30, ct]
                                + b2 * tri[32, ct], v)
        base = n_s + n_q + n_t
        for k, ((_, _, ib1, ib2), (ilo, ihi)) in enumerate(zip(iparts,
                                                                ranges)):
            is_k = (col >= base) & (col < base + ihi - ilo)
            c = (col - base).clamp(min=0, max=ihi - ilo - 1)
            base += ihi - ilo
            ib1 = ib1.gather(1, c[:, None])[:, 0]
            ib2 = ib2.gather(1, c[:, None])[:, 0]
            ib0 = 1.0 - ib1 - ib2
            j = c + ilo
            it, gk = inst.itri, inst.inst[:, k]
            inrm = [ib0 * it[16 + a, j] + ib1 * it[19 + a, j]
                    + ib2 * it[22 + a, j] for a in range(3)]
            wn = [gk[13 + 3 * a] * inrm[0] + gk[14 + 3 * a] * inrm[1]
                  + gk[15 + 3 * a] * inrm[2] for a in range(3)]
            back = (ray[3] * wn[0] + ray[4] * wn[1] + ray[5] * wn[2]) > 0.0
            g = [torch.where(is_k, a, b) for a, b in zip(wn, g)]
            front = torch.where(is_k, ~back, front)
            mid = torch.where(is_k, gk[22], mid)
            if uv:
                u = torch.where(is_k, ib0 * it[25, j] + ib1 * it[27, j]
                                + ib2 * it[29, j], u)
                v = torch.where(is_k, ib0 * it[26, j] + ib1 * it[28, j]
                                + ib2 * it[30, j], v)
        outs.append((torch.where(tmin < BIG, tmin, BIG), *g, front, is_sph,
                     mid.long(), ords[col], u, v))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _light_seed(px, py, pz, wx, wy, wz, row, is_sphl, t_min, t_cap):
    """(t, hit) of B shadow rays against their own light's primitive test
    (rows 18-27 of its column `row` of the light table): the seed of the
    kernel's any-hit shadow walk (``nee_direct``'s sh_t, sh_hit)."""
    ray = (px, py, pz, wx, wy, wz)
    ts, oks, _ = _sphere_hits(*ray, row[[2, 3, 4, 27]][:, :, None], t_min,
                              t_cap)
    tq, okq, _, _, _ = _quad_hits(
        *ray, row[[12, 13, 14] + list(range(18, 27))][:, :, None], t_min,
        t_cap)
    return (torch.where(is_sphl, ts[:, 0], tq[:, 0]),
            torch.where(is_sphl, oks[:, 0], okq[:, 0]))


def _nee_direct(px, py, pz, nx, ny, nz, cand, rng_d, lights, sph, quad,
                tri, t_min, t_cap, inst=None, record=None):
    """Next-event estimation at B shading points (``nee_direct`` of
    csrc/bounce.cuh, pallas_trace.py l.2748-2895): pick a light from salt
    5, sample a direction toward it from salts 6 and 7, and return the
    (B,) weights cos / (pi * pdf) of the samples whose light is visible,
    0 elsewhere, and the light's emission (3 x (B,)).  Only the `cand`
    points (Lambertian hits) sample.  Visibility is the closest-hit
    formulation: the brute-force closest hit along the shadow ray is the
    sampled light's ordinal.  With a `record` list, the shadow rays the
    kernel walks (its seed's test passes too) are appended to it as
    (points, origin xyz, direction xyz, seed t, light ordinal) for
    ops/walk_stats.py."""
    nl = lights.shape[1]
    u_l = rng.uniform01(rng_d, 5)
    u_a = rng.uniform01(rng_d, 6)
    u_b = rng.uniform01(rng_d, 7)
    li = torch.clamp_max((u_l * nl).to(torch.int64), nl - 1)
    # "+ 0.0" turns a -0.0 entry into +0.0, as the TPU's blend of rows does
    (lkind, lord, lcx, lcy, lcz, lr, lux, luy, luz, lvx, lvy, lvz,
     lqx, lqy, lqz, ler, leg, leb) = lights[:18, li] + 0.0

    # sphere light: uniform cone toward the sphere
    tox = lcx - px
    toy = lcy - py
    toz = lcz - pz
    dc2 = tox * tox + toy * toy + toz * toz
    inv_dc = ieee.rsqrt(torch.clamp_min(dc2, 1e-20))
    axx = tox * inv_dc
    axy = toy * inv_dc
    axz = toz * inv_dc
    sin2m = torch.clamp(lr * lr / torch.clamp_min(dc2, 1e-20), 0.0, 1.0)
    cosm = ieee.sqrt(torch.clamp_min(1.0 - sin2m, 0.0))
    cost = 1.0 - u_a * (1.0 - cosm)
    sint = ieee.sqrt(torch.clamp_min(1.0 - cost * cost, 0.0))
    phi_l = TWO_PI * u_b
    hy = (torch.abs(axx) > 0.9).to(torch.float32)
    hx = 1.0 - hy
    t1x = axy * 0.0 - axz * hy
    t1y = axz * hx - axx * 0.0
    t1z = axx * hy - axy * hx
    t_il = ieee.rsqrt(torch.clamp_min(t1x * t1x + t1y * t1y + t1z * t1z,
                                      1e-20))
    t1x = t1x * t_il
    t1y = t1y * t_il
    t1z = t1z * t_il
    t2x = axy * t1z - axz * t1y
    t2y = axz * t1x - axx * t1z
    t2z = axx * t1y - axy * t1x
    cp = ieee.cos(phi_l) * sint
    sp = ieee.sin(phi_l) * sint
    wsx = axx * cost + t1x * cp + t2x * sp
    wsy = axy * cost + t1y * cp + t2y * sp
    wsz = axz * cost + t1z * cp + t2z * sp
    pdf_s = 1.0 / torch.clamp_min(TWO_PI * (1.0 - cosm), 1e-12)
    s_ok = dc2 > lr * lr

    # quad light: uniform area, converted to a solid-angle pdf
    a2 = 2.0 * u_a - 1.0
    b2l = 2.0 * u_b - 1.0
    qpx = lcx + a2 * lux + b2l * lvx - px
    qpy = lcy + a2 * luy + b2l * lvy - py
    qpz = lcz + a2 * luz + b2l * lvz - pz
    dist2 = qpx * qpx + qpy * qpy + qpz * qpz
    inv_dq = ieee.rsqrt(torch.clamp_min(dist2, 1e-20))
    wqx = qpx * inv_dq
    wqy = qpy * inv_dq
    wqz = qpz * inv_dq
    crx = luy * lvz - luz * lvy
    cry = luz * lvx - lux * lvz
    crz = lux * lvy - luy * lvx
    area = 4.0 * ieee.sqrt(torch.clamp_min(crx * crx + cry * cry + crz * crz,
                                           0.0))
    cosl = torch.abs(wqx * lqx + wqy * lqy + wqz * lqz)
    pdf_q = dist2 / torch.clamp_min(cosl * area, 1e-12)
    q_ok = cosl > 1e-6

    is_sphl = lkind == 0.0
    wix = torch.where(is_sphl, wsx, wqx)
    wiy = torch.where(is_sphl, wsy, wqy)
    wiz = torch.where(is_sphl, wsz, wqz)
    pdf_l = torch.where(is_sphl, pdf_s, pdf_q) / float(nl)
    cos_s = wix * nx + wiy * ny + wiz * nz
    cand = cand & (cos_s > 0.0) & torch.where(is_sphl, s_ok, q_ok)
    if record is not None:
        sh_t, sh_hit = _light_seed(px, py, pz, wix, wiy, wiz,
                                   lights[:, li] + 0.0, is_sphl, t_min, t_cap)
        sel = torch.nonzero(cand & sh_hit)[:, 0]
        record.append((sel, *(v[sel] for v in (px, py, pz, wix, wiy, wiz,
                                                sh_t, lord))))

    vis = torch.zeros_like(cand)
    idx = torch.nonzero(cand)[:, 0]
    if idx.numel():
        sh = _closest_hit(px[idx], py[idx], pz[idx], wix[idx], wiy[idx],
                          wiz[idx], sph, quad, tri, t_min, t_cap, inst)
        vis[idx] = (sh[0] < BIG) & (sh[7] == lord[idx])
    w_l = (cos_s / (math.pi * torch.clamp_min(pdf_l, 1e-12))) \
        * (cand & vis).to(torch.float32)
    return w_l, (ler, leg, leb)


def _sky_radiance(sky, dx, dy, dz):
    """The sky seen along directions d: the constant sky, or (13-tuple
    spec) the gradient lerp(bottom, top, 0.5 * (d_hat.y + 1)) plus the
    sun color * max(d_hat . sun_dir, 0) ** power, the power taken by
    square-and-multiply over its bits (the JAX kernel's static binary
    exponentiation)."""
    if len(sky) == 3:
        return sky
    b = [float(np.float32(x)) for x in sky[:3]]
    top = [float(np.float32(x)) for x in sky[3:6]]
    inv_l = ieee.rsqrt(dx * dx + dy * dy + dz * dz)
    tmix = 0.5 * (dy * inv_l + 1.0)
    sk = [b[k] + tmix * float(np.float32(top[k] - b[k])) for k in range(3)]
    if sky_mode(sky) == 2:
        sd0, sd1, sd2, sc0, sc1, sc2 = sky[6:12]
        cosang = torch.clamp_min((dx * sd0 + dy * sd1 + dz * sd2) * inv_l,
                                 0.0)
        w, p, base = torch.ones_like(cosang), int(sky[12]), cosang
        while p:
            if p & 1:
                w = w * base
            base, p = base * base, p >> 1
        sk = [sk[0] + w * sc0, sk[1] + w * sc1, sk[2] + w * sc2]
    return sk


def _wrap(val, ext: float, inv: float):
    """val mod ext for the texture's repeat wrap, inv = float32(1 / ext)
    (``tex_wrap`` of bounce.cuh)."""
    return val - ext * torch.floor(val * inv)


def _texture_albedo(hit, mid, u, v, px, py, pz, is_sph_k, nrx, nry, nrz,
                    n_ilen, m_c, checker, itex, itex_tab):
    """The albedo (3 x (B,)) after the material's texture, in the JAX
    kernel's order (pallas_trace.py l.2612-2704): an image texture
    multiplies the albedo by its bilinear, repeat-wrapped sample at the
    hit's UV (a sphere's equirectangular map from its outward normal,
    whatever the front flag), then a checker replaces it by the odd color
    in odd cells.  Only hits of the material change."""
    m_c0, m_c1, m_c2 = m_c
    if itex:
        s_u = 0.5 + ieee.atan2(nrz, nrx) * INV_TWO_PI
        s_v = 0.5 - ieee.asin(torch.clamp(nry * n_ilen, -1.0, 1.0)) * INV_PI
        u_c = torch.where(is_sph_k, s_u, u)
        v_c = torch.where(is_sph_k, s_v, v)
        u_w = u_c - torch.floor(u_c)
        v_w = v_c - torch.floor(v_c)
        flat = itex_tab.reshape(-1)
    for cm, toff, th, tw in itex:
        sel = hit & (mid == int(cm))
        if not bool(sel.any()):
            continue
        thf, twf = float(th), float(tw)
        inv_h, inv_w = (float(np.float32(1.0 / e)) for e in (thf, twf))
        x = u_w * twf - 0.5
        y = (1.0 - v_w) * thf - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0

        def fetch(yi, xi):
            idx = (_wrap(yi, thf, inv_h) * twf
                   + _wrap(xi, twf, inv_w)).to(torch.int64)
            val = flat[torch.where(sel, idx, 0) + int(toff) * TEX_LANES]
            r8 = torch.floor(val * (1.0 / 65536.0))
            rem = val - r8 * 65536.0
            g8 = torch.floor(rem * (1.0 / 256.0))
            b8 = rem - g8 * 256.0
            return r8 * INV_255, g8 * INV_255, b8 * INV_255

        c00 = fetch(y0, x0)
        c01 = fetch(y0, x0 + 1.0)
        c10 = fetch(y0 + 1.0, x0)
        c11 = fetch(y0 + 1.0, x0 + 1.0)
        smp = [(c00[k] * (1.0 - fx) + c01[k] * fx) * (1.0 - fy)
               + (c10[k] * (1.0 - fx) + c11[k] * fx) * fy for k in range(3)]
        m_c0 = torch.where(sel, smp[0] * m_c0, m_c0)
        m_c1 = torch.where(sel, smp[1] * m_c1, m_c1)
        m_c2 = torch.where(sel, smp[2] * m_c2, m_c2)
    for cm, cs, c2r, c2g, c2b in checker:
        cs = float(np.float32(cs))
        cell = (torch.floor(px * cs + CHECKER_OFF)
                + torch.floor(py * cs + CHECKER_OFF)
                + torch.floor(pz * cs + CHECKER_OFF))
        odd = cell - 2.0 * torch.floor(cell * 0.5)
        selc = hit & (mid == int(cm)) & (odd > 0.5)
        m_c0 = torch.where(selc, float(np.float32(c2r)), m_c0)
        m_c1 = torch.where(selc, float(np.float32(c2g)), m_c1)
        m_c2 = torch.where(selc, float(np.float32(c2b)), m_c2)
    return m_c0, m_c1, m_c2


def _bounce(state, alive, rng_d, depth: int, sph, quad, tri, mats, t_min,
            t_cap, sky, lights=None, rr_depth: int = 0, inst=None,
            checker=(), itex=(), itex_tab=None, record=None):
    """One bounce of B alive paths at absolute depth `depth`: the new
    state and the (B,) float32 alive values after it (0 ended, 1 goes on,
    2 goes on from a diffuse vertex under NEE).  `alive` holds the values
    before it (1, or 2: emission was sampled by NEE at the previous vertex
    and is not added again).  `tri` is None when the scene has no
    hittable triangle, `lights` None when NEE is off, `inst` None without
    instances.  `sky` is a spec of ``_check_sky``; the textures of
    `checker` and `itex` apply before emission, NEE and attenuation.
    `record` collects the NEE shadow walks (``_nee_direct``)."""
    nee = lights is not None
    ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb = state
    best_t, gx, gy, gz, fr, is_sph, mid, _, u, v = _closest_hit(
        ox, oy, oz, dx, dy, dz, sph, quad, tri, t_min, t_cap, inst,
        uv=bool(itex))
    hit = best_t < BIG
    is_sph_k = hit & is_sph
    gx = torch.where(hit, gx, 0.0)
    gy = torch.where(hit, gy, 0.0)
    gz = torch.where(hit, gz, 0.0)
    m_type = torch.where(hit, mats[0, mid].long(), 0)
    m_c0 = torch.where(hit, mats[1, mid], 0.0)
    m_c1 = torch.where(hit, mats[2, mid], 0.0)
    m_c2 = torch.where(hit, mats[3, mid], 0.0)
    m_extra = torch.where(hit, mats[4, mid], 0.0)
    front = (hit & fr).to(torch.float32)

    # Deferred shading normal: spheres carried their center, quads the
    # unit plane normal, triangles the raw interpolated normal.
    px = ox + best_t * dx
    py = oy + best_t * dy
    pz = oz + best_t * dz
    nrx = torch.where(is_sph_k, px - gx, gx)
    nry = torch.where(is_sph_k, py - gy, gy)
    nrz = torch.where(is_sph_k, pz - gz, gz)
    n_ilen = ieee.rsqrt(torch.clamp_min(nrx * nrx + nry * nry + nrz * nrz,
                                        1e-30))
    sgn_n = (front * 2.0 - 1.0) * n_ilen
    nx = nrx * sgn_n
    ny = nry * sgn_n
    nz = nrz * sgn_n
    if checker or itex:
        m_c0, m_c1, m_c2 = _texture_albedo(
            hit, mid, u, v, px, py, pz, is_sph_k, nrx, nry, nrz, n_ilen,
            (m_c0, m_c1, m_c2), checker, itex, itex_tab)

    # miss: sky * throughput; emission before the scatter test, not added
    # again at a vertex whose light NEE sampled at the previous one
    mw = (~hit).to(torch.float32)
    sk = _sky_radiance(sky, dx, dy, dz)
    rr = rr + mw * tr * sk[0]
    rg = rg + mw * tg * sk[1]
    rb = rb + mw * tb * sk[2]
    lw = hit.to(torch.float32) * (m_type == MAT_EMISSIVE).to(torch.float32)
    if nee:
        lw = lw * (alive <= 1.5).to(torch.float32)
    rr = rr + lw * tr * m_c0
    rg = rg + lw * tg * m_c1
    rb = rb + lw * tb * m_c2

    is_lam = m_type == MAT_LAMBERTIAN
    is_met = m_type == MAT_METAL
    is_die = m_type == MAT_DIELECTRIC

    if nee:  # reads the throughput before the BSDF's attenuation
        w_l, (ler, leg, leb) = _nee_direct(px, py, pz, nx, ny, nz,
                                           hit & is_lam, rng_d, lights, sph,
                                           quad, tri, t_min, t_cap, inst,
                                           record)
        rr = rr + tr * m_c0 * w_l * ler
        rg = rg + tg * m_c1 * w_l * leg
        rb = rb + tb * m_c2 * w_l * leb

    u1 = rng.uniform01(rng_d, 1)
    u2 = rng.uniform01(rng_d, 2)
    u3 = rng.uniform01(rng_d, 3)
    z = 1.0 - 2.0 * u1
    rxy = ieee.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    ux = rxy * ieee.cos(phi)
    uy = rxy * ieee.sin(phi)
    uz = z

    lx = nx + ux
    ly = ny + uy
    lz = nz + uz
    degen = (torch.abs(lx) < 1e-8) & (torch.abs(ly) < 1e-8) \
        & (torch.abs(lz) < 1e-8)
    lx = torch.where(degen, nx, lx)
    ly = torch.where(degen, ny, ly)
    lz = torch.where(degen, nz, lz)

    dn_ = dx * nx + dy * ny + dz * nz
    rxm = dx - 2.0 * dn_ * nx + m_extra * ux
    rym = dy - 2.0 * dn_ * ny + m_extra * uy
    rzm = dz - 2.0 * dn_ * nz + m_extra * uz

    ri = torch.where(front > 0, 1.0 / m_extra, m_extra)
    cos_t = torch.clamp_max(-(dx * nx + dy * ny + dz * nz), 1.0)
    sin_t = ieee.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot = ri * sin_t > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    one_mc = 1.0 - cos_t
    schl = r0 + (1.0 - r0) * one_mc * one_mc * one_mc * one_mc * one_mc
    refl_choice = cannot | (schl > u3)
    qx = ri * (dx + cos_t * nx)
    qy = ri * (dy + cos_t * ny)
    qz = ri * (dz + cos_t * nz)
    qpar = -ieee.sqrt(torch.abs(1.0 - (qx * qx + qy * qy + qz * qz)))
    fx = qx + qpar * nx
    fy = qy + qpar * ny
    fz = qz + qpar * nz
    gx = dx - 2.0 * dn_ * nx
    gy = dy - 2.0 * dn_ * ny
    gz = dz - 2.0 * dn_ * nz
    ex = torch.where(refl_choice, gx, fx)
    ey = torch.where(refl_choice, gy, fy)
    ez = torch.where(refl_choice, gz, fz)

    sx = torch.where(is_lam, lx, torch.where(is_met, rxm, ex))
    sy = torch.where(is_lam, ly, torch.where(is_met, rym, ey))
    sz = torch.where(is_lam, lz, torch.where(is_met, rzm, ez))
    ilen = ieee.rsqrt(torch.clamp_min(sx * sx + sy * sy + sz * sz, 1e-30))
    sx = sx * ilen
    sy = sy * ilen
    sz = sz * ilen

    met_ok = (sx * nx + sy * ny + sz * nz) > 0.0
    scat_ok = torch.where(is_met, met_ok, is_lam | is_die)
    att_r = torch.where(is_die, 1.0, m_c0)
    att_g = torch.where(is_die, 1.0, m_c1)
    att_b = torch.where(is_die, 1.0, m_c2)

    cont = hit & scat_ok
    cw = cont.to(torch.float32)
    ncw = 1.0 - cw
    tr = tr * (ncw + cw * att_r)
    tg = tg * (ncw + cw * att_g)
    tb = tb * (ncw + cw * att_b)
    if 0 < rr_depth <= depth:
        # Russian roulette: survive with p = clip(max channel, 0.05, 1),
        # a survivor's throughput divided by p
        p = torch.clamp(torch.maximum(tr, torch.maximum(tg, tb)), 0.05, 1.0)
        survive = ~(rng.uniform01(rng_d, 4) >= p)
        boost = torch.where(survive & cont, 1.0 / p, 1.0)
        tr = tr * boost
        tg = tg * boost
        tb = tb * boost
        cw = cw * survive.to(torch.float32)
    ox = torch.where(cont, px, ox)
    oy = torch.where(cont, py, oy)
    oz = torch.where(cont, pz, oz)
    dx = torch.where(cont, sx, dx)
    dy = torch.where(cont, sy, dy)
    dz = torch.where(cont, sz, dz)
    if nee:  # a diffuse continuation: the next vertex adds no emission
        cw = cw * torch.where(is_lam, 2.0, 1.0)
    return (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb), cw


def trace_reference(o, d, pix, seed: int, sph, quad, tri, sph_cl, quad_cl,
                    tri_cl, mats, *, max_depth: int, t_min: float,
                    t_max: float, sky, tri_live: bool, rr_depth: int = 0,
                    nee: bool = False, lights=None, inst=None, checker=(),
                    itex=(), itex_tab=None, stream=None,
                    depth_out: bool = False,
                    collect_stats: bool = False, records=None):
    """Plain PyTorch version of ``trace`` (same signature and result; the
    records are the kernels' copy of the tables and are not read).
    Each bounce runs on the rays still alive: a dead ray's bounce leaves
    its state unchanged, as in the TPU kernel's dead-tile exit.  The
    stream tables are validated and not walked by the radiance's fold,
    which tests every slot column.  ``depth_out`` counts the bounces each
    ray enters alive; ``collect_stats`` records every walk the kernel
    makes (each alive ray's closest-hit walk per bounce, each NEE shadow
    ray's any-hit walk) and replays them (ops/walk_stats.py)."""
    lights = _light_table(nee, lights)
    sky = _check_sky(sky)
    _check_textures(checker, itex, itex_tab, tri, inst, int(mats.shape[1]))
    _check_stream(tri, tri_cl, stream)
    r = o.shape[0]
    dev = o.device
    t_cap = _t_cap(t_max)
    ones = torch.ones(r, dtype=torch.float32, device=dev)
    zeros = torch.zeros(r, dtype=torch.float32, device=dev)
    state = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
             ones, ones.clone(), ones.clone(), zeros, zeros.clone(),
             zeros.clone()]
    state = [s.contiguous().clone() for s in state]
    rng_base = rng.pcg_hash((pix.to(torch.int64) & rng.MASK32)
                            ^ (int(seed) & rng.MASK32))
    alive = ones.clone()
    idx = torch.arange(r, device=dev)
    steps = torch.zeros(r, dtype=torch.int32, device=dev)
    walks = [] if collect_stats else None
    for depth in range(max_depth):
        if idx.numel() == 0:
            break
        steps[idx] += 1
        rng_d = (rng_base[idx] + depth * rng.DEPTH_STEP) & rng.MASK32
        shadows = [] if collect_stats and lights is not None else None
        ray = [s[idx] for s in state]
        if collect_stats:
            walks.append((idx, *ray[:6], torch.full_like(ray[0], BIG),
                          torch.full_like(ray[0], float(1 << 24)), False))
        new, alive_out = _bounce(ray, alive[idx], rng_d,
                                 depth, sph, quad, tri if tri_live else None,
                                 mats, t_min, t_cap, sky, lights, rr_depth,
                                 inst, checker, itex, itex_tab, shadows)
        for sel, *shadow in shadows or ():
            walks.append((idx[sel], *shadow, True))
        for s, v in zip(state, new):
            s[idx] = v
        alive[idx] = alive_out
        idx = idx[alive_out > 0.0]
    rad = torch.stack(state[9:12], dim=1)
    stats = None
    if collect_stats:
        from parallelraytracing_tpu_torch.ops import walk_stats
        stats = torch.zeros((r, 4), dtype=torch.int32, device=dev)
        stats[:, :3] = walk_stats.per_ray(
            walks, r, sph, quad, tri if tri_live else None, sph_cl, quad_cl,
            tri_cl, t_min=t_min, t_cap=t_cap, inst=inst, stream=stream)
        stats[:, 3] = steps
    return _with_probes(rad, steps.to(torch.float32), stats, depth_out,
                        collect_stats)
