"""Worlds of gloo ranks for the port's multi-device tests, and what the
ranks compute in them.  Nothing here imports JAX: a rank imports torch and
the port only (the JAX side of a comparison runs in the pytest process).

``run_world(n, tasks, tmp_path)`` spawns n ranks (torch.multiprocessing,
the spawn method), each with one PyTorch thread, joined by a FileStore
under `tmp_path` and the gloo backend (``init_process_group``, a 60 s
timeout); every rank runs every task of `tasks` in order, each a (name,
function of this module, arguments), and the parent gets each rank's
{name: result} (numpy, plain Python).  The parent joins with a deadline of
JOIN_TIMEOUT seconds: past it every rank still running is killed and the
world fails, so a hang never outlives its test.  Each rank calls
``destroy_process_group`` before it exits.

The scenes are named by specs (``make_scene``) and built in each rank with
the port's Scene class, or in the pytest process with either package's:
the recipes take the Scene class, as tests/torch_meshes.py's do.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

import torch_meshes as tm

#: seconds the parent waits for a world before it kills the ranks (a world
#: of 4 ranks starts, all-reduces and gathers in ~3.5 s on a few cores)
JOIN_TIMEOUT = 90.0
#: init_process_group's timeout in each rank
PG_TIMEOUT = datetime.timedelta(seconds=60)


def run_world(n: int, tasks, tmp_path, timeout: float = JOIN_TIMEOUT):
    """Run `tasks` on a world of n gloo ranks; each rank's {name: result}."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp_path = os.fspath(tmp_path)
    store = os.path.join(tmp_path, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, n, store, tmp_path, list(tasks)),
                         daemon=True) for rank in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise AssertionError(f"ranks {hung} of a world of {n} were still "
                             f"running after {timeout} s: killed")
    results, errors = [], []
    for rank, p in enumerate(procs):
        path = os.path.join(tmp_path, f"rank{rank}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {rank}: exit code {p.exitcode}, no result")
            continue
        with open(path, "rb") as f:
            ok, value = pickle.load(f)
        if ok:
            results.append(value)
        else:
            errors.append(f"rank {rank}:\n{value}")
    if errors:
        raise AssertionError("\n".join(errors))
    return results


def _rank_main(rank: int, n: int, store: str, out_dir: str, tasks) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank,
                            world_size=n, timeout=PG_TIMEOUT)
    try:
        out = (True, {name: globals()[fn](*args) for name, fn, args in tasks})
    except BaseException:  # report it to the parent, whatever it was
        out = (False, traceback.format_exc())
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ----------------------------------------------------------------- scenes

def mesh_scene(scene_cls, mesh):
    """tests/test_parallel.py's mesh scene: a diffuse mesh scaled 1.5,
    turned 20 degrees and lifted 1, over a 30x30 ground quad, under an
    emissive sphere."""
    s = scene_cls(preset=None)
    s.add_mesh(mesh, s.add_lambertian((0.8, 0.3, 0.2)),
               ((1.5, 1.5, 1.5), (0, 20, 0), (0, 1, 0)))
    s.add_quad(30, 30, s.add_lambertian((0.5, 0.5, 0.5)), None)
    s.add_sphere(1.0, s.add_emissive((8, 8, 8)),
                 ((1, 1, 1), (0, 0, 0), (3, 7, 3)))
    return s


def make_scene(pkg, spec: str):
    """The scene named `spec` with package `pkg`'s Scene: a preset's name,
    "mesh:<torch_meshes name>" (mesh_scene) or "tlas:<name>"
    (torch_meshes.tlas_scene, instanced)."""
    kind, _, name = spec.partition(":")
    if kind == "mesh":
        return mesh_scene(pkg.Scene, tm.make_mesh(name))
    if kind == "tlas":
        return tm.tlas_scene(pkg.Scene, tm.make_mesh(name))
    return pkg.Scene(pkg.ScenePreset(spec))


def _port():
    import parallelraytracing_tpu_torch as T
    return T


def _cam(cfg):
    from parallelraytracing_tpu_torch.core.camera import default_camera
    return torch.from_numpy(default_camera(cfg.width, cfg.height).ray_params())


# ------------------------------------------------------------ rank tasks

def mesh_info(spp_axes):
    """make_render_mesh for each spp axis: shape, this rank's (px_i,
    spp_i) and the global ranks of its spp and px groups (None: the mesh
    needs no collective over that axis)."""
    from parallelraytracing_tpu_torch.parallel.sharding import make_render_mesh
    out = {}
    for spp in spp_axes:
        m = make_render_mesh(spp_axis=spp)
        out[spp] = dict(
            shape=dict(m.shape), px_i=m.px_i, spp_i=m.spp_i,
            ranks=m.ranks.tolist(),
            spp_group=(None if m.spp_group is None
                       else dist.get_process_group_ranks(m.spp_group)),
            px_group=(None if m.px_group is None
                      else dist.get_process_group_ranks(m.px_group)))
    return out


def frame_plain(spec: str, cfg_kw: dict, seed: int, spp_axis: int):
    """render_frame_sharded (the plain tracer) of one frame under
    PRNGKey(seed): the whole (H*W, 3) frame, and this rank's block."""
    from parallelraytracing_tpu_torch.ops import rng
    from parallelraytracing_tpu_torch.parallel.sharding import (
        make_render_mesh, render_frame_sharded)
    T = _port()
    cfg = T.RenderConfig(**cfg_kw)
    scene = make_scene(T, spec).build("cpu")
    mesh = make_render_mesh(spp_axis=spp_axis)
    key = rng.prng_key(seed)
    whole = render_frame_sharded(scene, _cam(cfg), key, cfg, mesh)
    block = render_frame_sharded(scene, _cam(cfg), key, cfg, mesh,
                                 gather=False)
    return whole.numpy(), block.numpy()


def frame_kernel_route(route: str, spec: str, cfg_kw: dict, seed: int,
                       spp_axis: int, morton: bool, route_kw=None):
    """render_frame_sharded_fused ("fused") or _segmented ("segmented")
    of one sample under PRNGKey(seed), gathered to pixel order, with the
    pixel ids in scanline order or Morton order (padded with ids past
    H*W)."""
    from parallelraytracing_tpu_torch.engines.fused import morton_pixel_perm
    from parallelraytracing_tpu_torch.engines.tables import build_scene_tables
    from parallelraytracing_tpu_torch.ops import rng
    from parallelraytracing_tpu_torch.parallel import sharding as S
    T = _port()
    cfg = T.RenderConfig(**cfg_kw)
    tables, _ = build_scene_tables(make_scene(T, spec), "cpu", nee=cfg.nee)
    mesh = S.make_render_mesh(spp_axis=spp_axis)
    perm = inv = None
    if morton:
        r = cfg.pixel_count
        mperm, minv = morton_pixel_perm(cfg.width, cfg.height)
        n_slots = mesh.shape["px"] * S.shard_block_size(cfg, mesh)
        perm = torch.from_numpy(np.concatenate(
            [mperm, np.arange(r, n_slots)]).astype(np.int32))
        inv = torch.from_numpy(minv.copy())
    fn = (S.render_frame_sharded_fused if route == "fused"
          else S.render_frame_sharded_segmented)
    out = fn(tables, _cam(cfg), rng.prng_key(seed), cfg, mesh, perm=perm,
             inv=inv, **(route_kw or {}))
    return out.numpy()


def engine_film(spec: str, cfg_kw: dict, frames: int, attrs=None):
    """The sharded engine's film after `frames` frames and gather_film:
    (HDR image, the engine's route, the film's block)."""
    from parallelraytracing_tpu_torch.core.camera import default_camera
    T = _port()
    cfg = T.RenderConfig(**cfg_kw)
    film = T.Film(cfg.width, cfg.height, "cpu")
    r = T.create_renderer("sharded", "cpu")
    for k, v in (attrs or {}).items():
        setattr(r, k, v)
    r.init(film, make_scene(T, spec), default_camera(cfg.width, cfg.height),
           cfg)
    for _ in range(frames):
        r.progressive_render()
    r.gather_film()
    return (film.hdr_average().numpy(),
            "segmented" if r._use_seg else "fused", film.block)


def cli_run(argv, out_png: str):
    """The CLI under a launcher's environment (WORLD_SIZE, RANK,
    LOCAL_RANK as torchrun sets them) in this world's process group:
    (exit code, whether this rank wrote `out_png`)."""
    from parallelraytracing_tpu_torch import cli
    os.environ.update(WORLD_SIZE=str(dist.get_world_size()),
                      RANK=str(dist.get_rank()), LOCAL_RANK="0")
    rc = cli.main(list(argv) + ["--out", out_png.format(rank=dist.get_rank())])
    dist.barrier()
    return rc, os.path.exists(out_png.format(rank=dist.get_rank()))
