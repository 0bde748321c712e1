"""The TLAS engines: instanced scenes through a two-level structure (the
counterpart of ``parallelraytracing_tpu.engines.tlas``).

The analogue of the reference's OptiX instance-over-geometry pipeline:
unique meshes keep one local copy and one tree (``Scene.add_mesh_instances``),
instances are transform records, and a ray walks the top tree, then an
entered instance's mesh tree in the mesh's space.  Two registrations:

- `tlas`: the fused engine, whose trace kernel walks the instances itself
  (the instance block of csrc/bounce.cuh).  Registered under its own name
  so that rendering through the two-level structure is an explicit engine
  choice.
- `tlas_ref`: the megakernel's bounce loop over the base scene's LBVH walk
  and the two-level walk of accel/tlas.py (plain PyTorch).  It draws the
  megakernel engine's threefry streams, so its film is held to the
  megakernel's on the world-baked scene at float tolerance.  A scene
  without instances renders through the base scene's LBVH alone, as the
  JAX engine does.
"""

from __future__ import annotations

import torch

from parallelraytracing_tpu_torch.accel.lbvh import build_bvh
from parallelraytracing_tpu_torch.accel.tlas import (resolve_instanced_hit,
                                                     tlas_intersect, tlas_walk)
from parallelraytracing_tpu_torch.accel.traverse import (bvh_intersect_scene,
                                                         bvh_walk)
from parallelraytracing_tpu_torch.core.scene import KIND_TRIANGLE
from parallelraytracing_tpu_torch.engines.base import register_engine
from parallelraytracing_tpu_torch.engines.bvh import (BVH_RAYS_PER_CALL,
                                                      make_bvh_intersector)
from parallelraytracing_tpu_torch.engines.fused import FusedRenderer
from parallelraytracing_tpu_torch.engines.megakernel import MegakernelRenderer
from parallelraytracing_tpu_torch.engines.tracer import trace_paths_tiled
from parallelraytracing_tpu_torch.ops.intersect import HitRecord
from parallelraytracing_tpu_torch.ops.textures import TEX_IMAGE_BASE

_BIG = 3.0e38


def combined_intersect(scene, bvh, tl, o: torch.Tensor, d: torch.Tensor,
                       t_min: float, t_max: float) -> HitRecord:
    """Closest hit across the base scene's LBVH and the instances' two
    levels (`bvh` and `tl` as BVHData / TwoLevelBVH or their walks)."""
    base = bvh_intersect_scene(scene, bvh, o, d, t_min, t_max)
    t2, inst, tri, b1, b2 = tlas_intersect(tl, o, d, t_min, t_max)
    tl = getattr(tl, "tl", tl)
    pos2, n2, front2, mat2 = resolve_instanced_hit(tl, o, d, t2, inst, tri,
                                                   b1, b2)
    better = t2 < torch.where(base.hit, base.t, _BIG)
    bb = better[:, None]
    # an instanced mesh has no texture coordinates (the engine refuses
    # image textures on instanced scenes), so its hits read the origin
    uv = None if base.uv is None else torch.where(bb, 0.0, base.uv)
    return HitRecord(
        t=torch.where(better, t2, base.t),
        hit=base.hit | better,
        pos=torch.where(bb, pos2, base.pos),
        normal=torch.where(bb, n2, base.normal),
        front=torch.where(better, front2, base.front),
        mat=torch.where(better, mat2, base.mat),
        kind=torch.where(better, KIND_TRIANGLE, base.kind).to(torch.int32),
        idx=torch.where(better, tri, base.idx),
        uv=uv)


def make_tlas_intersector(bvh, tl, cfg):
    """``combined_intersect`` under cfg's t range, the walks made once."""
    bwalk, twalk = bvh_walk(bvh), tlas_walk(tl)

    def intersect(scene, o, d):
        return combined_intersect(scene, bwalk, twalk, o, d, cfg.t_min,
                                  cfg.t_max)
    return intersect


def tlas_trace(scene, bvh, tl, o, d, key, cfg, lights=None):
    """(R, 3) radiance of the rays (o, d) under the path key `key`, tiled
    as ``trace_paths_tiled``, each bounce through ``combined_intersect``."""
    return trace_paths_tiled(scene, o, d, key, cfg,
                             make_tlas_intersector(bvh, tl, cfg), lights,
                             batch=BVH_RAYS_PER_CALL)


@register_engine
class TLASRenderer(FusedRenderer):
    name = "tlas"


@register_engine
class TLASRefRenderer(MegakernelRenderer):
    """The plain PyTorch two-level walk (module doc)."""

    name = "tlas_ref"
    rays_per_call = BVH_RAYS_PER_CALL

    def _post_init(self) -> None:
        if (self._scene.instances
                and any(t >= TEX_IMAGE_BASE for t in self._scene._mat_tex)):
            raise NotImplementedError(
                "image textures on instanced-mesh scenes: instances do not "
                "carry per-vertex uvs (bake the mesh with add_mesh, or use "
                "add_checker: position-based, instance-safe)")
        from parallelraytracing_tpu_torch.ops.nee import extract_lights
        # the base scene leaves the instances out; NEE's lights are its
        # emissive spheres and quads, as in the other engines
        base, tl = self._scene.build_two_level(self.device)
        self._scene_data = base
        lights = extract_lights(base.numpy()) if self.config.nee else None
        self._lights = None if lights is None else lights.to(self.device)
        self._bvh = build_bvh(base, self.device)
        self._tlas = tl
        if tl is None:
            self._intersect = make_bvh_intersector(self._bvh, self.config)
        else:
            self._intersect = make_tlas_intersector(self._bvh, tl, self.config)
