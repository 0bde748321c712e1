"""The `bvh` engine: the megakernel's bounce loop over the LBVH walk (the
counterpart of ``parallelraytracing_tpu.engines.bvh``).

The analogue of the reference's OptiX backend: the acceleration
structure is built once at init (accel/lbvh.py, on the host, moved to the
device once) and every bounce intersects through its threaded walk
(accel/traverse.py) instead of the brute force.  The frame's streams are
the megakernel engine's exactly (the same fold_in / split / tile_streams
keying, the same per-ray draws), so `bvh` and `megakernel` trace the same
paths and their films differ only where the two intersectors round a hit
differently: bench's equal-streams row.

Beyond the reference: set `animate` to a (SceneData, frame) -> SceneData
update with the same topology, and each frame moves the primitives,
recomputes the leaf boxes and refits the same tree bottom-up, one level
at a time (accel/refit.py).  As in the JAX engine, an animated frame
traces without NEE's light table.
"""

from __future__ import annotations

from typing import Callable, Optional

from parallelraytracing_tpu_torch.accel.lbvh import build_bvh
from parallelraytracing_tpu_torch.accel.refit import build_refit_plan, refit_bvh
from parallelraytracing_tpu_torch.accel.traverse import (bvh_intersect_scene,
                                                         bvh_walk)
from parallelraytracing_tpu_torch.core.scene import SceneData
from parallelraytracing_tpu_torch.engines.base import register_engine
from parallelraytracing_tpu_torch.engines.megakernel import MegakernelRenderer
from parallelraytracing_tpu_torch.engines.tracer import trace_paths_tiled

#: rays a walk takes at once: a frame of 1080p and more (the walk's
#: transients are a few hundred bytes a ray, and each round's launches are
#: shared by every ray in it)
BVH_RAYS_PER_CALL = 1 << 22


def make_bvh_intersector(bvh, cfg):
    """The closest hit through `bvh` under cfg's t range (its walk tables
    made once)."""
    walk = bvh_walk(bvh)

    def intersect(scene, o, d):
        return bvh_intersect_scene(scene, walk, o, d, cfg.t_min, cfg.t_max)
    return intersect


def bvh_trace(scene, bvh, o, d, key, cfg, lights=None):
    """(R, 3) radiance of the rays (o, d) under the path key `key`, tiled
    as ``trace_paths_tiled``, each bounce through the BVH walk."""
    return trace_paths_tiled(scene, o, d, key, cfg,
                             make_bvh_intersector(bvh, cfg), lights,
                             batch=BVH_RAYS_PER_CALL)


@register_engine
class BVHRenderer(MegakernelRenderer):
    name = "bvh"
    rays_per_call = BVH_RAYS_PER_CALL

    #: optional animation hook: (SceneData, frame) -> SceneData with the
    #: same topology (counts and kinds; positions and sizes move)
    animate: Optional[Callable[[SceneData, int], SceneData]] = None
    #: when animating, refit the tree (True) or keep the build's boxes
    #: (False: shows why the refit is needed)
    refit: bool = True

    def _post_init(self) -> None:
        super()._post_init()
        self._bvh = build_bvh(self._scene_data, self.device)
        self._intersect = make_bvh_intersector(self._bvh, self.config)
        self._plan = (build_refit_plan(self._bvh)
                      if self.animate is not None else None)

    def _frame_tracer(self, frame_index: int):
        if self.animate is None:
            return super()._frame_tracer(frame_index)
        scene = self.animate(self._scene_data, frame_index)
        bvh = (refit_bvh(self._bvh, scene, self._plan) if self.refit
               else self._bvh)
        return scene, make_bvh_intersector(bvh, self.config), None
