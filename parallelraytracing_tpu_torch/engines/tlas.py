"""The `tlas` engine: instanced scenes through the fused engine.

The counterpart of ``parallelraytracing_tpu.engines.tlas``'s ``tlas``
registration: the fused engine, whose trace kernel walks the instances
itself (the instance block of csrc/bounce.cuh: a scan of the instances'
world boxes, then each entered instance's mesh-local tree, the role of
the reference's OptiX instance-over-geometry structures).  Unique meshes
keep one local copy (``Scene.add_mesh_instances``); registered under its
own name so that rendering through the two-level structure is an
explicit engine choice.

The JAX package's ``tlas_ref`` (its jnp mirror over accel/tlas.py, a test
oracle sharing the jnp engines' threefry streams) is not registered: it
waits for the torch-eager engines (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

from parallelraytracing_tpu_torch.engines.base import register_engine
from parallelraytracing_tpu_torch.engines.fused import FusedRenderer


@register_engine
class TLASRenderer(FusedRenderer):
    name = "tlas"
