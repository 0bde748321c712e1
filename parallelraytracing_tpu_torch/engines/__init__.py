"""Rendering engines.  Importing this package registers each engine."""

from parallelraytracing_tpu_torch.engines.base import (Renderer, available_engines,
                                                       create_renderer, register_engine)
from parallelraytracing_tpu_torch.engines import fused as _fused  # noqa: F401
from parallelraytracing_tpu_torch.engines import wavefront_fused as _wavefront_fused  # noqa: F401
from parallelraytracing_tpu_torch.engines import tlas as _tlas  # noqa: F401
from parallelraytracing_tpu_torch.engines import megakernel as _megakernel  # noqa: F401
from parallelraytracing_tpu_torch.engines import adaptive as _adaptive  # noqa: F401
from parallelraytracing_tpu_torch.engines import bvh as _bvh  # noqa: F401
from parallelraytracing_tpu_torch.engines import wavefront as _wavefront  # noqa: F401
from parallelraytracing_tpu_torch.engines import sharded as _sharded  # noqa: F401

__all__ = ["Renderer", "available_engines", "create_renderer", "register_engine"]
