"""Rendering engines.  Importing this package registers each engine."""

from parallelraytracing_tpu_torch.engines.base import (Renderer, available_engines,
                                                       create_renderer, register_engine)
from parallelraytracing_tpu_torch.engines import fused as _fused  # noqa: F401

__all__ = ["Renderer", "available_engines", "create_renderer", "register_engine"]
