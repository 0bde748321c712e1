"""PyTorch/CUDA port of the path tracer (the JAX package
``parallelraytracing_tpu`` stays as the reference).

Imports torch and numpy only.  The fused engine's trace runs as a
hand-written CUDA kernel on a CUDA device (built at first use from
``csrc/``) and as its plain PyTorch version on the CPU."""

from parallelraytracing_tpu_torch.config import DisplayConfig, RenderConfig
from parallelraytracing_tpu_torch.core.camera import Camera, default_camera
from parallelraytracing_tpu_torch.core.film import Film
from parallelraytracing_tpu_torch.core.scene import Scene, SceneData, ScenePreset
from parallelraytracing_tpu_torch.engines import (Renderer, available_engines,
                                                  create_renderer)

__all__ = ["Camera", "DisplayConfig", "Film", "RenderConfig", "Renderer",
           "Scene", "SceneData", "ScenePreset", "available_engines",
           "create_renderer", "default_camera"]
