"""Abstract renderer contract and the engine registry.

The counterpart of ``parallelraytracing_tpu.engines.base`` (the reference
Renderer interface, src/core/renderer.h:8-16: Init / ProgressiveRender /
SetCamera).  Engines register by name; a renderer is made for one device.
"""

from __future__ import annotations

import abc
from typing import Dict, Optional, Type

import torch

from parallelraytracing_tpu_torch.config import RenderConfig
from parallelraytracing_tpu_torch.core.camera import Camera
from parallelraytracing_tpu_torch.core.film import Film
from parallelraytracing_tpu_torch.core.scene import Scene, SceneData


class Renderer(abc.ABC):
    """One progressive sample pass per ``progressive_render()`` call."""

    name: str = "base"

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._film: Optional[Film] = None
        self._scene_data: Optional[SceneData] = None
        self._cam_params: Optional[torch.Tensor] = None
        self._config: Optional[RenderConfig] = None
        self._frame_index: int = 0
        self._qseed: Optional[int] = None

    # ----------------------------------------------------------- lifecycle
    def init(self, film: Film, scene: Scene, camera: Camera,
             config: Optional[RenderConfig] = None) -> None:
        """Renderer::Init: compile and upload the scene once."""
        if film.device != self.device:
            raise ValueError(f"film on {film.device}, renderer on {self.device}")
        self._film = film
        self._config = config or RenderConfig(width=film.width, height=film.height)
        self._scene = scene
        # QMC camera sampling: the frame-independent rotation seed, shared
        # by every engine so their films stay bit-identical with QMC on
        from parallelraytracing_tpu_torch.ops.rays import qmc_rotation_seed
        self._qseed = (qmc_rotation_seed(self._config.seed)
                       if self._config.qmc else None)
        self.set_camera(camera)
        self._frame_index = 0
        self._post_init()
        film.set_layout(self.film_layout())

    def _post_init(self) -> None:
        """Hook for engine-specific setup (e.g. table packing)."""

    def _pixel_seed(self, jseed: int) -> int:
        """The raygen's pixel seed: the frame's jitter seed, or under QMC
        the frame-independent rotation seed."""
        return jseed if self._qseed is None else self._qseed

    def _qpt(self, frame_index: int, s: int):
        """The (4,) Halton point of sample s of this frame (None unless
        QMC): global sample index frame * spp + s, so the progressive
        accumulation walks the sequence in order."""
        if self._qseed is None:
            return None
        from parallelraytracing_tpu_torch.ops.rays import halton_qpt
        return halton_qpt(frame_index * self.config.samples_per_frame + s)

    def film_layout(self):
        """Engine-preferred film storage layout (inv, slots), or None for
        the canonical (H, W) layout (core/film.set_layout)."""
        return None

    def set_camera(self, camera: Camera) -> None:
        """Renderer::SetCamera: upload the packed camera parameters."""
        self._camera = camera
        self._cam_params = torch.from_numpy(camera.ray_params()).to(self.device)

    # ------------------------------------------------------------- render
    def progressive_render(self) -> None:
        """Render one progressive pass and accumulate it into the film."""
        if self._film is None:
            raise RuntimeError("init() first")
        cfg = self._config
        rgb = self.render_sample_buffer(self._frame_index)
        if cfg.firefly_clamp > 0.0:
            rgb = torch.clamp_max(rgb, cfg.firefly_clamp)
        self._film.add_sample_buffer(rgb, float(cfg.samples_per_frame))
        self._frame_index += 1

    @abc.abstractmethod
    def render_sample_buffer(self, frame_index: int) -> torch.Tensor:
        """The mean radiance of `samples_per_frame` fresh samples per pixel
        for this frame, (H*W, 3) or in the film's storage layout."""

    # -------------------------------------------------------------- info
    @property
    def config(self) -> RenderConfig:
        assert self._config is not None
        return self._config


_REGISTRY: Dict[str, Type[Renderer]] = {}


def register_engine(cls: Type[Renderer]) -> Type[Renderer]:
    _REGISTRY[cls.name] = cls
    return cls


def available_engines():
    return sorted(_REGISTRY)


def create_renderer(name: str, device) -> Renderer:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown engine {name!r}; this port has: "
                         f"{available_engines()}") from None
    return cls(device)
