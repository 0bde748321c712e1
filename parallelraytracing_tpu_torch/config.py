"""Run-time configuration for the renderer.

Same fields and defaults as ``parallelraytracing_tpu.config``, so a
configuration means the same render in both packages.  The reference's
constants (depth 20, sky (0.4, 0.3, 0.6), window 1920x1080, tMin 0.001)
live in one dataclass, overridable from the CLI.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Self-intersection epsilon: the reference relies on a ray tMin instead of
# offsetting scatter origins (src/core/shape.h:128).
SHAPE_RAY_T_MIN = 1.0e-3

# Sky radiance added (scaled by throughput) when a ray escapes the scene
# (src/backend/cuda_megakernel/renderer.cu:159).
DEFAULT_SKY = (0.4, 0.3, 0.6)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (frozen and hashable)."""

    width: int = 1920
    height: int = 1080
    #: path depth budget (the reference's CPU/megakernel/wavefront value)
    max_depth: int = 20
    #: samples per pixel per progressive frame
    samples_per_frame: int = 1
    #: sub-pixel jitter (the OptiX backend's anti-aliasing)
    jitter: bool = True
    #: Monte Carlo seed; counter-based streams make frames reproducible
    seed: int = 0
    t_min: float = SHAPE_RAY_T_MIN
    t_max: float = 1.0e16
    #: brute-force intersector chunk (the JAX jnp engines' knob; kept so
    #: configurations carry over unchanged)
    intersect_chunk: int = 256
    #: rays per tile of the JAX jnp engines (carried over unchanged)
    ray_tile: int = 1 << 17
    #: wavefront compaction threshold (carried over unchanged)
    compaction_threshold: float = 0.5
    dtype: str = "float32"
    #: Russian roulette from this absolute depth on (0 = off)
    russian_roulette_depth: int = 0
    #: next-event estimation (direct light sampling at diffuse hits; a
    #: scene without emissive spheres or quads renders without it)
    nee: bool = False
    #: firefly clamp on per-sample radiance (0 = off)
    firefly_clamp: float = 0.0
    #: thin-lens aperture radius and focus distance in world units (0: a
    #: pinhole, the reference's camera)
    lens_radius: float = 0.0
    focus_distance: float = 10.0
    #: QMC camera sampling: jitter and aperture draws rotate a shared
    #: Halton point per pixel instead of independent uniforms
    qmc: bool = False

    @property
    def pixel_count(self) -> int:
        return self.width * self.height

    @property
    def lens(self) -> Optional[Tuple[float, float]]:
        """(radius, focus_distance), or None for a pinhole camera."""
        if self.lens_radius > 0.0:
            return (self.lens_radius, self.focus_distance)
        return None

    def replace(self, **kw) -> "RenderConfig":
        """A copy with the fields of `kw` changed (the viewer's preview
        configuration)."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DisplayConfig:
    """Tonemap/display settings (reference Film::UpdateDisplay defaults,
    src/core/film.h:33-34)."""

    exposure: float = 1.0
    gamma: float = 2.2
