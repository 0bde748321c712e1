"""Light helpers.

The counterpart of ``parallelraytracing_tpu/core/light.py``.  The
reference has no light objects: a light is an emissive primitive.  These
helpers add one; ``ops/nee.extract_lights`` finds every emissive sphere
and quad of a compiled scene, whether added here or not, for NEE
(``RenderConfig.nee``).
"""

from __future__ import annotations

from parallelraytracing_tpu_torch.core.scene import Scene


def add_sphere_light(scene: Scene, center, radius: float, emission) -> int:
    """Emissive sphere; returns the material id."""
    mat = scene.add_emissive(emission)
    scene.add_sphere(radius, mat, ((1, 1, 1), (0, 0, 0), tuple(center)))
    return mat


def add_quad_light(scene: Scene, width: float, height: float, emission,
                   transform=None) -> int:
    """Emissive quad; returns the material id."""
    mat = scene.add_emissive(emission)
    scene.add_quad(width, height, mat, transform)
    return mat
