"""The floor of a frame's work, and a kernel's share of its roofline.

The floor counts what the cell's inputs need, whatever implements the
kernels, so that a change of tree, layout or kernel cannot move it:

- bytes: each camera ray's inputs read once (origin and direction, 6
  float32, and its pixel id, an int32: 28 B) and its radiance written
  once (3 float32: 12 B), plus the scene as its description holds it
  read once by each card (``reference.RefScene.scene_bytes``);
- operations: the ray segments that the benchmark's own reference traces
  on the same inputs, each with one test against the primitive it hits
  and, where the path scatters, one BSDF sample, and under NEE each
  shadow ray it traces, with its light sample and one test against the
  light's primitive, at the float32 operations ``OPS`` counts in
  ``reference.py``'s arithmetic (a transcendental or a square root as
  one).

Tree nodes, rejected primitives and every re-read are left out, so no
correct implementation can go under the floor, and a share of it cannot
pass 100%.  A share is the floor's time at the published peaks of one
NVIDIA H100 SXM (67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s
of HBM3) over the kernel's measured time; the binding bound is named
beside it.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
#: bytes a camera ray brings (o, d, pixel id) and leaves (radiance)
RAY_BYTES = 28 + 12
#: float32 operations of one test against a primitive of each kind that
#: is hit, and of one scatter, counted in reference.py:
#: sphere: oc 3, b 5, c 6, disc 2, sqrt 1, t 4;
#: quad: d.n 5, o.n 5, 1/d.n 1, t 2, a 13, b 13, a^2 and b^2 2, side 1;
#: triangle: o x d 9, div 6, 1/div 1, t 7, b1 12, b2 12, b1 + b2 1;
#: scatter (a Lambertian bounce, the cheapest): hit point 6, normal 13,
#: direction 11, l = n + u 3, normalise 10, throughput 9;
#: shadow (a quad light, the cheaper kind; adds, multiplies, divisions
#: and square roots, no compare, clamp or select; the light's edge cross
#: product and area left out, a table could hold them): pick 1, the
#: point's a and b 4, to the point 15, dist^2 5, 1 / dist 2, direction 3,
#: cos at the light 5, pdf 2, / lights 1, cos at the surface 5 (43), and
#: the quad test 42.  A sphere light's sample and test count 89.
OPS = {"sphere": 21, "quad": 42, "triangle": 48, "scatter": 52,
       "shadow": 85}


def frame_floor(counts: dict, paths: int, rays_per_frame: int,
                scene_bytes: int, cards: int = 1) -> dict:
    """The floor of one frame: {"ops", "bytes"}.  `counts` are the
    reference's tallies (``reference.new_counts``) over `paths` camera
    rays drawn from the frame's pixels, scaled to `rays_per_frame`;
    every one of `cards` reads the scene once."""
    scale = rays_per_frame / max(paths, 1)
    ops = scale * sum(counts[k] * OPS[k] for k in OPS)
    return {"ops": ops,
            "bytes": rays_per_frame * RAY_BYTES + cards * scene_bytes}


def floor_seconds(floor: dict) -> tuple:
    """(seconds, binding bound) of a floor at the published peaks."""
    t_ops = floor["ops"] / PEAK_FP32_FLOPS
    t_bytes = floor["bytes"] / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
