"""Sky radiance of an escaping ray (the counterpart of
``parallelraytracing_tpu.ops.sky``).

Three models, chosen by which ``SceneData`` fields are set: the constant
``sky`` alone (the reference's sky), a gradient to ``sky_top`` over the
direction's y, and a sun lobe ``sun_color * max(dot(d_hat, sun_dir),
0)^power`` added to either.  Directions from the BSDFs are not unit
length (a Lambertian scatter is normal + unit vector), so d is normalized
here.  The kernels' miss block (csrc/bounce.cuh, ops/trace.py) computes
the same model from the scene's sky spec.
"""

from __future__ import annotations

import torch

from parallelraytracing_tpu_torch.ops import ieee


def sky_radiance(scene, d: torch.Tensor) -> torch.Tensor:
    """(n, 3) escape radiance of (n, 3) directions `d` under the sky of
    `scene` (a SceneData)."""
    if scene.sky_top is None and scene.sun is None:
        return scene.sky.expand(d.shape)
    inv_len = 1.0 / ieee.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                              + d[:, 2] * d[:, 2])
    if scene.sky_top is not None:
        t = 0.5 * (d[:, 1] * inv_len + 1.0)
        base = scene.sky[None, :] + t[:, None] * (scene.sky_top
                                                  - scene.sky)[None, :]
    else:
        base = scene.sky.expand(d.shape)
    if scene.sun is not None:
        sd, sc, power = scene.sun[0:3], scene.sun[3:6], scene.sun[6]
        cosang = torch.clamp_min((d * sd[None, :]).sum(dim=-1) * inv_len, 0.0)
        base = base + torch.pow(cosang, power)[:, None] * sc[None, :]
    return base
