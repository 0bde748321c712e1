"""Texture codes and constants (the counterpart of
``parallelraytracing_tpu.ops.textures``).

``SceneData.mat_tex`` holds one code per material: ``TEX_NONE``, the
procedural 3D checker ``TEX_CHECKER`` (``mat_tex_param`` = [cell scale,
odd rgb]), or an image, ``TEX_IMAGE_BASE`` + its texture id.  The trace
and segment kernels evaluate both kinds (csrc/bounce.cuh, and the plain
versions in ops/trace.py); the JAX package's ``sample_atlas`` and
``textured_albedo`` serve its jnp engines only and come with their port
(ROADMAP Queue 1 item 14).
"""

TEX_NONE = 0
TEX_CHECKER = 1
TEX_IMAGE_BASE = 2

#: the checker lattice's offset (1/pi): cell boundaries land at
#: (k - 0.3183) / scale, so surfaces at common coordinates (a y = 0
#: floor, integer walls) sit mid-cell rather than on a boundary, where the
#: hit point's rounding would flip the parity from pixel to pixel
CHECKER_OFFSET = 0.3183098861
