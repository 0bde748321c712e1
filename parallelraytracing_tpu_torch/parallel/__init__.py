from parallelraytracing_tpu_torch.parallel.sharding import (
    make_render_mesh, render_frame_sharded)

__all__ = ["make_render_mesh", "render_frame_sharded"]
