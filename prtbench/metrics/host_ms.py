"""host_ms: host ms a frame inside Renderer.progressive_render (the
engine's host side: engines/base.py, fused.py, wavefront_fused.py,
sharded.py), from the harness's span around the call, over the frames
outside the profiled slice and every rank."""


def read(r):
    return r.host_ms()
