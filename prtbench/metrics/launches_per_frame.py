"""launches_per_frame: cudaLaunchKernel calls a frame in the profiled
slice (the engine's host side), the mean over the ranks."""


def read(r):
    return r.launches_per_frame()
