"""trace_kernel_ms: device ms a frame of the trace kernel
(ops/trace.py -> csrc/trace.cu), the mean over the ranks."""


def read(r):
    return r.per_frame_ms("trace kernel")
