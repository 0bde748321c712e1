"""segment_kernel_ms: device ms a frame of the segment kernel's launches
(ops/segment.py -> csrc/segment.cu), the mean over the ranks."""


def read(r):
    return r.per_frame_ms("segment route")
