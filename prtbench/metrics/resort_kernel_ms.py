"""resort_kernel_ms: device ms a frame of the queue re-sort's kernels
(ops/segment.resort -> csrc/segment.cu's resort_*kernel), the mean over
the ranks; None where no such launch ran."""


def read(r):
    return r.per_frame_ms("queue re-sort")
