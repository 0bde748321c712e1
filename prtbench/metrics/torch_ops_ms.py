"""torch_ops_ms: device ms a frame of every kernel, copy and fill that no
other layer claims (seeds, raygen, the film, the queue re-sort, the
display's tonemap), the mean over the ranks."""


def read(r):
    return r.per_frame_ms("torch ops")
