"""stream_segment_ms: device ms a frame of the segment kernel's stream
route instantiations (ops/segment.py with stream tables ->
csrc/segment.cu, kTriStream), the mean over the ranks; None where no
such launch ran."""


def read(r):
    return r.per_frame_ms("stream route")
