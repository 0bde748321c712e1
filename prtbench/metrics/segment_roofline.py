"""segment_roofline: the frame's floor (roofline.py) at the published
H100 peaks over the segment kernel's device time a frame on all cards,
in %."""


def read(r):
    return r.roofline_pct("segment route")
