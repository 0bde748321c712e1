"""device_idle_pct: the share of the profiled slice in which no kernel,
copy or fill ran on the card, in %, from the mean over the ranks of the
busy and window seconds."""


def read(r):
    return r.idle_pct()
