"""rank_skew_pct: the slowest rank's device busy time a frame (the
collectives left out) over the mean of the ranks', less 1, in %: the px
split's imbalance (parallel/sharding.py); None on one rank."""


def read(r):
    return r.rank_skew_pct()
