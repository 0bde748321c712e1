"""gather_ms: collective device ms a display (parallel/sharding.py
gather_film) on the rank that reached it last; None on one rank."""


def read(r):
    return r.gather_ms()
