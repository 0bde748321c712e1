"""The port's instruments: the float32 and memory peaks of the card
(micro.py), the trace kernel's traversal statistics (trace_stats.py) and
the roofline that divides the one by the other (roofline.py)."""
