"""Acceleration-structure helpers of the port (host, numpy)."""
