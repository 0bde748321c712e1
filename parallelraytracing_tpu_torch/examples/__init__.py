"""Example scripts of the port (run each with ``python -m``)."""
