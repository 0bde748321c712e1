"""Ray generation, RNG streams, table packing and the trace kernel."""
