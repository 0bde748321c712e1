"""Post-filters of the accumulated film."""
