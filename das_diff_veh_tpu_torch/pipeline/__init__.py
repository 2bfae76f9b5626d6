"""Per-chunk pipeline of the port."""
