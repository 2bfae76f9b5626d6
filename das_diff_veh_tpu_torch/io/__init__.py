"""Data sources of the port (synthetic scenes)."""
