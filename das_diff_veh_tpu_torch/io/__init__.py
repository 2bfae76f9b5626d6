"""Data sources of the port: the npz / SEG-Y readers, the per-date directory
dataset, artifact files and synthetic scenes."""
