"""Numerical operators of the port: filters, resampling, peaks,
correlation, dispersion, the all-pairs correlation, and the wrappers of the
hand-written kernels (trajectory gather, cross-spectra, lag-axis peak)."""
