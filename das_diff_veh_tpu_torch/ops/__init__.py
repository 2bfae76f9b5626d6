"""Numerical operators of the port: filters, resampling, peaks,
correlation, dispersion, and the trajectory gather kernel's wrapper."""
