"""Plain reference of the ambient-noise day stack: the noise-correlation
gathers of chosen source channels, following Bensen et al. (2007), in plain
PyTorch (:mod:`.ncf`).  It imports nothing of the program and no JAX; the
benchmark's check and the program's CPU tests load this same file.
"""
