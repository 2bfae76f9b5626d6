"""das_diff_veh_tpu_torch: the PyTorch/CUDA port of ``das_diff_veh_tpu``.

A second package beside the JAX one, with the same layout and module names.
It imports torch, numpy and scipy, never JAX and nothing of the JAX package.
Plain tensor code is PyTorch; the TPU kernels on its path are hand-written
CUDA kernels for Hopper (``csrc/``, built by ``kernels.py``).  Entry points
run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
