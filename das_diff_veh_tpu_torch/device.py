"""Device resolution shared by the port's entry points.

Entry points take ``device=None``, which means the card.  Without a CUDA
device they raise instead of carrying on on the CPU: the CPU runs only when
the caller asks for it (the parity tests do).

Every entry point also turns TF32 off.  A float32 ``conv1d`` goes through
cuDNN in TF32 by default (``torch.backends.cudnn.allow_tf32``), which keeps
about three decimal digits; the JAX package's float32 tier contracts at
``Precision.HIGHEST``.  Both TF32 switches are set to False explicitly.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def on_device(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays on its own device when ``device`` is
    ``None``; anything else (numpy, lists, or a tensor with an explicit
    ``device``) goes to ``resolve_device(device)``, the card by default.
    ``dtype`` casts when given; numpy float64 stays float64."""
    if isinstance(x, torch.Tensor) and device is None:
        return x if dtype is None else x.to(dtype)
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.array(x), device=dev, dtype=dtype)
