"""Synthetic workloads: the counterpart of ``das_diff_veh_tpu/workloads.py``
(``make_ambient_record``) for the all-pairs ambient-noise path."""

from __future__ import annotations

import numpy as np
import torch

from das_diff_veh_tpu_torch.device import resolve_device


def make_ambient_record(nch: int, nt: int, seed: int = 0, dtype=np.float32,
                        device=None) -> torch.Tensor:
    """(nch, nt) white Gaussian noise on ``device`` (``None`` = the card):
    the synthetic ambient-noise record of BASELINE config 4 (10k channels at
    1 kHz).  The samples are drawn with numpy from ``seed`` exactly as the
    JAX package draws them, so both packages get byte-identical records."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((nch, nt)).astype(dtype)).to(dev)
