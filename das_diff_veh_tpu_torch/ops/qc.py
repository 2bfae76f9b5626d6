"""Trace quality control: bad-channel masks and one-shot neighbor imputation
(mirrors ``das_diff_veh_tpu/ops/qc.py``)."""

from __future__ import annotations

import torch


def noisy_trace_mask(data: torch.Tensor, threshold: float = 5.0) -> torch.Tensor:
    """Channels whose max amplitude exceeds ``threshold``."""
    return torch.amax(data, dim=-1) > threshold


def empty_trace_mask(data: torch.Tensor, threshold: float = 5.0) -> torch.Tensor:
    """Channels whose L2 norm is below ``threshold``."""
    return torch.linalg.vector_norm(data, dim=-1) < threshold


def impute_traces(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace masked channels by the sum of their immediate neighbors (edge
    channels copy the single neighbor), every masked channel at once."""
    up = torch.roll(data, -1, dims=0)
    down = torch.roll(data, 1, dims=0)
    repl = up + down
    repl[0] = up[0]
    repl[-1] = down[-1]
    return torch.where(mask[:, None], repl, data)
