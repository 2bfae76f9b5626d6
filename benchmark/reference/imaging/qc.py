"""Trace quality control: bad-channel masks, one-shot neighbor imputation,
the reference's single-channel imputation and the loud-channel kill
(mirrors ``das_diff_veh_tpu/ops/qc.py``)."""

from __future__ import annotations

import torch

from .filters import median


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


def impute_first_noisy(data: torch.Tensor, threshold: float = 5.0,
                       empty: bool = False) -> torch.Tensor:
    """Strict reference semantics: impute only the first channel that meets
    the predicate (the argmax of the mask; channel 0 when none does)."""
    if empty:
        mask = torch.linalg.vector_norm(data, dim=-1) < threshold
    else:
        mask = torch.amax(data, dim=-1) > threshold
    idx = int(torch.argmax(mask.to(torch.uint8)))
    nch = data.shape[0]
    prev = data[max(idx - 1, 0)]
    nxt = data[min(idx + 1, nch - 1)]
    repl = nxt if idx == 0 else prev if idx == nch - 1 else prev + nxt
    out = data.clone()
    out[idx] = repl
    return out


def kill_loud_channels(data: torch.Tensor, noise_level: float = 10.0) -> torch.Tensor:
    """Zero out channels whose median |amplitude| exceeds ``noise_level``."""
    loud = median(torch.abs(data), dim=-1) > noise_level
    return torch.where(loud[:, None], 0.0, data)
