"""Fixed-capacity peak detection (local maxima + distance pruning + prominence).

Mirrors ``das_diff_veh_tpu/ops/peaks.py``, a fixed-shape re-design of
``scipy.signal.find_peaks(prominence=, wlen=, distance=)``, batched over
leading dimensions (one row per channel).  ``lax.top_k`` returns the lower
index first on ties and the sequential distance prune depends on that
priority order; ``torch.topk`` promises no tie order, so candidates come from
a stable descending sort instead.  The prune's ``fori_loop`` is a Python
loop over the ``cap`` ranks.
"""

from __future__ import annotations

import math

import torch

_BIG = 2 ** 30
_ROW_CHUNK = 16        # rows per prominence pass: bounds the (rows, cap, wlen) windows


def local_maxima(trace: torch.Tensor) -> torch.Tensor:
    """Strict interior local maxima mask (x[i-1] < x[i] > x[i+1])."""
    mid = (trace[..., 1:-1] > trace[..., :-2]) & (trace[..., 1:-1] > trace[..., 2:])
    return torch.nn.functional.pad(mid, (1, 1), value=False)


def _distance_prune(pos: torch.Tensor, keep: torch.Tensor, distance: int) -> torch.Tensor:
    """scipy ``_select_by_peak_distance`` on candidates sorted by priority
    (highest first): walking down the ranking, a surviving peak removes every
    other candidate within ``distance`` samples."""
    cap = pos.shape[-1]
    ranks = torch.arange(cap, device=pos.device)
    for r in range(cap):
        close = (torch.abs(pos - pos[..., r:r + 1]) < distance) & (ranks != r)
        keep = torch.where(keep[..., r:r + 1], keep & ~close, keep)
    return keep


def _window_minima(wins: torch.Tensor, half: int):
    """Per-candidate left/right prominence bases from windows centered on
    each candidate (+inf outside the record)."""
    c = half
    center = wins[..., c:c + 1]
    idx = torch.arange(half, device=wins.device)

    def base(side):
        # nearest higher sample (or edge) up to the peak, then the minimum
        # of the stretch from there to the peak
        j_hi = torch.where(side > center, idx, -1).amax(dim=-1)
        smin = torch.cummin(side.flip(-1), dim=-1).values.flip(-1)
        sel = (j_hi + 1).clamp(0, c - 1)
        return torch.gather(smin, -1, sel[..., None])[..., 0]

    return base(wins[..., :c]), base(wins[..., c + 1:].flip(-1))


def _prominence(trace: torch.Tensor, pos: torch.Tensor, vals: torch.Tensor,
                wlen: int) -> torch.Tensor:
    nt = trace.shape[-1]
    half = (wlen if wlen % 2 else wlen + 1) // 2     # scipy rounds wlen up to odd
    offs = torch.arange(-half, half + 1, device=trace.device)
    rows_t = trace.reshape(-1, nt)
    rows_p = pos.reshape(-1, pos.shape[-1])
    out = []
    for i in range(0, rows_t.shape[0], _ROW_CHUNK):
        tr, p = rows_t[i:i + _ROW_CHUNK], rows_p[i:i + _ROW_CHUNK]
        gidx = p[..., None] + offs
        inside = (gidx >= 0) & (gidx < nt)
        g = torch.gather(tr[:, None, :].expand(-1, p.shape[-1], -1), -1,
                         gidx.clamp(0, nt - 1))
        wins = torch.where(inside, g, math.inf)
        left_base, right_base = _window_minima(wins, half)
        out.append(torch.maximum(left_base, right_base))
    return vals - torch.cat(out).reshape(pos.shape)


def find_peaks(trace: torch.Tensor, min_prominence: float = 0.2,
               min_distance: int = 50, wlen: int = 600, max_peaks: int = 64,
               cap: int = 512, use_prominence: bool = True):
    """scipy-compatible peak pick over the last axis; returns (positions
    (..., max_peaks) int32 ascending, valid mask).  Condition order matches
    scipy: distance first, prominence second."""
    nt = trace.shape[-1]
    heights = torch.where(local_maxima(trace), trace, -math.inf)
    cap = min(cap, nt)
    vals, pos = torch.sort(heights, dim=-1, descending=True, stable=True)
    vals, pos = vals[..., :cap], pos[..., :cap]
    keep = vals > -math.inf
    keep = _distance_prune(pos, keep, int(math.ceil(min_distance)))
    if use_prominence:
        keep = keep & (_prominence(trace, pos, vals, wlen) >= min_prominence)
    key = torch.where(keep, pos, _BIG)
    out_pos = torch.sort(key, dim=-1).values[..., :max_peaks]
    valid = out_pos < _BIG
    return torch.where(valid, out_pos, 0).to(torch.int32), valid


def gaussian_likelihood(peak_idx: torch.Tensor, peak_valid: torch.Tensor,
                        t_axis: torch.Tensor, sigma: float) -> torch.Tensor:
    """Sum of normal pdfs centered on peak times, batched over leading dims
    of ``peak_idx`` (..., npk) -> (..., nt)."""
    t0 = t_axis[peak_idx.long()]                               # (..., npk)
    z = (t_axis - t0[..., None]) / sigma
    pdf = torch.exp(-0.5 * z * z) / (sigma * math.sqrt(2.0 * math.pi))
    return torch.sum(torch.where(peak_valid[..., None], pdf, 0.0), dim=-2)
