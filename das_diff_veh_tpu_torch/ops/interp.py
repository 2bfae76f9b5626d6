"""Masked 1-D linear interpolation with end-segment extrapolation.

Mirrors ``das_diff_veh_tpu/ops/interp.py``.  Trajectories are NaN-padded to
fixed shapes, so invalid knots are pushed to +BIG, a stable sort compacts the
valid knots to the front, and queries interpolate/extrapolate on the valid
run only.  Knots carry leading batch dimensions ``(..., n)``; queries are
``(..., m)`` or a shared ``(m,)``.  Indices are clamped the way a JAX gather
clamps them.
"""

from __future__ import annotations

import torch

_BIG = 1e30


def _sorted_knots(xs, ys, valid):
    xs_f = torch.where(valid, xs, _BIG)
    order = torch.argsort(xs_f, dim=-1, stable=True)
    xs_s = torch.gather(xs_f, -1, order)
    ys_s = torch.gather(torch.where(valid, ys, 0.0), -1, order)
    return xs_s, ys_s, valid.sum(-1)


def _take(v, idx):
    return torch.gather(v, -1, idx.clamp(0, v.shape[-1] - 1))


def _queries(xq, xs_s):
    dtype = torch.promote_types(xq.dtype, xs_s.dtype)
    xq = xq.to(dtype).expand(*xs_s.shape[:-1], xq.shape[-1]).contiguous()
    return xq, xs_s.to(dtype).contiguous()


def masked_interp(xq: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation of ``(xs, ys)`` knots at ``xq``.

    ``valid`` masks live knots; valid ``xs`` must be strictly increasing.
    Queries outside the valid span extrapolate linearly from the first/last
    valid segment.  One valid knot returns its ``y``; none returns zeros."""
    xs_s, ys_s, n_valid = _sorted_knots(xs, ys, valid)
    xq, xs_q = _queries(xq, xs_s)
    last_seg = (n_valid - 2).clamp(min=0)[..., None]
    i = torch.searchsorted(xs_q, xq, right=True) - 1
    i = torch.minimum(i.clamp(min=0), last_seg)
    x0 = _take(xs_s, i)
    x1 = _take(xs_s, i + 1)
    dx = x1 - x0
    w = (xq - x0) / torch.where((dx > 0) & (dx < _BIG / 2), dx, 1.0)
    w = torch.where((n_valid >= 2)[..., None] & (x1 < _BIG / 2), w, 0.0)
    y0 = _take(ys_s, i)
    return y0 + w * (_take(ys_s, i + 1) - y0)


def masked_interp_clamped(xq: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Like :func:`masked_interp` but with ``np.interp`` edge semantics:
    queries outside the valid span return the first/last valid ``y``."""
    xs_s, ys_s, n_valid = _sorted_knots(xs, ys, valid)
    last = (n_valid - 1).clamp(min=0)[..., None]
    lo = xs_s[..., :1]
    hi = _take(xs_s, last)
    y_lo = ys_s[..., :1]
    y_hi = _take(ys_s, last)
    mid = masked_interp(xq, xs, ys, valid)
    return torch.where(xq <= lo, y_lo, torch.where(xq >= hi, y_hi, mid))
