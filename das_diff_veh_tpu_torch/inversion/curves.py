"""Dispersion-curve containers and their preparation from bootstrap ridges
(a copy of ``das_diff_veh_tpu/inversion/curves.py``, numpy only): the
reference's ``plot_disp_curves`` statistics (modules/utils.py:680-713) and
the period-domain curves of inversion_diff_speed.ipynb cell 5."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class Curve(NamedTuple):
    """One observed modal dispersion curve (period-domain, km/s): the fields
    of ``evodcinv.Curve``.  ``mode`` 0 is fundamental; ``weight`` scales the
    curve's share of the joint misfit; ``uncertainty`` (km/s) normalises the
    residuals (None => 1)."""

    period: np.ndarray
    velocity: np.ndarray
    mode: int
    weight: float = 1.0
    uncertainty: np.ndarray | None = None


def ridge_stats(ridge_vels: np.ndarray):
    """(mean, range, std) over bootstrap repetitions, each (nf,)."""
    v = np.asarray(ridge_vels, dtype=np.float64)
    return v.mean(axis=0), v.max(axis=0) - v.min(axis=0), v.std(axis=0)


def curves_from_ridges(freqs: np.ndarray, freq_lb: Sequence[float], freq_ub: Sequence[float],
                       ridge_vels: Sequence[np.ndarray], band_modes: Sequence[int],
                       weights: Sequence[float] | None = None,
                       skip_bands: Sequence[int] = ()) -> list[Curve]:
    """Period-domain curves from per-band bootstrap ridges: band ``i`` covers
    ``freq_lb[i] <= f < freq_ub[i]``; m/s -> km/s; reversed so periods
    ascend; uncertainty = the bootstrap range, floored at 1e-4 km/s."""
    freqs = np.asarray(freqs, dtype=np.float64)
    weights = list(weights) if weights is not None else [1.0] * len(ridge_vels)
    curves = []
    for i, vels in enumerate(ridge_vels):
        if i in skip_bands:
            continue
        mask = (freqs >= freq_lb[i]) & (freqs < freq_ub[i])
        mean, rng, _ = ridge_stats(vels)
        curves.append(Curve(period=(1.0 / freqs[mask])[::-1], velocity=mean[::-1] / 1000.0,
                            mode=int(band_modes[i]), weight=float(weights[i]),
                            uncertainty=np.maximum(rng[::-1] / 1000.0, 1e-4)))
    return curves


def load_reference_ridge_npz(path: str):
    """Load a ``{x0}_speeds.npz`` / ``{x0}_weights.npz``-layout archive."""
    d = np.load(path, allow_pickle=True)
    return {k: d[k] for k in d.files}
