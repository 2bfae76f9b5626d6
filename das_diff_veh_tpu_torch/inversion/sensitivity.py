"""Phase-velocity sensitivity kernels (mirrors
``das_diff_veh_tpu/inversion/sensitivity.py``; the role of
``disba.PhaseSensitivity``, inversion_diff_weight.ipynb cells 19-20): the
best model resampled onto uniform fine layers, then dc/dVs per layer as one
batched central difference over all 2n perturbed models in one root solve."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from das_diff_veh_tpu_torch.inversion.forward import LayeredModel, phase_velocity


class SensitivityKernel(NamedTuple):
    depth: np.ndarray    # top depth of each fine layer (km)
    kernel: np.ndarray   # dc/dVs per fine layer (dimensionless)
    period: float
    mode: int


def resample_fine(model: LayeredModel, dz: float = 0.01, zmax: float = 0.3) -> LayeredModel:
    """Uniform ``dz``-thick relayering of a coarse model down to ``zmax``:
    each fine layer takes the coarse layer containing its top; the halfspace
    forms the final entry.  On the model's device."""
    n_fine = int(round(zmax / dz))
    tops = np.arange(n_fine) * dz
    coarse_tops = np.concatenate([[0.0], np.cumsum(model.thickness.detach().cpu().numpy()[:-1])])
    idx = np.searchsorted(coarse_tops, tops + 1e-12, side="right") - 1
    idx = torch.as_tensor(np.clip(idx, 0, len(coarse_tops) - 1), device=model.vs.device)
    take = lambda a: torch.cat([a[idx], a[-1:]])
    thickness = torch.cat([torch.full((n_fine,), dz, dtype=model.thickness.dtype,
                                      device=model.vs.device),
                           model.thickness.new_zeros(1)])
    return LayeredModel(thickness=thickness, vp=take(model.vp), vs=take(model.vs),
                        rho=take(model.rho))


def phase_sensitivity(model: LayeredModel, period: float, mode: int = 0, dz: float = 0.01,
                      zmax: float = 0.3, n_grid: int = 1200, h: float = 1e-3) -> SensitivityKernel:
    """dc/dVs depth kernel at one period (Vs perturbed alone, Vp and rho
    held), as one batched central difference over the fine layers on the
    model's device.  Central differences rather than implicit-function AD:
    fine relayerings make osculating roots where -D_theta/D_c is
    ill-conditioned (see the JAX package)."""
    fine = resample_fine(model, dz=dz, zmax=zmax)
    n = fine.vs.shape[0]
    eye = torch.eye(n, dtype=fine.vs.dtype, device=fine.vs.device)
    vs_pert = torch.cat([fine.vs[None] + h * eye, fine.vs[None] - h * eye], dim=0)
    batch = LayeredModel(fine.thickness.expand(2 * n, n), fine.vp.expand(2 * n, n), vs_pert,
                         fine.rho.expand(2 * n, n))
    with torch.no_grad():
        cs = phase_velocity(np.asarray([period], dtype=np.float64), batch, mode=mode,
                            n_grid=n_grid)[:, 0]
    kern = (cs[:n] - cs[n:]) / (2.0 * h)
    return SensitivityKernel(depth=np.arange(n) * dz, kernel=kern.cpu().numpy(),
                             period=float(period), mode=mode)
