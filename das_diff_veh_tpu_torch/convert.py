"""Carry a configuration and a record across from the JAX package.

The system has no weights: the configuration and the data take their place.
``config_from_dict`` takes ``dataclasses.asdict`` of a JAX
``PipelineConfig`` as a plain dict (so this module never imports the JAX
package) and returns the port's :class:`PipelineConfig`.
"""

from __future__ import annotations

import numpy as np
import torch

from das_diff_veh_tpu_torch import config as C
from das_diff_veh_tpu_torch.core.section import DasSection
from das_diff_veh_tpu_torch.device import resolve_device

_SUB = {
    "interrogator": C.InterrogatorConfig,
    "track_qc": C.TrackQCConfig,
    "tracking_preprocess": C.TrackingPreprocessConfig,
    "sw_preprocess": C.SurfaceWavePreprocessConfig,
    "window": C.WindowConfig,
    "mute": C.MuteConfig,
    "gather": C.GatherConfig,
    "dispersion": C.DispersionConfig,
    "imaging": C.ImagingConfig,
    "health": C.HealthConfig,
}


def config_from_dict(d: dict) -> C.PipelineConfig:
    """The port's configuration from ``dataclasses.asdict(jax_config)``.

    Copies the main-path sub-configurations field for field, ``health``
    included (a field the port lacks is a ``TypeError``, so drift shows),
    and ``chunk_pipeline`` ("staged" or "fused"; another value is a
    ``ValueError``).  It ignores ``bootstrap`` and ``fleet``, which the
    per-chunk path never reads."""
    chunk_pipeline = d.get("chunk_pipeline", "staged")
    if chunk_pipeline not in ("staged", "fused"):
        raise ValueError(f"chunk_pipeline must be 'staged' or 'fused', got {chunk_pipeline!r}")
    kw = {name: cls(**d[name]) for name, cls in _SUB.items() if name in d}
    if "tracking" in d:
        tr = dict(d["tracking"])
        tr["detect"] = C.DetectConfig(**tr["detect"])
        kw["tracking"] = C.TrackingConfig(**tr)
    if "max_windows" in d:
        kw["max_windows"] = int(d["max_windows"])
    return C.PipelineConfig(chunk_pipeline=chunk_pipeline, **kw)


def section_from_numpy(data: np.ndarray, x: np.ndarray, t: np.ndarray,
                       device=None) -> DasSection:
    """A :class:`DasSection` of ``data`` on ``device`` (``None`` = the card)
    in ``data``'s own dtype, with the axes as host float64 tensors."""
    return DasSection(torch.as_tensor(np.asarray(data), device=resolve_device(device)),
                      torch.as_tensor(np.asarray(x, dtype=np.float64)),
                      torch.as_tensor(np.asarray(t, dtype=np.float64)))
