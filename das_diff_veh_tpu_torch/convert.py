"""Carry a configuration, a record and inversion state across from the JAX
package.

The system has no weights: the configuration and the data take their place.
``config_from_dict`` takes ``dataclasses.asdict`` of a JAX
``PipelineConfig`` as a plain dict (so this module never imports the JAX
package) and returns the port's :class:`PipelineConfig`.  The inversion's
state crosses as numpy: a layered model's fields
(:func:`layered_model_from_numpy`), a search space's bounds
(:func:`model_spec_from_bounds`) and a fleet result's arrays
(:func:`fleet_result_from_numpy`).
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
    "fleet": C.FleetInversionConfig,
}


def config_from_dict(d: dict) -> C.PipelineConfig:
    """The port's configuration from ``dataclasses.asdict(jax_config)``.

    Copies every sub-configuration field for field, ``health``,
    ``bootstrap`` and ``fleet`` included (a field the port lacks is a
    ``TypeError``, so drift shows), and ``chunk_pipeline`` ("staged" or
    "fused"; another value is a ``ValueError``).  The bootstrap's per-band
    sequences become tuples (a JSON round trip gives lists).  The all-pairs
    ring's knobs are not part of ``PipelineConfig``:
    :func:`ring_config_from_dict` carries them."""
    chunk_pipeline = d.get("chunk_pipeline", "staged")
    if chunk_pipeline not in ("staged", "fused"):
        raise ValueError(f"chunk_pipeline must be 'staged' or 'fused', got {chunk_pipeline!r}")
    kw = {name: cls(**d[name]) for name, cls in _SUB.items() if name in d}
    if "tracking" in d:
        tr = dict(d["tracking"])
        tr["detect"] = C.DetectConfig(**tr["detect"])
        kw["tracking"] = C.TrackingConfig(**tr)
    if "bootstrap" in d:
        kw["bootstrap"] = C.BootstrapConfig(**{
            k: tuple(v) if isinstance(v, (list, tuple)) else v
            for k, v in d["bootstrap"].items()})
    if "max_windows" in d:
        kw["max_windows"] = int(d["max_windows"])
    return C.PipelineConfig(chunk_pipeline=chunk_pipeline, **kw)


def ring_config_from_dict(d: dict) -> C.RingConfig:
    """The port's :class:`RingConfig` from ``dataclasses.asdict`` of a JAX
    ``RingConfig`` (a field the port lacks is a ``TypeError``)."""
    return C.RingConfig(**d)


def section_from_numpy(data: np.ndarray, x: np.ndarray, t: np.ndarray,
                       device=None) -> DasSection:
    """A :class:`DasSection` of ``data`` on ``device`` (``None`` = the card)
    in ``data``'s own dtype, with the axes as host float64 tensors."""
    return DasSection(torch.as_tensor(np.asarray(data), device=resolve_device(device)),
                      torch.as_tensor(np.asarray(x, dtype=np.float64)),
                      torch.as_tensor(np.asarray(t, dtype=np.float64)))


def layered_model_from_numpy(thickness, vp, vs, rho, device=None, dtype=torch.float64):
    """The port's :class:`~das_diff_veh_tpu_torch.inversion.forward.LayeredModel`
    on ``device`` (``None`` = the card) from numpy fields (km, km/s, g/cm^3;
    leading batch dimensions allowed)."""
    from das_diff_veh_tpu_torch.inversion.forward import LayeredModel

    dev = resolve_device(device)
    return LayeredModel(*(torch.as_tensor(np.array(a, dtype=np.float64), device=dev)
                          .to(dtype) for a in (thickness, vp, vs, rho)))


def model_spec_from_bounds(thickness, vs, poisson=None):
    """A :class:`~das_diff_veh_tpu_torch.inversion.invert.ModelSpec` with the
    reference's density law from per-layer ``(lo, hi)`` bounds: thickness
    (km), vs (km/s) and Poisson's ratio (``None``: fixed at 0.4375)."""
    from das_diff_veh_tpu_torch.inversion.invert import LayerBounds, ModelSpec

    poisson = poisson if poisson is not None else [(0.4375, 0.4375)] * len(vs)
    return ModelSpec(layers=tuple(
        LayerBounds(tuple(map(float, d)), tuple(map(float, v)), tuple(map(float, nu)))
        for d, v, nu in zip(thickness, vs, poisson)))


def fleet_result_from_numpy(fields: dict):
    """The port's :class:`~das_diff_veh_tpu_torch.inversion.fleet.FleetResult`
    from a dict of its fields as host arrays (``jax_result._asdict()`` after
    ``np.asarray`` of each)."""
    from das_diff_veh_tpu_torch.inversion.fleet import FleetResult

    return FleetResult(**{k: np.asarray(fields[k]) for k in FleetResult._fields})
