"""Gather / dispersion artifact persistence (npz round-trip; a copy of
``das_diff_veh_tpu/io/artifacts.py``, so either package reads the other's
files).

Schema-compatible with the reference so archives interchange both ways:

- virtual shot gathers: ``XCF_out`` (nch, wlen), ``x_axis`` (offsets, m),
  ``t_axis`` (lags, s) — VirtualShotGather.save_to_npz /
  get_VirtualShotGather_obj, apis/virtual_shot_gather.py:212-217,231-232;
- dispersion maps: ``freqs``, ``vels``, ``fv_map`` — Dispersion.save_to_npz
  / get_dispersion_obj, modules/utils.py:394-402.

Plus one capability the reference lacks: ``save_window_gathers`` persists a
whole *per-window* gather batch, so bootstrap resampling and per-class
stacking (which are linear in the per-window gathers) can run across
sessions on precomputed gathers instead of recomputing every correlation
(the reference recomputes every gather every bootstrap rep,
apis/imaging_classes.py:31-36).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class GatherArtifact(NamedTuple):
    xcf: np.ndarray        # (nch, wlen)
    offsets: np.ndarray    # (nch,) offsets re-zeroed at the pivot [m]
    lags: np.ndarray       # (wlen,) zero-lag-centered lag axis [s]


class DispersionArtifact(NamedTuple):
    fv_map: np.ndarray     # (nvel, nfreq)
    freqs: np.ndarray
    vels: np.ndarray


class WindowGathersArtifact(NamedTuple):
    gathers: np.ndarray    # (n_windows, nch, wlen) per-window VSGs
    valid: np.ndarray      # (n_windows,) bool
    offsets: np.ndarray    # (nch,)
    lags: np.ndarray       # (wlen,)


def save_gather_npz(path: str, xcf, offsets, lags, **extra) -> None:
    """Reference VirtualShotGather schema (XCF_out / x_axis / t_axis)."""
    np.savez(path, XCF_out=np.asarray(xcf), x_axis=np.asarray(offsets),
             t_axis=np.asarray(lags), **extra)


def load_gather_npz(path: str) -> GatherArtifact:
    f = np.load(path, allow_pickle=True)
    return GatherArtifact(xcf=f["XCF_out"], offsets=f["x_axis"],
                          lags=f["t_axis"])


def save_dispersion_npz(path: str, fv_map, freqs, vels) -> None:
    """Reference Dispersion schema (freqs / vels / fv_map)."""
    np.savez(path, freqs=np.asarray(freqs), vels=np.asarray(vels),
             fv_map=np.asarray(fv_map))


def load_dispersion_npz(path: str) -> DispersionArtifact:
    f = np.load(path)
    return DispersionArtifact(fv_map=f["fv_map"], freqs=f["freqs"],
                              vels=f["vels"])


def save_window_gathers(path: str, gathers, valid, offsets, lags,
                        **extra) -> None:
    """Per-window gather batch for cross-session bootstrap/classing."""
    np.savez_compressed(path, gathers=np.asarray(gathers),
                        valid=np.asarray(valid), x_axis=np.asarray(offsets),
                        t_axis=np.asarray(lags), **extra)


def load_window_gathers(path: str) -> WindowGathersArtifact:
    f = np.load(path, allow_pickle=True)
    return WindowGathersArtifact(gathers=f["gathers"], valid=f["valid"],
                                 offsets=f["x_axis"], lags=f["t_axis"])
