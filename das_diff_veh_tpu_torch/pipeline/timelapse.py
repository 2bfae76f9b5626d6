"""Per-chunk processing: one DAS time window -> tracked vehicles -> selected
surface-wave windows -> stacked dispersion image (and, for ``method=
"xcorr"``, the stacked virtual shot gather).

Mirrors ``das_diff_veh_tpu/pipeline/timelapse.py`` for both methods: the
staged path here, the fused one in ``pipeline.fused``.  ``process_chunk`` runs on the card unless the caller passes
``device="cpu"``; it turns TF32 off first (``device.resolve_device``).  The
computation follows the section's dtype: float32 on the card, float64 in the
CPU parity tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from das_diff_veh_tpu_torch.config import PipelineConfig
from das_diff_veh_tpu_torch.core.section import (DasSection, VehicleTracks,
                                                 WindowBatch)
from das_diff_veh_tpu_torch.device import resolve_device
from das_diff_veh_tpu_torch.models import vsg as V
from das_diff_veh_tpu_torch.models.tracking import track_grid, track_section
from das_diff_veh_tpu_torch.models.windows import (mute_along_traj, select_windows,
                                                   window_x_slice)
from das_diff_veh_tpu_torch.ops.dispersion import fv_map_fk, fv_map_phase_shift
from das_diff_veh_tpu_torch.pipeline.preprocess import (channels_to_distance,
                                                        preprocess_for_surface_waves,
                                                        preprocess_for_tracking)
from das_diff_veh_tpu_torch.resilience.health import (ChannelHealth, PoisonedChunkError,
                                                      screen_section)


@dataclass
class ChunkResult:
    """One processed chunk: stacked image + provenance."""

    disp_image: torch.Tensor          # (nvel, nfreq)
    vsg_stack: Optional[torch.Tensor]  # (nch_out, wlen) for method="xcorr"
    n_windows: Union[int, torch.Tensor]  # accepted (isolated) vehicle windows: an
                                         # int (staged), a 0-d device tensor (fused)
    tracks: VehicleTracks
    batch: WindowBatch                # surface-wave-band windows
    qs_batch: Optional[WindowBatch]   # raw-band windows (with_qs=True only)
    health: Optional[ChannelHealth] = None   # the screen's verdict when
                                             # cfg.health.enabled, else None


def resolve_chunk_metadata(section: DasSection, cfg: PipelineConfig,
                           x_is_channels: bool = False):
    """``(x_dist, t, dt)`` as host numpy from the section's axis metadata."""
    x = np.asarray(section.x.cpu())
    x_dist = channels_to_distance(x, cfg.interrogator) if x_is_channels else x
    t = np.asarray(section.t.cpu())
    return x_dist, t, float(t[1] - t[0])


def disp_image_batch(batch: WindowBatch, cfg: PipelineConfig,
                     x: Optional[np.ndarray] = None,
                     dt: Optional[float] = None) -> torch.Tensor:
    """Direct per-window dispersion images with muting, all window slots at
    once: mute each window along its vehicle's trajectory, then transform
    the muted window over the imaging offset range ``[x0 + disp_start_x,
    x0 + disp_end_x)``.  Returns (max_windows, nvel, nfreq).

    ``x``/``dt``: host copies of the batch's window x axis and sample
    interval (read from ``batch`` when omitted).  As in the JAX package the
    per-window transforms run the ``"f32"`` tier whatever
    ``cfg.dispersion.precision`` says."""
    dcfg = cfg.dispersion
    dx = cfg.interrogator.dx
    x = np.asarray(batch.x.cpu() if x is None else x)
    sxi = int(np.argmax(x >= cfg.imaging.x0 + cfg.imaging.disp_start_x))
    nx = int((cfg.imaging.disp_end_x - cfg.imaging.disp_start_x) / dx)
    dt = float(batch.t[0, 1] - batch.t[0, 0]) if dt is None else float(dt)
    muted = mute_along_traj(batch.data, batch.x, batch.t, batch.traj_x, batch.traj_t,
                            torch.isfinite(batch.traj_t), dx, cfg.mute)
    sliced = muted[:, sxi:sxi + nx]
    if dcfg.method == "phase_shift":
        return fv_map_phase_shift(sliced, dx, dt, dcfg.freqs(), dcfg.vels(),
                                  direction=-1.0, whiten=False)
    return fv_map_fk(sliced, dx, dt, dcfg.freqs(), dcfg.vels(), norm=dcfg.norm,
                     sg_window=dcfg.sg_window, sg_order=dcfg.sg_order)


def chunk_body(data: torch.Tensor, x_dist: np.ndarray, t: np.ndarray,
               dt: float, cfg: PipelineConfig, method: str = "xcorr",
               with_qs: bool = False):
    """Preprocess both bands -> track -> select windows -> the method's
    stacked image: ``"xcorr"`` stacks the virtual shot gathers and images
    the stack, ``"surface_wave"`` images each muted window and stacks the
    images.  ``x_dist``/``t`` are host numpy; every slice bound resolves from
    them.  Returns ``(img, vsg_stack, n_windows, tracks, batch, qs_batch)``
    with ``n_windows`` a device scalar and ``vsg_stack`` None for
    ``"surface_wave"``."""
    d_sw = preprocess_for_surface_waves(data, dt, cfg.sw_preprocess,
                                        normalize=(method == "surface_wave"))
    d_track, x_track, t_stride = preprocess_for_tracking(
        data, x_dist, dt, cfg.tracking_preprocess, dx=cfg.interrogator.dx)
    t_track = t[::t_stride]

    # amplitude negated: deflection pulses become positive peaks
    tracks = track_section(-d_track, x_track, t_track,
                           cfg.imaging.start_x, cfg.imaging.end_x,
                           cfg.tracking, cfg.track_qc)
    tgrid = track_grid(x_track, cfg.imaging.start_x, cfg.imaging.end_x)

    batch = select_windows(d_sw, x_dist, t, tracks, cfg.imaging.x0,
                           cfg.window, track_x=tgrid, track_t=t_track)
    qs_batch = (select_windows(data, x_dist, t, tracks, cfg.imaging.x0,
                               cfg.window, track_x=tgrid, track_t=t_track)
                if with_qs else None)

    n_windows = batch.valid.sum()
    x_win = window_x_slice(x_dist, cfg.imaging.x0, cfg.window)
    if method == "surface_wave":
        img = V.stack_gathers(disp_image_batch(batch, cfg, x=x_win, dt=dt), batch.valid)
        return img, None, n_windows, tracks, batch, qs_batch
    g = V.VsgGeometry.build(x_win, dt, cfg.imaging.x0,
                            cfg.imaging.x0 + cfg.imaging.disp_start_x,
                            cfg.imaging.x0 + cfg.gather.far_offset, cfg.gather)
    stack = V.stack_gathers(V.build_gather_batch(batch, g, cfg.gather), batch.valid)
    img = V.gather_disp_image(stack, g.offsets(x_win), dt, cfg.interrogator.dx,
                              cfg.dispersion, cfg.imaging.disp_start_x,
                              cfg.imaging.disp_end_x)
    return img, stack, n_windows, tracks, batch, qs_batch


def screen_chunk(section: DasSection, cfg: PipelineConfig, tag: str):
    """Input-health sentinel (``resilience.health``) on the section's
    device.  Off by default: one attribute check and no device work (the
    per-tag counter ``SCREENS_BY_TAG`` shows it).  Returns ``(section,
    health-or-None)``; raises ``PoisonedChunkError`` on a failing verdict."""
    if not cfg.health.enabled:
        return section, None
    section, health = screen_section(section, cfg.health, tag=tag)
    if not health.ok(cfg.health):
        raise PoisonedChunkError(health)
    return section, health


def process_chunk(section: DasSection, cfg: Optional[PipelineConfig] = None,
                  method: str = "xcorr", x_is_channels: bool = False,
                  with_qs: bool = False, device=None) -> ChunkResult:
    """Full per-chunk pipeline on ``device`` (``None`` = the card; raises
    without one): preprocess both bands, track, select windows around
    ``cfg.imaging.x0``, build the stacked virtual shot gather and its
    dispersion image.  ``section.data`` is moved to ``device`` and keeps its
    dtype.

    ``method``: ``"xcorr"`` (virtual shot gathers -> dispersion image of
    the stack) or ``"surface_wave"`` (muted direct dispersion image per
    window, averaged over the valid windows).  With ``cfg.health.enabled``
    the input-health sentinel screens the data on ``device`` first
    (``ChunkResult.health``; ``PoisonedChunkError`` past
    ``max_masked_fraction``).

    ``cfg.chunk_pipeline``: ``"staged"`` (this body: eager stages, host
    geometry between them, ``n_windows`` pulled to a Python int) or
    ``"fused"`` (``pipeline.fused.fused_process_chunk``: one CUDA graph
    replay per chunk, ``n_windows`` a 0-d device tensor).  Any other value
    raises before the data is touched."""
    if method not in {"xcorr", "surface_wave"}:
        raise ValueError(f"method must be 'xcorr' or 'surface_wave', got {method!r}")
    cfg = cfg if cfg is not None else PipelineConfig()
    if cfg.chunk_pipeline not in {"staged", "fused"}:
        raise ValueError(f"chunk_pipeline must be 'staged' or 'fused', got "
                         f"{cfg.chunk_pipeline!r}")
    if cfg.chunk_pipeline == "fused":
        from das_diff_veh_tpu_torch.pipeline.fused import fused_process_chunk
        return fused_process_chunk(section, cfg, method=method, x_is_channels=x_is_channels,
                                   with_qs=with_qs, tag="process_chunk", device=device)
    dev = resolve_device(device)
    section, health = screen_chunk(section.to(dev), cfg, tag="process_chunk")
    x_dist, t, dt = resolve_chunk_metadata(section, cfg, x_is_channels)
    img, vsg_stack, n_windows, tracks, batch, qs_batch = chunk_body(
        section.data, x_dist, t, dt, cfg, method=method, with_qs=with_qs)
    return ChunkResult(disp_image=img, vsg_stack=vsg_stack,
                       n_windows=int(n_windows), tracks=tracks,
                       batch=batch, qs_batch=qs_batch, health=health)
