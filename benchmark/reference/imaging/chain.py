"""The reference's chunk: read, pre-smooth, screen, preprocess, track,
select windows, gather, stack and image (``xcorr`` method), in float64.

Follows ``io/readers.py`` (npz cut and taper, savgol pre-smooth, date
rescale) and ``pipeline/timelapse.py`` (``screen_chunk`` and ``chunk_body``)
of the port at the commit that added the benchmark.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import vsg as V
from .config import PipelineConfig
from .health import screen_section
from .preprocess import (channels_to_distance, preprocess_for_surface_waves,
                         preprocess_for_tracking)
from .section import DasSection
from .tracking import track_grid, track_section
from .windows import select_windows, window_x_slice


def read_chunk(path: str, ch1: float = 400, ch2: float = 540, smoothing: bool = True,
               sg_window: int = 21, sg_order: int = 15,
               rescale_after: str | None = "20230219",
               rescale_value: float = 6463.81735715902):
    """``(data, x, t)`` host float64 arrays of one npz chunk as the batch
    loader sees them: the channel cut ``[ch1, ch2)``, the symmetric taper cut,
    the Savitzky-Golay pre-smooth and the rescale of dates after
    ``rescale_after`` (the date is the name of the file's folder)."""
    from scipy.signal import savgol_filter

    with np.load(path) as f:
        data, x, t = f["data"], f["x_axis"], f["t_axis"]
    lo = 0 if ch1 is None else int(np.argmax(x >= ch1))
    hi = len(x) if (ch2 is None or not np.any(x >= ch2)) else int(np.argmax(x >= ch2))
    data, x = data[lo:hi], x[lo:hi]
    pad = int(np.argmin(np.abs(t)))
    nt = data.shape[-1]
    data, t = data[:, pad:nt - pad], t[pad:nt - pad]
    if smoothing:
        data = savgol_filter(data, sg_window, sg_order)
    if rescale_after is not None:
        date = os.path.basename(os.path.dirname(path))
        if date > rescale_after:
            data = data / rescale_value
    return (np.asarray(data, np.float64), np.asarray(x, np.float64),
            np.asarray(t, np.float64))


def image_chunk(data, x, t, cfg: PipelineConfig, x_is_channels: bool = True,
                device="cpu", dtype=torch.float64):
    """``(image (nvel, nfreq) float64 numpy, n_windows int)`` of one chunk,
    computed in ``dtype`` on ``device``; ``image`` is None when no window was
    isolated (the batch runtime then skips the chunk)."""
    sec = DasSection(torch.as_tensor(np.asarray(data)).to(device, dtype),
                     torch.as_tensor(np.asarray(x, np.float64)),
                     torch.as_tensor(np.asarray(t, np.float64)))
    if cfg.health.enabled:
        sec, health = screen_section(sec, cfg.health, tag="reference")
        if not health.ok(cfg.health):
            raise ValueError("the reference screen refuses the chunk")
    xh = np.asarray(sec.x.cpu())
    x_dist = channels_to_distance(xh, cfg.interrogator) if x_is_channels else xh
    th = np.asarray(sec.t.cpu())
    dt = float(th[1] - th[0])
    d = sec.data
    d_sw = preprocess_for_surface_waves(d, dt, cfg.sw_preprocess, normalize=False)
    d_track, x_track, t_stride = preprocess_for_tracking(
        d, x_dist, dt, cfg.tracking_preprocess, dx=cfg.interrogator.dx)
    t_track = th[::t_stride]
    tracks = track_section(-d_track, x_track, t_track, cfg.imaging.start_x,
                           cfg.imaging.end_x, cfg.tracking, cfg.track_qc)
    tgrid = track_grid(x_track, cfg.imaging.start_x, cfg.imaging.end_x)
    batch = select_windows(d_sw, x_dist, th, tracks, cfg.imaging.x0, cfg.window,
                           track_x=tgrid, track_t=t_track)
    n = int(batch.valid.sum())
    x_win = window_x_slice(x_dist, cfg.imaging.x0, cfg.window)
    g = V.VsgGeometry.build(x_win, dt, cfg.imaging.x0,
                            cfg.imaging.x0 + cfg.imaging.disp_start_x,
                            cfg.imaging.x0 + cfg.gather.far_offset, cfg.gather)
    stack = V.stack_gathers(V.build_gather_batch(batch, g, cfg.gather), batch.valid)
    img = V.gather_disp_image(stack, g.offsets(x_win), dt, cfg.interrogator.dx,
                              cfg.dispersion, cfg.imaging.disp_start_x,
                              cfg.imaging.disp_end_x)
    return (img.double().cpu().numpy() if n > 0 else None), n
