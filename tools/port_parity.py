#!/usr/bin/env python3
"""CPU report on the PyTorch port's numerics (no card needed).

    JAX_PLATFORMS=cpu python tools/port_parity.py

1. The port's ``process_chunk(method="xcorr")`` in float64 against the JAX
   package's staged chunk under x64, on the test suite's canonical scene
   (``tests/conftest.py``: 100 channels, seed 11, pivot 400 m): peak-relative
   gaps of the image and the stack, and equality of the masks and tracks.
2. The port's float32 chunk against its float64 chunk on the smoke scene of
   ``chip_smoke.py`` (140 channels, seed 2, pivot 700 m), once as shipped
   (window axes float64) and once with the window axes cast to float32, to
   show why the axes stay float64.
3. The im2col buffer a ``conv1d`` over the zero-stuffed record would need on
   the CPU for the tracking band's polyphase resample, from the shapes.

Prints one JSON object.  Imports both packages, like the tests.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["JAX_ENABLE_X64"] = "1"
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)


def peak_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def port_vs_jax() -> dict:
    from das_diff_veh_tpu.config import ImagingConfig, PipelineConfig
    from das_diff_veh_tpu.io.synthetic import SceneConfig, synthesize_section
    from das_diff_veh_tpu.pipeline.timelapse import process_chunk
    from das_diff_veh_tpu_torch.convert import config_from_dict, section_from_numpy
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk as port_chunk

    sec, _ = synthesize_section(SceneConfig(nch=100, duration=120.0, n_vehicles=4,
                                            seed=11, speed_range=(12.0, 18.0)))
    cfg = PipelineConfig().replace(imaging=ImagingConfig(x0=400.0))
    want = process_chunk(sec, cfg, method="xcorr")
    got = port_chunk(section_from_numpy(np.asarray(sec.data), np.asarray(sec.x),
                                        np.asarray(sec.t), device="cpu"),
                     config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    wt, gt = np.asarray(want.tracks.t_idx), got.tracks.t_idx.numpy()
    return {"n_windows": [got.n_windows, want.n_windows],
            "batch_valid_equal": bool(np.array_equal(got.batch.valid.numpy(),
                                                     np.asarray(want.batch.valid))),
            "tracks_t_idx_bit_equal": bool(np.array_equal(gt, wt, equal_nan=True)),
            "image_peak_rel": peak_rel(got.disp_image.numpy(), want.disp_image),
            "vsg_stack_peak_rel": peak_rel(got.vsg_stack.numpy(), want.vsg_stack)}


def float32_vs_float64() -> dict:
    from das_diff_veh_tpu_torch.io.synthetic import SceneConfig, synthesize_section
    from das_diff_veh_tpu_torch.models import windows as W
    from das_diff_veh_tpu_torch.pipeline import timelapse as TL

    sec, _ = synthesize_section(SceneConfig(nch=140, duration=120.0, n_vehicles=6,
                                            seed=2, speed_range=(12.0, 18.0)))
    ref = TL.process_chunk(sec, device="cpu")
    out = {"n_windows_float64": ref.n_windows}
    shipped = W.select_windows

    def float32_axes(data, *args, **kw):
        b = shipped(data, *args, **kw)
        return W.WindowBatch(data=b.data, x=b.x.to(data.dtype), t=b.t.to(data.dtype),
                             traj_x=b.traj_x.to(data.dtype), traj_t=b.traj_t, valid=b.valid)

    for name, select in (("float64_axes", shipped), ("float32_axes", float32_axes)):
        TL.select_windows = select
        try:
            r = TL.process_chunk(sec.to(dtype=torch.float32), device="cpu")
        finally:
            TL.select_windows = shipped
        out[name] = {"n_windows": r.n_windows,
                     "batch_valid_equal": bool(torch.equal(r.batch.valid, ref.batch.valid)),
                     "image_peak_rel": peak_rel(r.disp_image.numpy(), ref.disp_image.numpy()),
                     "vsg_stack_peak_rel": peak_rel(r.vsg_stack.numpy(),
                                                    ref.vsg_stack.numpy())}
    return out


def conv1d_im2col_bytes() -> dict:
    """conv1d of the (time rows, 1, nch*up) zero-stuffed record with the
    (2*10*up+1)-tap filter, stride ``down``: the CPU path unfolds every
    output's taps, rows x taps x outputs float64 values."""
    up, down, rows = 204, 25, 30000 // 5
    taps = 2 * 10 * up + 1
    return {f"nch{nch}": rows * taps * (-(-nch * up // down)) * 8 for nch in (100, 140)}


def main() -> int:
    report = {"port_vs_jax_float64": port_vs_jax(),
              "port_float32_vs_float64": float32_vs_float64(),
              "conv1d_im2col_bytes": conv1d_im2col_bytes()}
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
