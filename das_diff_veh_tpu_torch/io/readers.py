"""DAS data readers and dataset iteration (host side).

A copy of ``das_diff_veh_tpu/io/readers.py``: the npz reader with its
channel-range and taper cut, format dispatch and multi-file time
concatenation, and the per-date directory iterator.  Files are read with
numpy and scipy as in the JAX package; a :class:`DasSection` from these
readers carries its data as a CPU tensor in the file's dtype (float64 for
the reference npz files, float32 for SEG-Y) and its axes as CPU float64
tensors.  The batch workflow stages the data onto the card
(``pipeline.workflow``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import datetime
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from das_diff_veh_tpu_torch.core.section import DasSection
from das_diff_veh_tpu_torch.io import segy as _segy
from das_diff_veh_tpu_torch.resilience import faults


def _section(data: np.ndarray, x: np.ndarray, t: np.ndarray) -> DasSection:
    return DasSection(torch.from_numpy(np.ascontiguousarray(data)),
                      torch.from_numpy(np.asarray(x, dtype=np.float64)),
                      torch.from_numpy(np.asarray(t, dtype=np.float64)))


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _cut_symmetric_taper(data: np.ndarray, t: np.ndarray):
    """Drop the pre-zero taper pad on both ends (reference: modules/utils.py:87-92).

    Files store a symmetric taper region; its length is where |t| is minimal.
    """
    nt = data.shape[-1]
    pad = int(np.argmin(np.abs(t)))
    return data[:, pad:nt - pad], t[pad:nt - pad]


def read_npz_section(path: str, ch1: Optional[float] = None, ch2: Optional[float] = None,
                     cut_taper: bool = True) -> DasSection:
    """Load one npz file with ``data``/``x_axis``/``t_axis`` keys
    (reference key layout: modules/utils.py:94-113)."""
    # chaos sites (no-ops unless an injector is installed): a read failure,
    # a slow read, and post-decode data corruption — keyed by basename so a
    # retried chunk deterministically refires its planned fault
    key = os.path.basename(path)
    faults.fire("io.slow", key)
    faults.fire("io.read", key)
    with np.load(path) as f:
        data, x, t = f["data"], f["x_axis"], f["t_axis"]
    if ch1 is not None and not np.any(x >= ch1):
        raise ValueError(f"ch1={ch1} beyond channel axis [{x[0]}, {x[-1]}] in {path}")
    lo = 0 if ch1 is None else int(np.argmax(x >= ch1))
    hi = len(x) if (ch2 is None or not np.any(x >= ch2)) else int(np.argmax(x >= ch2))
    data, x = data[lo:hi], x[lo:hi]
    if cut_taper:
        data, t = _cut_symmetric_taper(data, t)
    # corruption fires on the post-cut waterfall: planned channel indices
    # (and fraction draws) refer to the channels the pipeline actually sees,
    # so a counted injection can never be sliced away by ch1/ch2
    data = faults.corrupt("io.corrupt", key, data)
    return _section(data, x, t)


def read_segy_section(path: str, ch1: int = 0, ch2: Optional[int] = None,
                      **_ignored) -> DasSection:
    """Load a SEG-Y file via the built-in parser (segyio-free;
    reference behavior: modules/utils.py:72-85).  ``ch1``/``ch2`` are trace
    indices; npz-only kwargs (e.g. cut_taper) are accepted and ignored so
    mixed-format lists work through ``read_sections``."""
    data, dt, ns = _segy.read_segy(path, ch1=int(ch1), ch2=None if ch2 is None else int(ch2))
    nch = data.shape[0]
    return _section(data, np.arange(ch1, ch1 + nch, dtype=np.float64), np.arange(ns) * dt)


_READERS = {".npz": read_npz_section, ".segy": read_segy_section, ".sgy": read_segy_section}


def read_sections(paths: Sequence[str], **kwargs) -> DasSection:
    """Read several files and concatenate along time with accumulated shift
    (reference: modules/utils.py:136-166)."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    datas, ts, t_shift, x = [], [], 0.0, None
    for p in paths:
        reader = _READERS[os.path.splitext(p)[-1].lower()]
        sec = reader(p, **kwargs)
        t = sec.t.numpy()
        datas.append(sec.data)
        ts.append(t + t_shift)
        t_shift += t.shape[0] * (t[1] - t[0])
        x = sec.x
    return DasSection(torch.cat(datas, dim=-1), x, torch.from_numpy(np.concatenate(ts)))


def read_csv_section(data_dir: str, name: str) -> DasSection:
    """Load the ``<name>.csv`` / ``<name>_x_axis.csv`` / ``<name>_t_axis.csv``
    triplet used by the older tracking path (reference:
    modules/car_tracking_utils.py:13-18 — space-delimited data matrix plus
    one-column axis files; whitespace splitting so aligned/padded columns
    read identically)."""
    base = os.path.join(data_dir, name)
    x = np.atleast_1d(np.genfromtxt(base + "_x_axis.csv", dtype=np.float64))
    t = np.atleast_1d(np.genfromtxt(base + "_t_axis.csv", dtype=np.float64))
    data = np.genfromtxt(base + ".csv", dtype=np.float64)
    if data.ndim < 2 and data.size == x.size * t.size:
        data = data.reshape(x.size, t.size)
    data = np.atleast_2d(data)
    if data.shape != (x.size, t.size):
        raise ValueError(f"csv triplet {base}: data {data.shape} does not match "
                         f"axes ({x.size} channels, {t.size} samples)")
    return _section(data, x, t)


def parse_time_from_filename(path: str, fmt: str = "%Y%m%d_%H%M%S") -> datetime:
    """Parse the acquisition timestamp from a file name
    (reference: modules/imaging_IO.py:17-20)."""
    return datetime.strptime(os.path.basename(path).split(".")[0], fmt)


@dataclass
class DirectoryDataset:
    """Sorted iterator over the npz time-window files of one date folder
    (reference: modules/imaging_IO.py:23-54).

    The reference hardcodes a Savitzky-Golay pre-smooth (21,15) and a magic
    amplitude rescale ``6463.81735715902`` for dates > '20230219'
    (modules/imaging_IO.py:41-46); both are explicit knobs here, and both
    run on the host in numpy and scipy, as in the JAX package.
    """

    directory: str
    root: str = "."
    ch1: float = 400
    ch2: float = 540
    smoothing: bool = True
    sg_window: int = 21
    sg_order: int = 15
    rescale_after: Optional[str] = "20230219"
    rescale_value: float = 6463.81735715902

    def __post_init__(self):
        folder = os.path.join(self.root, self.directory)
        files = [os.path.join(folder, f) for f in os.listdir(folder) if f.endswith(".npz")]
        files.sort(key=os.path.basename)
        self.files = files

    def time_interval(self) -> float:
        """Seconds between consecutive files (reference: modules/imaging_IO.py:31-35)."""
        if len(self.files) < 2:
            raise ValueError(
                f"need >= 2 npz files in {os.path.join(self.root, self.directory)} "
                f"to infer the window interval (found {len(self.files)})")
        a = parse_time_from_filename(self.files[0])
        b = parse_time_from_filename(self.files[1])
        return (b - a).total_seconds()

    def __len__(self) -> int:
        return len(self.files)

    def read(self, idx: int) -> DasSection:
        """Raw host I/O stage: npz load + channel cut + taper cut.

        Split from :meth:`preprocess` so the batch runtime can trace (and
        overlap) the two host stages separately.
        """
        return read_npz_section(self.files[idx], ch1=self.ch1, ch2=self.ch2)

    def preprocess(self, sec: DasSection, idx: int) -> DasSection:
        """Host preprocessing stage: savgol pre-smooth + date rescale."""
        path = self.files[idx]
        data = sec.data.numpy()
        if self.smoothing:
            from scipy.signal import savgol_filter
            data = savgol_filter(data, self.sg_window, self.sg_order)
        if self.rescale_after is not None:
            date = os.path.basename(os.path.dirname(path))
            if date > self.rescale_after:
                data = data / self.rescale_value
        return DasSection(torch.from_numpy(np.ascontiguousarray(data)), sec.x, sec.t)

    def __getitem__(self, idx: int) -> DasSection:
        return self.preprocess(self.read(idx), idx)

    def __iter__(self) -> Iterator[DasSection]:
        for i in range(len(self)):
            yield self[i]


def save_section_npz(path: str, section: DasSection) -> None:
    """Write the reference npz layout so files round-trip between frameworks."""
    np.savez(path, data=_host(section.data), x_axis=_host(section.x), t_axis=_host(section.t))
