"""Minimal, dependency-free SEG-Y trace reader (numpy only; a copy of
``das_diff_veh_tpu/io/segy.py``).

The reference reads SEG-Y via the external ``segyio`` package
(modules/utils.py:72-85).  That package is not a dependency here; DAS SEG-Y
files are simple enough (uniform traces, no geometry) that a direct parser is
~100 lines: 3200-byte EBCDIC text header, 400-byte binary header, then
fixed-length traces of 240-byte header + ns samples.

Supports data format codes 1 (4-byte IBM float), 2 (int32), 3 (int16),
5 (IEEE float32), 8 (int8) — format 1 and 5 cover every DAS interrogator we
know of.  Assumptions (loud failure otherwise): uniform ns/dt from the
binary header (per-trace header overrides are ignored — DAS interrogators
write uniform traces), non-zero ns and dt; a trailing partial trace is
dropped with only the complete traces returned.
"""

from __future__ import annotations

import numpy as np

_TEXT_HEADER_LEN = 3200
_BIN_HEADER_LEN = 400
_TRACE_HEADER_LEN = 240

# byte offsets (0-based) within the 400-byte binary header
_BIN_DT_OFFSET = 16        # sample interval, microseconds (int16)
_BIN_NS_OFFSET = 20        # samples per trace (int16)
_BIN_FORMAT_OFFSET = 24    # data sample format code (int16)

_SAMPLE_BYTES = {1: 4, 2: 4, 3: 2, 5: 4, 8: 1}


def _ibm_to_float(raw: np.ndarray) -> np.ndarray:
    """Vectorized IBM System/360 hexadecimal float -> IEEE float64."""
    raw = raw.astype(np.uint32)
    sign = np.where(raw >> 31, -1.0, 1.0)
    exponent = ((raw >> 24) & 0x7F).astype(np.int64) - 64
    mantissa = (raw & 0x00FFFFFF).astype(np.float64) / float(1 << 24)
    return sign * mantissa * np.power(16.0, exponent)


def read_segy(path: str, ch1: int = 0, ch2: int | None = None):
    """Read traces [ch1:ch2] from a SEG-Y file.

    Returns ``(data (nch, ns) float32, dt seconds, ns)``.  Mirrors what the
    reference extracts through segyio (modules/utils.py:75-85): raw traces plus
    the sample interval from the binary header in microseconds.
    """
    with open(path, "rb") as f:
        header = f.read(_TEXT_HEADER_LEN + _BIN_HEADER_LEN)
        if len(header) < _TEXT_HEADER_LEN + _BIN_HEADER_LEN:
            raise ValueError(f"truncated SEG-Y file (no binary header): {path}")
        binh = header[_TEXT_HEADER_LEN:]
        dt_us = int.from_bytes(binh[_BIN_DT_OFFSET:_BIN_DT_OFFSET + 2], "big", signed=False)
        ns = int.from_bytes(binh[_BIN_NS_OFFSET:_BIN_NS_OFFSET + 2], "big", signed=False)
        fmt = int.from_bytes(binh[_BIN_FORMAT_OFFSET:_BIN_FORMAT_OFFSET + 2], "big", signed=False)
        if fmt not in _SAMPLE_BYTES:
            raise ValueError(f"unsupported SEG-Y format code {fmt} in {path}")
        if ns == 0:
            raise ValueError(f"SEG-Y binary header declares 0 samples/trace: {path}")
        if dt_us == 0:
            raise ValueError(f"SEG-Y binary header declares 0 us sample interval"
                             f" (dt unrecoverable): {path}")
        sample_bytes = _SAMPLE_BYTES[fmt]
        trace_len = _TRACE_HEADER_LEN + ns * sample_bytes

        f.seek(0, 2)
        file_len = f.tell()
        ntraces = (file_len - _TEXT_HEADER_LEN - _BIN_HEADER_LEN) // trace_len
        if ch2 is None:
            ch2 = ntraces
        ch2 = min(ch2, ntraces)
        nch = max(ch2 - ch1, 0)

        f.seek(_TEXT_HEADER_LEN + _BIN_HEADER_LEN + ch1 * trace_len)
        buf = f.read(nch * trace_len)

    rec = np.frombuffer(buf, dtype=np.uint8).reshape(nch, trace_len)
    payload = np.ascontiguousarray(rec[:, _TRACE_HEADER_LEN:])

    if fmt == 1:
        words = payload.view(">u4").reshape(nch, ns)
        data = _ibm_to_float(words).astype(np.float32)
    elif fmt == 2:
        data = payload.view(">i4").reshape(nch, ns).astype(np.float32)
    elif fmt == 3:
        data = payload.view(">i2").reshape(nch, ns).astype(np.float32)
    elif fmt == 5:
        data = payload.view(">f4").reshape(nch, ns).astype(np.float32)
    else:  # fmt == 8
        data = payload.view(np.int8).reshape(nch, ns).astype(np.float32)

    return data, dt_us / 1e6, ns


def write_segy(path: str, data: np.ndarray, dt: float) -> None:
    """Write a minimal IEEE-float SEG-Y file (for tests / interchange)."""
    data = np.asarray(data, dtype=np.float32)
    nch, ns = data.shape
    binh = bytearray(_BIN_HEADER_LEN)
    binh[_BIN_DT_OFFSET:_BIN_DT_OFFSET + 2] = int(round(dt * 1e6)).to_bytes(2, "big")
    binh[_BIN_NS_OFFSET:_BIN_NS_OFFSET + 2] = int(ns).to_bytes(2, "big")
    binh[_BIN_FORMAT_OFFSET:_BIN_FORMAT_OFFSET + 2] = (5).to_bytes(2, "big")
    with open(path, "wb") as f:
        f.write(b" " * _TEXT_HEADER_LEN)
        f.write(bytes(binh))
        empty_th = bytes(_TRACE_HEADER_LEN)
        for tr in data:
            f.write(empty_th)
            f.write(tr.astype(">f4").tobytes())
