"""The fused chunk: the whole post-screen chunk as one CUDA graph per geometry.

The port of ``das_diff_veh_tpu/pipeline/fused.py``, where the chunk is one
jitted, donated XLA program per geometry.  The staged chunk runs some 24,000
small kernels and copies from Python launch loops (the 512-rank peak-distance
prune, the Kalman march), and the card idles between them.  Here
``timelapse.chunk_body`` is captured once per chunk geometry as a
``torch.cuda.CUDAGraph`` and replayed for every later chunk of that geometry:

- **all geometry on the host**: every slice bound, loop count and constant of
  the body comes from the host ``(shape, x, t, cfg, method)``, so the captured
  work is device work only; the constants come from ``core.constants``,
  filled by the warm-up call before capture;
- **a program** holds a static input buffer, the graph and its private memory
  pool.  Its first call copies the chunk into the buffer, runs ``chunk_body``
  once on a side stream (cuFFT plans, cuBLAS workspace, kernel libraries and
  the cached constants are made there), captures the body on that stream and
  replays it.  Every later call copies the chunk in, replays and returns
  clones of the outputs, so no later call overwrites a returned result;
- **capture is thread-local** (``capture_error_mode="thread_local"``): the
  batch loop's loader thread allocates, pins and synchronises its own stream
  while the compute thread may be capturing its first chunk;
- **no fallback**: on the card a failed capture or replay raises; nothing
  falls back to the staged chunk or to a kernel's plain version;
- ``n_windows`` comes back as a 0-d device tensor, as in JAX: the caller pulls
  it with the image in one copy (``workflow._default_compute``).

The CPU has no graph.  There a program runs ``chunk_body`` on each call, with
the same key, counters and 0-d ``n_windows``: the CPU stand-in of the graph,
as a kernel's plain version stands in for the kernel.

Counters: ``n_programs`` (the cache), ``n_dispatches(tag)`` (calls),
``n_captures`` and ``n_replays`` (the card).  The kernel wrappers' own counts
(``ops.traj_gather.launches``, ``.dot_launches``) see the warm-up call and the
capture, never a replay; a program's ``launches_per_replay`` holds what the
capture recorded.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from das_diff_veh_tpu_torch.config import PipelineConfig
from das_diff_veh_tpu_torch.core import constants
from das_diff_veh_tpu_torch.core.section import DasSection
from das_diff_veh_tpu_torch.device import resolve_device
from das_diff_veh_tpu_torch.ops import traj_gather as tg
from das_diff_veh_tpu_torch.pipeline.timelapse import (ChunkResult, chunk_body,
                                                       resolve_chunk_metadata,
                                                       screen_chunk)

_lock = threading.Lock()
_PROGRAMS: Dict[tuple, "ChunkProgram"] = {}
_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}

# per-call-site accounting, as JAX's DISPATCHES_BY_TAG
DISPATCHES_BY_TAG: Dict[str, int] = {}
_COUNTS = {"captures": 0, "replays": 0}


def n_dispatches(tag: Optional[str] = None) -> int:
    with _lock:
        if tag is not None:
            return DISPATCHES_BY_TAG.get(tag, 0)
        return sum(DISPATCHES_BY_TAG.values())


def n_programs() -> int:
    """Distinct fused programs built in this process (cache size)."""
    with _lock:
        return len(_PROGRAMS)


def n_captures() -> int:
    """CUDA graphs captured in this process (one per program on the card)."""
    return _COUNTS["captures"]


def n_replays() -> int:
    """CUDA graph replays in this process."""
    return _COUNTS["replays"]


def programs() -> list:
    """The cached programs, oldest first."""
    with _lock:
        return list(_PROGRAMS.values())


def clear_programs() -> None:
    """Drop every program (its graph, memory pool and static buffers) and the
    shared constants, and empty PyTorch's cache of freed device memory; the
    next chunk of a geometry builds its program again."""
    with _lock:
        _PROGRAMS.clear()
    constants.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _clone(v):
    """Clone every tensor of an output tree (tensors, dataclasses of
    tensors, tuples, None)."""
    if v is None:
        return None
    if torch.is_tensor(v):
        return v.clone()
    if dataclasses.is_dataclass(v):
        return dataclasses.replace(v, **{f.name: _clone(getattr(v, f.name))
                                         for f in dataclasses.fields(v)})
    return tuple(_clone(x) for x in v)


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One stream per card for warm-up and capture, so the cuBLAS workspace
    that the warm-up makes for it is the one the capture records."""
    with _lock:
        if device not in _STREAMS:
            _STREAMS[device] = torch.cuda.Stream(device)
        return _STREAMS[device]


def _kernel_counts() -> dict:
    return {"traj_gather": tg.launches, "traj_dot": tg.dot_launches}


class ChunkProgram:
    """``chunk_body`` for one chunk geometry: a CUDA graph on the card, the
    body itself on the CPU."""

    def __init__(self, shape: tuple, dtype: torch.dtype, device: torch.device,
                 x_dist: np.ndarray, t: np.ndarray, cfg: PipelineConfig, method: str,
                 with_qs: bool):
        self.shape, self.dtype, self.device = tuple(shape), dtype, device
        # one eager run of chunk_body: the CPU stand-in, and the card's warm-up
        self.body = functools.partial(chunk_body, x_dist=x_dist, t=t, dt=float(t[1] - t[0]),
                                      cfg=cfg, method=method, with_qs=with_qs)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in: Optional[torch.Tensor] = None
        self._static_out = None
        self.launches_per_replay: dict = {}
        self.warmup_s = self.capture_s = 0.0    # host seconds of the first call's two parts
        self._call_lock = threading.Lock()     # one static buffer: one call at a time

    def _capture(self, data: torch.Tensor) -> None:
        t0 = time.perf_counter()
        side = _side_stream(self.device)
        self.static_in = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        self.static_in.copy_(data)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.body(self.static_in)                  # warm-up: plans, handles, constants
        side.synchronize()
        self.warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        before = _kernel_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                out = self.body(self.static_in)
        except Exception as e:
            raise RuntimeError(f"capture of the fused chunk {self.shape} {self.dtype} "
                               f"failed: {e}") from e
        after = _kernel_counts()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.launches_per_replay = {k: after[k] - before[k] for k in after}
        self.graph, self._static_out = graph, out
        self.capture_s = time.perf_counter() - t0
        with _lock:
            _COUNTS["captures"] += 1

    def __call__(self, data: torch.Tensor):
        if self.device.type != "cuda":
            return self.body(data)
        with self._call_lock:
            if self.graph is None:
                self._capture(data)
            else:
                self.static_in.copy_(data)
            self.graph.replay()
            with _lock:
                _COUNTS["replays"] += 1
            return _clone(self._static_out)

    def pool_bytes(self) -> int:
        """Device memory of the graph's private pool (0 before capture)."""
        if self.graph is None:
            return 0
        pool = tuple(self.graph.pool())
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)


def _program(shape: tuple, dtype: torch.dtype, device: torch.device, x_dist: np.ndarray,
             t: np.ndarray, cfg: PipelineConfig, method: str, with_qs: bool) -> ChunkProgram:
    """Get-or-make the program of this chunk geometry.  The key hashes the
    axis values, not just their shapes: every slice bound inside comes from
    them, so two sections that differ only in their time origin are two
    programs (JAX ``fused.py:98``)."""
    x_dist, t = np.array(x_dist), np.array(t)          # the program's own copies
    key = (tuple(shape), str(dtype), constants.fingerprint(x_dist),
           constants.fingerprint(t), cfg, method, with_qs, device)
    with _lock:
        prog = _PROGRAMS.get(key)
        if prog is None:
            prog = _PROGRAMS[key] = ChunkProgram(shape, dtype, device, x_dist, t, cfg, method,
                                                 with_qs)
    return prog


def fused_process_chunk(section: DasSection, cfg: Optional[PipelineConfig] = None,
                        method: str = "xcorr", x_is_channels: bool = False,
                        with_qs: bool = False, tag: str = "process_chunk",
                        device=None) -> ChunkResult:
    """``process_chunk`` semantics in one graph replay on ``device`` (``None``
    = the card; raises without one).

    The input-health screen runs first, outside the graph: its verdict gates
    a Python ``raise`` (JAX ``fused.py:150``).  ``ChunkResult.n_windows`` is a
    0-d tensor on the device; every tensor of the result is the caller's own.
    Reach it through ``process_chunk(section, cfg.replace(
    chunk_pipeline="fused"))`` or call it directly."""
    if method not in {"xcorr", "surface_wave"}:
        raise ValueError(f"method must be 'xcorr' or 'surface_wave', got {method!r}")
    cfg = cfg if cfg is not None else PipelineConfig()
    dev = resolve_device(device)
    section, health = screen_chunk(section.to(dev), cfg, tag=tag)
    x_dist, t, _ = resolve_chunk_metadata(section, cfg, x_is_channels)
    data = section.data
    prog = _program(data.shape, data.dtype, data.device, x_dist, t, cfg, method, with_qs)
    with _lock:
        DISPATCHES_BY_TAG[tag] = DISPATCHES_BY_TAG.get(tag, 0) + 1
    img, vsg_stack, n_windows, tracks, batch, qs_batch = prog(data)
    return ChunkResult(disp_image=img, vsg_stack=vsg_stack, n_windows=n_windows,
                       tracks=tracks, batch=batch, qs_batch=qs_batch, health=health)
