"""The loader's hop from host memory onto the card (``RuntimeConfig.device_put``).

One :class:`Stager` a run owns the device, the run's ``DeviceTimeline``, a
side stream and a ring of ``SLABS`` pinned host slabs of ``SLAB_BYTES``
each, pinned on the first put.  :meth:`Stager.put`, in the loader thread,
streams the host array onto the card through the ring: for each
slab-sized piece of its bytes, in order (:func:`slab_plan`), it waits for
the slot's last copy to land, fills the slot with a few host threads
(:func:`copy_threads`, the loader's own thread one of them) and enqueues
the slot's copy into a buffer allocated on the side stream, then records
the slot's event.  The host fills piece k+1 while the card copies piece k,
and no array is pinned whole.  All of it is one device block of a timeline
unit; the put then waits for the side stream (which blocks only the
loader), so the data has landed before the compute thread sees it, and
sends the tracer counter ``staged`` with the running totals ``bytes`` and
``slabs``.  The host casts to float32 before the copy, unless the caller
hands in an on-card step: then the raw array is copied as it is and the
step runs on the side stream in the same block (the batch loader's savgol
pre-smooth, ``ops.savgol.savgol_from_edges``: the interior correlated,
scipy's edge samples from the host written in, the date rescale divided and
one cast to float32).  :meth:`Stager.claim`, in the compute thread, marks
the buffer, which belongs to the side stream's pool, with ``record_stream``
on that thread's current stream, so that the caching allocator does not
hand the block to a later staging copy while kernels that read it are
queued.  On the CPU both leave the tensor as it is.  A fused chunk's
capture in the compute thread is thread-local (``pipeline.fused``), so the
loader's work on the side stream cannot break it.  One put at a time: the
ring is the stager's, and the runtime has one loader thread.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from das_diff_veh_tpu_torch.runtime.tracing import DeviceTimeline, device_work

# A slab of the ring, and the ring's length: three slabs let the host fill
# one while the card copies another and a third waits.  The put of an
# 8721 x 30000 float32 record (1.05 GB, pageable) through the ring on an
# H100 80GB HBM3 at 700 W, 8 cores, median of 3 ms, by slab size at 4 copy
# threads: 16 MB 65.3, 32 MB 72.3, 64 MB 52.8, 128 MB 84.6.  (One pinned
# copy of the same bytes: 19.5-20.4 ms, 52.7 GB/s.)
SLAB_BYTES = 64 << 20
SLABS = 3
# Copy threads: half the cores, the other half left to the compute thread
# and the rest of the process (the loader's own thread is one of the
# copiers), at most COPY_THREADS_MAX.  That put at 64 MB slabs on the
# 8-core host: 1 thread 161.1 ms, 2 92.6, 4 52.8, 8 48.2; the host copy
# alone into pinned memory 89-100, 56-58, 33-39, 30-37 ms.  On a host of
# four such cards, 32 cores, in the day stack split over the four (the
# cards at 97.5-98.6 ms a record): 4 threads 78.9 ms a put, 8 64.1 and
# 78.7, 12 71.8; on another such host 4 threads took 119.0-123.0 ms, over
# the cards' time.
COPY_THREADS_MAX = 8
# A thread's part of a slab starts on a page.
PART_ALIGN = 4096


def slab_plan(nbytes: int, slab_bytes: int) -> List[Tuple[int, int]]:
    """The (start, stop) byte ranges, in order, that cover ``nbytes`` once,
    each ``slab_bytes`` long but the last, which may be shorter."""
    return [(a, min(a + slab_bytes, nbytes)) for a in range(0, nbytes, slab_bytes)]


def copy_threads() -> int:
    """Threads that fill a slab: half the cores this process may run on, at
    least 1 and at most ``COPY_THREADS_MAX``."""
    return max(1, min(COPY_THREADS_MAX, len(os.sched_getaffinity(0)) // 2))


def pinned_slab(nbytes: int) -> torch.Tensor:
    """``nbytes`` of page-locked host memory from the caching host
    allocator, which keeps them for the next stager once this one is gone."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class Stager:
    """The hop onto ``device`` for one run; :attr:`timeline`, on ``tracer``,
    is the run's device timeline.  :meth:`close` stops its copy threads."""

    def __init__(self, device, tracer):
        self.device = torch.device(device)
        self.tracer = tracer
        self.timeline = DeviceTimeline(tracer, self.device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.bytes = self.slabs = 0
        self._ring: list = []           # [(slab as numpy, slab, event of its last copy)]
        self._threads = copy_threads()
        self._pool = None

    def put(self, host: torch.Tensor, unit: str,
            step: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
            **args) -> torch.Tensor:
        """``host`` landed on the card, as float32 or through ``step``, a
        device block of unit ``unit`` with ``args``; on the CPU, ``host``."""
        if self.stream is None:
            return host
        src = (host if step is not None else host.to(torch.float32)).contiguous()
        with self.timeline.unit(unit, **args):
            with torch.cuda.stream(self.stream), device_work():
                raw = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                self._stream_in(src, raw)
                data = raw if step is None else step(raw)
            self.stream.synchronize()
        self.tracer.counter("staged", bytes=self.bytes, slabs=self.slabs)
        return data

    def _stream_in(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """``src``'s bytes into ``dst``, piece by piece through the ring, the
        copies enqueued on the current (side) stream."""
        if not self._ring:
            for _ in range(SLABS):
                slab = pinned_slab(SLAB_BYTES)
                self._ring.append((slab.numpy(), slab, torch.cuda.Event()))
        if self._threads > 1 and self._pool is None:
            self._pool = ThreadPoolExecutor(self._threads - 1, thread_name_prefix="stager-copy")
        flat = src.view(-1).view(torch.uint8)
        out = dst.view(-1).view(torch.uint8)
        plan = slab_plan(flat.numel(), SLAB_BYTES)
        host = flat.numpy()
        for k, (a, b) in enumerate(plan):
            view, slab, landed = self._ring[k % SLABS]
            landed.synchronize()
            self._fill(view[:b - a], host[a:b])
            out[a:b].copy_(slab[:b - a], non_blocking=True)
            landed.record()
        self.bytes += flat.numel()
        self.slabs += len(plan)

    def _fill(self, slab: np.ndarray, piece: np.ndarray) -> None:
        """``piece`` into ``slab``, in contiguous parts, one a copy thread
        (``np.copyto`` gives up the interpreter lock)."""
        n = piece.nbytes
        cuts = [n * i // self._threads // PART_ALIGN * PART_ALIGN
                for i in range(self._threads)] + [n]
        parts = [self._pool.submit(np.copyto, slab[c0:c1], piece[c0:c1])
                 for c0, c1 in zip(cuts[1:-1], cuts[2:])]
        try:
            np.copyto(slab[:cuts[1]], piece[:cuts[1]])
        finally:
            wait(parts)
        for part in parts:
            part.result()

    def claim(self, data: torch.Tensor) -> torch.Tensor:
        """``data`` from :meth:`put`, marked for this thread's stream."""
        if data.is_cuda:
            data.record_stream(torch.cuda.current_stream(data.device))
        return data

    def close(self) -> None:
        """Stop the copy threads; the slabs go back to the caching host
        allocator with the stager."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
