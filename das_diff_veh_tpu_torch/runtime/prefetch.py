"""Bounded background prefetch: load chunk k+1..k+depth while k computes
(a copy of ``das_diff_veh_tpu/runtime/prefetch.py``).

The loader thread runs each task's ``load`` callable (host npz read +
savgol preprocess + staging onto the card) and feeds a bounded queue;
the main thread drains it in submission order.  Load exceptions are
delivered in-band as ``(index, None, exc)`` so the executor owns the
retry/quarantine policy — the loader never dies on a bad file.

NumPy I/O, zlib decompression, scipy filtering, and device transfer mostly
release the GIL, so the loader overlaps the main thread's device waits (the
compute thread's launch loop holds it, so how much a chunk overlaps is a
measurement, not a given);
``depth`` bounds the host-memory footprint to ``depth + 1`` staged chunks.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

LoadResult = Tuple[int, Any, Optional[BaseException]]

_SENTINEL = object()


class PrefetchLoader:
    """Iterate ``(index, value, error)`` over tasks, loaded ahead by a thread.

    ``depth <= 0`` runs every load inline on the calling thread (serial
    mode — the serial baseline and a debugging escape hatch).
    """

    def __init__(self, loads: Sequence[Callable[[], Any]], depth: int = 2,
                 thread_name: str = "chunk-prefetch"):
        self._loads = list(loads)
        self._depth = int(depth)
        self._stop = threading.Event()
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        if self._depth > 0 and self._loads:
            self._queue = queue.Queue(maxsize=self._depth)
            self._thread = threading.Thread(target=self._worker,
                                            name=thread_name, daemon=True)
            self._thread.start()

    def _worker(self) -> None:
        try:
            for i, load in enumerate(self._loads):
                if self._stop.is_set():
                    return
                try:
                    item: LoadResult = (i, load(), None)
                except BaseException as e:  # in-band; retry/quarantine policy
                    item = (i, None, e)     # lives upstream in the executor
                self._put(item)
        finally:
            self._put(_SENTINEL)            # never lose end-of-stream (deadlock)

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[LoadResult]:
        if self._queue is None:             # inline (serial) mode
            for i, load in enumerate(self._loads):
                if self._stop.is_set():
                    return
                try:
                    yield i, load(), None
                except Exception as e:
                    yield i, None, e
            return
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                return
            yield item

    def qsize(self) -> int:
        """Chunks currently staged ahead (0 in inline mode) — the live
        queue-depth gauge the obs registry scrapes."""
        return self._queue.qsize() if self._queue is not None else 0

    def close(self) -> None:
        """Stop the loader early (executor abort); idempotent."""
        self._stop.set()
        if self._thread is not None:
            # drain so a blocked put observes the stop event promptly
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5.0)
