"""The general traffic generator: what a traffic file's parameters become.

Every seed gets the same set of sizes and gaps, in another order, so that a
seed changes which inputs meet which moment and not how much work there is.

- ``arrivals``: an open loop's send times.  ``rate_per_s`` x ``seconds``
  arrivals whose gaps are the quantiles of the exponential distribution
  (a Poisson process's gaps, without its draw-to-draw spread in count),
  shuffled once into a fixed sequence that each seed rotates: every seed
  offers the same gaps in the same local pattern and starts it elsewhere.
- ``pool_order``: which of the pool's inputs each unit of work takes, each
  equally often, in a seeded order.
- :func:`open_loop`: load offered at fixed times, each unit timed from
  when it was due.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any size) and a sub-stream."""
    return np.random.default_rng([int(seed) % (1 << 64), int(seed) >> 64, *stream])


def arrivals(traffic: dict, seconds: float, seed: int) -> np.ndarray:
    """Send times in seconds from the window's start (see module doc)."""
    rate = float(traffic["rate_per_s"])
    n = max(int(round(rate * seconds)), 1)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    rng(0, 1).shuffle(gaps)
    gaps = np.roll(gaps, int(rng(seed, 1).integers(n)))
    return np.cumsum(gaps)


def pool_order(n: int, pool: int, seed: int, stream: int = 2) -> np.ndarray:
    """Pool index of each of ``n`` units: every index equally often (to
    one), shuffled by ``seed``."""
    order = np.arange(n) % pool
    rng(seed, stream).shuffle(order)
    return order


@dataclass
class Loop:
    """What a loop saw: per unit, when it was due, sent and done, and its
    result or error."""

    t0: float = 0.0
    due: list = field(default_factory=list)
    sent: list = field(default_factory=list)
    done: dict = field(default_factory=dict)
    results: dict = field(default_factory=dict)
    errors: dict = field(default_factory=dict)
    futures: dict = field(default_factory=dict)     # open loop: unit -> Future

    def latencies_ms(self) -> list:
        return [(self.done[i] - self.due[i]) * 1e3 for i in sorted(self.done)
                if i not in self.errors]

    def lateness_ms(self) -> list:
        return [(s - d) * 1e3 for s, d in zip(self.sent, self.due) if s is not None]


def close_window(done_times: list, t0: float, seconds: float) -> tuple:
    """``(units, window_s)``: the window closes at the first completion at
    or after ``t0 + seconds`` and takes every unit completed by then, over
    all the time to then.  ``(0, seconds)`` when nothing completed."""
    ts = sorted(done_times)
    for k, t in enumerate(ts):
        if t - t0 >= seconds:
            return k + 1, t - t0
    if not ts:
        return 0, seconds
    return len(ts), ts[-1] - t0


def open_loop(submit: Callable[[int], object], due_s: np.ndarray, senders: int) -> Loop:
    """Send unit ``i`` at ``due_s[i]`` from ``senders`` threads (unit ``i``
    from thread ``i % senders``), whatever came back before.  ``submit(i)``
    returns a ``concurrent.futures.Future``, or raises when the unit is
    refused; the loop records the time each future is done.  Returns once
    every unit was sent; wait for the futures with :func:`wait_all`."""
    loop = Loop()
    n = len(due_s)
    loop.sent = [None] * n
    lock = threading.Lock()
    loop.t0 = time.perf_counter() + 0.05
    loop.due = [loop.t0 + float(d) for d in due_s]

    def finished(i: int, fut) -> None:
        t = time.perf_counter()
        with lock:
            loop.done[i] = t
            exc = fut.exception()
            if exc is not None:
                loop.errors[i] = exc
            else:
                loop.results[i] = fut.result()

    def sender(j: int) -> None:
        for i in range(j, n, senders):
            wait = loop.due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            loop.sent[i] = time.perf_counter()
            try:
                fut = submit(i)
            except Exception as e:            # refused at admission: a failed unit
                with lock:
                    loop.done[i] = time.perf_counter()
                    loop.errors[i] = e
                continue
            loop.futures[i] = fut
            fut.add_done_callback(lambda f, i=i: finished(i, f))

    threads = [threading.Thread(target=sender, args=(j,), name=f"bench-sender-{j}")
               for j in range(senders)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return loop


def wait_all(loop: Loop, timeout_s: float) -> None:
    """Wait up to ``timeout_s`` for every sent unit; one that never comes
    is recorded as an error."""
    deadline = time.perf_counter() + timeout_s
    for fut in loop.futures.values():
        try:
            fut.result(timeout=max(deadline - time.perf_counter(), 0.0))
        except Exception:
            pass
    for i in range(len(loop.due)):
        if i not in loop.done:
            loop.errors[i] = TimeoutError(f"unit {i} did not come within {timeout_s} s")
    # the done callback runs just after the future resolves
    time.sleep(0.01)


def p95(values: list) -> float:
    """The 95th percentile (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(values, np.float64), 95)) if values else math.nan
