"""Adapter for the ambient-noise day stack split over the cards of one host.

The ambient adapter's traffic, window, check and control
(``harness/systems/ambient.py``, imported, not copied) over a ``DayStack``
split by source chunks over ``cuda:0`` to ``cuda:<chips - 1>`` (on the CPU,
in tests, as many CPU shards).  Its own parts:

- ``setup`` builds the split stack first, so that a program whose
  ``DayStack`` takes no ``devices`` fails at once, and holds the
  configuration's ``cards`` to the cell's ``chips``; then the record pool,
  the warm-up and the clear, as the ambient adapter's;
- ``window`` is the ambient window; then the first and last row of every
  shard not among the checked sources are flushed and added to them, so
  that the check sees every card's edges;
- ``release`` waits for every card and empties its cache.

The program's split (``DayStack.shards``), each card's memory peak, the bytes
of each put onto the home card (the program's ``staged`` counter) and, in a
traced run, each card's device time a record by stage go to standard error.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness.noise_records import ambient_record
from harness.systems.ambient import (TimelineTracer, ambient_config, check,  # noqa: F401
                                     control_outputs, reference_gathers, worst_gap)
from harness.systems.ambient import window as ambient_window
from harness.trace import MemTracer
from harness.traffic import pool_order


def cards(ctx) -> list:
    """The cell's ``chips`` cards, ``cuda:0`` first; on the CPU, the run's
    device as many times."""
    chips = int(ctx.spec.cell["chips"])
    if ctx.device.type == "cuda":
        return [torch.device("cuda", i) for i in range(chips)]
    return [ctx.device] * chips


def shard_edges(stack) -> list:
    """The first and last row of every shard, sorted."""
    return sorted({r for _, first, last in stack.shards for r in (first, last)})


def count_puts(tracer) -> list:
    """The bytes of each put the program's stager makes through ``tracer``,
    from its ``staged`` counter (a running total, begun anew by each
    ``stack_records`` call), filled as the run goes."""
    puts, last, counter = [], [0], tracer.counter

    def staged(name: str, **values) -> None:
        if name == "staged":
            total = int(values["bytes"])
            puts.append(total - last[0] if total > last[0] else total)
            last[0] = total
        counter(name, **values)

    tracer.counter = staged
    return puts


def setup(ctx) -> None:
    # the program's split stack first: a tree without it fails here, at once
    from das_diff_veh_tpu_torch.pipeline.ambient import DayStack, stack_records
    from das_diff_veh_tpu_torch.runtime import RuntimeConfig

    cfg, tr, st = ctx.config, ctx.traffic, ctx.state
    chips = int(ctx.spec.cell["chips"])
    if int(cfg["cards"]) != chips:
        raise ValueError(f"the configuration splits the stack over {cfg['cards']} cards, "
                         f"the cell has {chips} chips")
    if tr["driver"] != "records":
        raise ValueError(f"unknown ambient driver {tr['driver']!r}")
    st["acfg"] = ambient_config(cfg)
    t0 = time.perf_counter()
    st["stack"] = DayStack(int(cfg["channels"]), st["acfg"], devices=cards(ctx))
    ctx.note(f"stack over {chips} cards, rows "
             + ", ".join(f"{c}: {a}-{b}" for c, a, b in st["stack"].shards)
             + f", allocated in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    st["pool"] = [ambient_record(cfg, ctx.seed, k, ctx.device) for k in range(tr["pool"])]
    ctx.note(f"{len(st['pool'])} records of {st['pool'][0].shape} made in "
             f"{time.perf_counter() - t0:.3f} s")
    st["order"] = pool_order(int(tr["records_per_day"]), int(tr["pool"]), ctx.seed)
    st["runtime"] = RuntimeConfig(prefetch_depth=int(tr["prefetch_depth"]))
    st["tracer"] = TimelineTracer() if ctx.trace else MemTracer(record_spans=False)
    st["puts"] = count_puts(st["tracer"])
    t0 = time.perf_counter()
    warm = [st["pool"][int(k)] for k in st["order"][:int(tr["warm_records"])]]
    stack_records(warm, stack=st["stack"], runtime=st["runtime"],
                  tracer=MemTracer(record_spans=False))
    st["stack"].clear()
    st["stack_records"] = stack_records
    ctx.note(f"warmed by {len(warm)} record(s) in {time.perf_counter() - t0:.3f} s")


def _card_stages(spans: list) -> dict:
    """card -> stage -> device milliseconds a record, from the program's
    ``ambient_cross`` and ``ambient_finish`` device spans."""
    per: dict = {}
    records = {s["args"].get("record") for s in spans}
    for s in spans:
        if s["name"] in ("ambient_cross", "ambient_finish") and "card" in s["args"]:
            stages = per.setdefault(s["args"]["card"], {})
            stages[s["name"]] = stages.get(s["name"], 0.0) + s["dur"] / 1e3
    return {c: {k: v / max(len(records), 1) for k, v in st.items()}
            for c, st in sorted(per.items())}


def window(ctx):
    win = ambient_window(ctx)
    stack, out = ctx.state["stack"], win.outputs
    more = [r for r in shard_edges(stack) if r not in set(out["sources"])]
    if more:
        out["ncf"] = np.concatenate([out["ncf"], stack.flush(more)])
        out["sources"] = list(out["sources"]) + more
    ctx.note(f"checked sources {out['sources']}")
    puts = ctx.state["puts"]
    if puts:
        ctx.note(f"bytes put onto {stack.device} a record: {min(puts)} to {max(puts)} over "
                 f"{len(puts)} puts (a record is {ctx.state['pool'][0].nbytes} B)")
    if ctx.device.type == "cuda":
        ctx.note("memory peak by card: " + ", ".join(
            f"{c}: {torch.cuda.max_memory_allocated(c)}" for c, _, _ in stack.shards))
    spans = getattr(win.readings, "device_spans", None)
    if spans:
        ctx.note("device ms a record by card: " + "; ".join(
            f"card {c}: " + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
            for c, st in _card_stages(spans).items()))
    return win


def release(ctx) -> None:
    st = ctx.state
    for key in ("stack", "stack_records", "tracer"):
        st.pop(key, None)
    if ctx.device.type == "cuda":
        for card in cards(ctx):
            with torch.cuda.device(card):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
