"""Adapter for the ambient-noise day-stack deployments.

A pool of seeded records (``harness.noise_records.ambient_record``), made
on the card at set-up and held on the host as float32, as a reader hands
them over, feeds the program's batch entry
``das_diff_veh_tpu_torch.pipeline.ambient.stack_records`` in a closed
loop: records are taken from the pool in a seeded order, and the loader
takes the next as soon as the program has room for it (the traffic file's
``prefetch_depth``).  One call, sized to fill the window at the rate seen
(at first the traffic file's ``records_per_s``), covers it; another follows
only where the first ends early.  All calls add into one
``DayStack`` on the card, allocated at set-up, warmed by
``warm_records`` records and cleared before the window.  A record counts
once its contribution is in the stack (the program's ``ambient_records``
counter, which it emits after the record's last band add has completed).

After the window, outside the timing, the gathers of ``check_sources``
sources are flushed from the stack: always the first row, the last row of
the first chunk, the first of the second, the last chunk's first row and
the last row, the rest drawn from the seed.  The check computes the same
gathers with the plain reference (``reference/ambient``) from the pool's
records, each weighted by how often the window stacked it (stacking is
linear), in float32 with TF32 off, and compares the worst source's largest
gap relative to its gather's peak.

The traced run keeps the program's device timeline (the ``ambient_*``
device blocks as device spans, read before the profile starts) and
profiles ``profile_units`` records back to back from the first completion
after 0.6 of the window, with ``torch.profiler`` started and stopped
between records.  The device timeline is turned off as the profile starts,
so that the profiled records carry none of its CUDA events and their
emission after each record's wait.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from harness.main import Check, Window
from harness.noise_records import ambient_record
from harness.trace import DeviceProfile, MemTracer, Readings, before
from harness.traffic import close_window, pool_order, rng


class TimelineTracer(MemTracer):
    """:class:`MemTracer` that also keeps the program's device spans: the
    program records CUDA events round its device blocks for a tracer whose
    ``device_timeline`` is true and hands them to :meth:`device` on this
    tracer's clock."""

    device_timeline = True

    def __init__(self):
        super().__init__(record_spans=True)
        self.device_spans: list = []

    def device(self, name: str, start_us: float, end_us: float, **args) -> None:
        self.device_spans.append({"name": name, "ts": start_us,
                                  "dur": max(end_us - start_us, 0.0), "tid": 1,
                                  "args": args})


def ambient_config(cfg: dict):
    """The deployment's ``AmbientConfig`` (the program's)."""
    from das_diff_veh_tpu_torch.config import AmbientConfig

    return AmbientConfig(fs=float(cfg["fs_hz"]), wlen=int(cfg["wlen"]),
                         overlap_ratio=float(cfg["overlap_ratio"]),
                         band_hz=tuple(map(float, cfg["band_hz"])), one_bit=bool(cfg["one_bit"]),
                         whiten=bool(cfg["whiten"]), max_offset=int(cfg["max_offset"]),
                         max_lag=int(cfg["max_lag"]), src_chunk=int(cfg["src_chunk"]))


def check_sources(cfg: dict, n: int, seed: int) -> list:
    """The ``n`` sources the check compares: the array's ends and the
    chunk edges named in the module doc, then seeded others, sorted."""
    nch, chunk = int(cfg["channels"]), int(cfg["src_chunk"])
    fixed = {0, chunk - 1, chunk, (nch - 1) // chunk * chunk, nch - 1}
    fixed = sorted(s for s in fixed if 0 <= s < nch)
    others = np.setdiff1d(np.arange(nch), fixed)
    more = rng(seed, 7).choice(others, size=max(min(n - len(fixed), len(others)), 0),
                               replace=False)
    return sorted(fixed + [int(s) for s in more])


def setup(ctx) -> None:
    # the program's entry first: a tree without it fails here, at once
    from das_diff_veh_tpu_torch.pipeline.ambient import DayStack, stack_records
    from das_diff_veh_tpu_torch.runtime import RuntimeConfig

    cfg, tr, st = ctx.config, ctx.traffic, ctx.state
    if tr["driver"] != "records":
        raise ValueError(f"unknown ambient driver {tr['driver']!r}")
    st["acfg"] = ambient_config(cfg)
    t0 = time.perf_counter()
    st["pool"] = [ambient_record(cfg, ctx.seed, k, ctx.device) for k in range(tr["pool"])]
    ctx.note(f"{len(st['pool'])} records of {st['pool'][0].shape} made in "
             f"{time.perf_counter() - t0:.3f} s")
    st["order"] = pool_order(int(tr["records_per_day"]), int(tr["pool"]), ctx.seed)
    st["runtime"] = RuntimeConfig(prefetch_depth=int(tr["prefetch_depth"]))
    st["tracer"] = TimelineTracer() if ctx.trace else MemTracer(record_spans=False)
    t0 = time.perf_counter()
    st["stack"] = DayStack(int(cfg["channels"]), st["acfg"], ctx.device)
    warm = [st["pool"][int(k)] for k in st["order"][:int(tr["warm_records"])]]
    stack_records(warm, stack=st["stack"], runtime=st["runtime"],
                  tracer=MemTracer(record_spans=False))
    st["stack"].clear()
    st["stack_records"] = stack_records
    ctx.note(f"stack {tuple(st['stack'].sum.shape)} allocated and warmed by {len(warm)} "
             f"record(s) in {time.perf_counter() - t0:.3f} s")


def _call_size(tr: dict, seconds: float, elapsed: float, done: int) -> int:
    """Records for the next call: enough to fill what is left of the window
    at the rate seen so far (at first the traffic file's
    ``records_per_s``)."""
    rate = done / elapsed if done else float(tr["records_per_s"])
    return max(math.ceil(rate * max(seconds - elapsed, 0.0)) + 1, 1)


def window(ctx) -> Window:
    tr, st = ctx.traffic, ctx.state
    pool, order, stack, tracer = st["pool"], st["order"], st["stack"], st["tracer"]
    prof = DeviceProfile() if ctx.trace else None
    after = 0.6 * ctx.seconds
    n_prof = int(tr["profile_units"])
    done: list = []                     # completion time of each record
    start_n: list = []                  # records done when the profile started

    def on_counter(name: str, values: dict) -> None:
        if name != "ambient_records":
            return
        now = time.perf_counter()
        done.append(now)
        if prof is None:
            return
        if not start_n and now - t0 >= after:
            tracer.device_timeline = False
            prof.start()
            start_n.append(len(done))
        elif prof.active and len(done) == start_n[0] + n_prof:
            prof.stop()

    tracer.on_counter = on_counter
    used = np.zeros(len(pool), dtype=np.int64)
    handed, failed, calls = 0, 0, []
    t0 = time.perf_counter()
    while True:
        n = _call_size(tr, ctx.seconds, time.perf_counter() - t0, len(done))
        idx = [int(order[(handed + i) % len(order)]) for i in range(n)]
        run = st["stack_records"]([pool[k] for k in idx], stack=stack, runtime=st["runtime"],
                                  tracer=tracer)
        np.add.at(used, idx, 1)
        handed += n
        failed += len(run.quarantined)
        calls.append(n)
        if done and done[-1] - t0 >= ctx.seconds:
            break
    profiled = n_prof
    if prof is not None and prof.active:
        profiled = len(done) - start_n[0]
    summary = prof.finish() if prof is not None else None
    units, window_s = close_window(done, t0, ctx.seconds)
    ctx.note(f"{units} records in {window_s:.3f} s over {len(calls)} call(s) of {calls} "
             f"records")
    tot = tracer.totals
    per = {k: tot[k][1] / 1e3 / max(tot[k][0], 1) for k in
           ("ambient_stage", "input_wait", "ambient_spectra", "ambient_cross",
            "ambient_finish", "compute") if k in tot}
    ctx.note("ms a record: " + ", ".join(f"{k} {v:.3f}" for k, v in per.items()))
    cut = summary.t0 * 1e6 if summary else None
    readings = Readings(spans=before(tracer.spans, cut), device=summary, units=units,
                        profiled_units=profiled, config=ctx.config, traffic=tr)
    if ctx.trace:
        readings.device_spans = before(tracer.device_spans, cut)
        readings.window = (t0 * 1e6, cut if cut is not None else done[-1] * 1e6)
    sources = check_sources(ctx.config, int(tr["check_sources"]), ctx.seed)
    ncf = stack.flush(sources)
    return Window(end_to_end={"chunks_per_s": units / window_s}, attempted=handed,
                  failed=failed, readings=readings,
                  outputs={"ncf": ncf, "sources": sources, "counted": stack.records,
                           "handed": handed, "used": used})


def release(ctx) -> None:
    st = ctx.state
    for key in ("stack", "stack_records", "tracer"):
        st.pop(key, None)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# -- the check ------------------------------------------------------------------

def reference_gathers(ctx, used, sources, bf16: bool = False) -> np.ndarray:
    """The reference's mean gathers of ``sources`` over the pool's records,
    record ``k`` counted ``used[k]`` times, on the run's device (float32,
    TF32 off), combined on the host in float64."""
    from reference.ambient import ncf

    cfg = ctx.config
    return ncf.stacked_gathers(ctx.state["pool"], used, sources, fs=float(cfg["fs_hz"]),
                               wlen=int(cfg["wlen"]),
                               overlap_ratio=float(cfg["overlap_ratio"]),
                               band_hz=tuple(map(float, cfg["band_hz"])),
                               max_offset=int(cfg["max_offset"]),
                               max_lag=int(cfg["max_lag"]), one_bit=bool(cfg["one_bit"]),
                               whiten=bool(cfg["whiten"]), bf16=bf16, device=ctx.device)


def worst_gap(got, want) -> float:
    """Over sources, the largest |got - want| relative to the reference
    gather's largest |value|; infinite where a gather is missing or not
    finite."""
    if got is None or want is None or np.shape(got) != np.shape(want):
        return float("inf")
    got = np.asarray(got, np.float64).reshape(len(want), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    g = float((np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)).max())
    return g if np.isfinite(g) else float("inf")


def check(ctx, win) -> list:
    out = win.outputs
    t0 = time.perf_counter()
    want = reference_gathers(ctx, out["used"], out["sources"])
    gap = worst_gap(out["ncf"], want)
    ctx.note(f"reference: {len(out['sources'])} sources over records used "
             f"{out['used'].tolist()} in {time.perf_counter() - t0:.3f} s")
    lim = ctx.config["limits"]
    n_want = int(ctx.traffic["check_sources"])
    return [Check("records_mismatch", float(abs(out["counted"] - out["handed"])),
                  float(lim["records_mismatch"])),
            Check("ncf_rel_gap", gap if np.isfinite(gap) else 1e300, float(lim["ncf_rel_gap"])),
            Check("sources_compared_short", float(max(n_want - len(out["sources"]), 0)), 0.0)]


def control_outputs(ctx) -> dict:
    """The control put in the program's place: the reference with both
    spectra rounded through bfloat16 (the port's bf16 tier), over the
    records a window's first call of ``ctx.seconds`` hands, in the form of
    the window's outputs."""
    tr = ctx.traffic
    n = _call_size(tr, ctx.seconds, 0.0, 0)
    idx = [int(ctx.state["order"][i % len(ctx.state["order"])]) for i in range(n)]
    used = np.bincount(idx, minlength=len(ctx.state["pool"]))
    sources = check_sources(ctx.config, int(tr["check_sources"]), ctx.seed)
    low = reference_gathers(ctx, used, sources, bf16=True)
    return {"ncf": low.astype(np.float32), "sources": sources, "counted": n, "handed": n,
            "used": used}
