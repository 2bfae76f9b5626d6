"""Adapter for the vehicle-imaging deployments.

A pool of seeded 2-minute chunks (``harness.synth.vehicle_chunk``) feeds one
of two drivers (the traffic file's ``driver``):

- ``directory``: a date folder of ``files_per_day`` npz names, hard links
  onto the pool's files, in ``TMPDIR``; the window is filled by one
  ``run_directory(max_chunks=...)`` call sized to it (another follows only
  where the first ends early), and a chunk counts when the runtime has
  accumulated it;
- ``engine``: an open loop that submits chunks held in host memory to
  ``ServingEngine`` over ``ImagingComputeFactory``, each request timed
  from when it was due; below the engine's capacity its tail
  (``request_p95_ms``) is the measure, above it the requests served a
  second (``requests_per_s``: those done by the first completion at or
  after the window's end, over that time).

The check runs the frozen reference (``reference/imaging``) on each pool
chunk, in float32 with TF32 off as the configuration states, from the same
file or the same host array, and compares
every vehicle count exactly and every image (a directory call's summed
image, or a request's image) by its largest gap relative to the
reference's peak.
"""

from __future__ import annotations

import atexit
import dataclasses
import math
import os
import shutil
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch

from harness.main import Check, Window
from harness.synth import vehicle_chunk
from harness.trace import DeviceProfile, MemTracer, Readings, before
from harness.traffic import arrivals, close_window, open_loop, p95, pool_order, wait_all


def pipeline_config(cfg: dict, module, screen: bool = True):
    """The deployment's ``PipelineConfig`` from the program's config module
    or the reference's copy of it (``module``).  ``screen=False`` turns the
    in-chunk health screen off: the serving engine screens at admission
    instead, and its warm-up chunk (all zeros) would fail the in-chunk
    screen as dead channels."""
    base = module.PipelineConfig()
    return base.replace(
        interrogator=dataclasses.replace(base.interrogator, start_ch=int(cfg["ch1"]),
                                         dx=float(cfg["dx_m"]), fs=float(cfg["fs_hz"])),
        imaging=dataclasses.replace(base.imaging, x0=float(cfg["pivot_m"])),
        health=module.HealthConfig(enabled=bool(cfg["health_screen"]) and screen),
        chunk_pipeline=cfg["chunk_pipeline"])


def _axes(cfg: dict):
    nt = int(round(cfg["chunk_s"] * cfg["fs_hz"]))
    x = float(cfg["ch1"]) + np.arange(cfg["channels"], dtype=np.float64)
    t = np.arange(nt, dtype=np.float64) / float(cfg["fs_hz"])
    return x, t


def _file_name(date: str, i: int, interval_s: float) -> str:
    s = int(round(i * interval_s))
    return f"{date}_{s // 3600:02d}{s // 60 % 60:02d}{s % 60:02d}.npz"


def setup(ctx) -> None:
    from das_diff_veh_tpu_torch import config as C

    cfg, tr, st = ctx.config, ctx.traffic, ctx.state
    st["screen_in_chunk"] = tr["driver"] == "directory"
    st["pcfg"] = pipeline_config(cfg, C, st["screen_in_chunk"])
    x, t = _axes(cfg)
    st["x"], st["t"] = x, t
    t0 = time.perf_counter()
    pool = [vehicle_chunk(cfg, ctx.seed, k, ctx.device) for k in range(tr["pool"])]
    ctx.note(f"{len(pool)} chunks made in {time.perf_counter() - t0:.3f} s")
    st["tracer"] = MemTracer(record_spans=ctx.trace)
    if tr["driver"] == "directory":
        _setup_directory(ctx, pool)
    elif tr["driver"] == "engine":
        _setup_engine(ctx, pool)
    else:
        raise ValueError(f"unknown imaging driver {tr['driver']!r}")


# -- the batch folder ---------------------------------------------------------

def _setup_directory(ctx, pool) -> None:
    from das_diff_veh_tpu_torch.io.readers import DirectoryDataset
    from das_diff_veh_tpu_torch.pipeline.workflow import run_directory
    from das_diff_veh_tpu_torch.runtime import RuntimeConfig

    cfg, tr, st = ctx.config, ctx.traffic, ctx.state
    root = tempfile.mkdtemp(prefix="bench_imaging_")
    st["root"] = root
    atexit.register(shutil.rmtree, root, True)   # also when the run fails
    os.makedirs(os.path.join(root, "pool"))
    day = os.path.join(root, cfg["date"])
    os.makedirs(day)
    files = []
    for k, data in enumerate(pool):
        path = os.path.join(root, "pool", f"chunk_{k}.npz")
        np.savez(path, data=data, x_axis=st["x"], t_axis=st["t"])
        files.append(path)
    st["order"] = pool_order(tr["files_per_day"], tr["pool"], ctx.seed)
    st["files"] = [None] * len(files)    # each pool chunk's first name in the day folder
    for i, k in enumerate(st["order"]):
        name = os.path.join(day, _file_name(cfg["date"], i, cfg["chunk_s"]))
        os.link(files[k], name)
        if st["files"][k] is None:
            st["files"][k] = name
    st["dataset"] = DirectoryDataset(cfg["date"], root=root, ch1=cfg["ch1"], ch2=cfg["ch2"],
                                     smoothing=bool(cfg["savgol"]),
                                     sg_window=cfg["savgol_window"],
                                     sg_order=cfg["savgol_order"])
    st["runtime"] = RuntimeConfig(prefetch_depth=int(tr["prefetch_depth"]))

    def call(max_chunks: int, tracer):
        return run_directory(st["dataset"], st["pcfg"], method=cfg["method"],
                             x_is_channels=True, max_chunks=max_chunks,
                             runtime=st["runtime"], tracer=tracer, device=ctx.device)

    st["call"] = call
    t0 = time.perf_counter()
    call(int(tr["warm_chunks"]), MemTracer(record_spans=False))   # capture, kernels, cache
    ctx.note(f"warm-up of {tr['warm_chunks']} chunks in {time.perf_counter() - t0:.3f} s")


def _call_size(tr: dict, seconds: float, elapsed: float, done: int) -> int:
    """Chunks for the next ``run_directory`` call: enough to fill what is
    left of the window at the rate seen so far (at first the traffic
    file's ``chunks_per_s``), so that one call, and one fill of the
    loader's pipeline, covers the window as a day's run does."""
    rate = done / elapsed if done else float(tr["chunks_per_s"])
    n = math.ceil(rate * max(seconds - elapsed, 0.0)) + 1
    return int(min(max(n, 1), int(tr["files_per_day"])))


def _window_directory(ctx) -> Window:
    tr, st = ctx.traffic, ctx.state
    prof = DeviceProfile() if ctx.trace else None
    after = 0.6 * ctx.seconds           # a late, steady stretch of the window
    n_prof = int(tr["profile_units"])
    done: list = []                     # (time, running vehicle total) per chunk
    start_n = []                        # chunks done when the profile started

    def on_counter(name: str, values: dict) -> None:
        if name != "vehicles":
            return
        now = time.perf_counter()
        done.append((now, int(values["total"])))
        if prof is None:
            return
        if not start_n and now - t0 >= after:
            prof.start()
            start_n.append(len(done))
        elif prof.active and len(done) == start_n[0] + n_prof:
            prof.stop()

    tracer = st["tracer"]
    tracer.on_counter = on_counter
    calls = []
    t0 = time.perf_counter()
    while True:
        c0 = len(done)
        res = st["call"](_call_size(tr, ctx.seconds, time.perf_counter() - t0, len(done)),
                         tracer)
        totals = [v for _, v in done[c0:]]
        counts = [b - a for a, b in zip([0] + totals[:-1], totals)]
        calls.append({"counts": counts, "image": res.avg_image,
                      "quarantined": [q.key for q in res.quarantined]})
        if done and done[-1][0] - t0 >= ctx.seconds:
            break
    profiled = n_prof
    if prof is not None and prof.active:
        profiled = len(done) - start_n[0]
    summary = prof.finish() if prof is not None else None
    units, window_s = close_window([d for d, _ in done], t0, ctx.seconds)
    failed = sum(len(c["quarantined"]) for c in calls)
    attempted = sum(len(c["counts"]) for c in calls) + failed
    ctx.note(f"{units} chunks in {window_s:.3f} s over {len(calls)} directory calls "
             f"of {[len(c['counts']) for c in calls]} chunks")
    tot = tracer.totals
    per = {k: tot[k][1] / 1e3 / max(tot[k][0], 1) for k in
           ("read", "preprocess", "device_put", "input_wait", "compute") if k in tot}
    ctx.note("ms a chunk: " + ", ".join(f"{k} {v:.3f}" for k, v in per.items()))
    readings = Readings(spans=before(tracer.spans, summary.t0 * 1e6 if summary else None),
                        device=summary, units=units, profiled_units=profiled,
                        config=ctx.config, traffic=tr)
    return Window(end_to_end={"chunks_per_s": units / window_s}, attempted=attempted,
                  failed=failed, readings=readings, outputs={"calls": calls})


# -- the serving engine -------------------------------------------------------

def _setup_engine(ctx, pool) -> None:
    from das_diff_veh_tpu_torch.config import HealthConfig, ServeConfig
    from das_diff_veh_tpu_torch.core.section import DasSection
    from das_diff_veh_tpu_torch.serve import ServingEngine
    from das_diff_veh_tpu_torch.serve.imaging import ImagingComputeFactory

    cfg, st = ctx.config, ctx.state
    st["host"] = [d.astype(np.float32) for d in pool]
    st["sections"] = [DasSection(d, st["x"], st["t"]) for d in st["host"]]
    factory = ImagingComputeFactory(st["pcfg"], method=cfg["method"], x_is_channels=True,
                                    x_axis=st["x"], fs=cfg["fs_hz"], device=ctx.device)
    serve_cfg = ServeConfig(buckets=((cfg["channels"], len(st["t"])),),
                            health=HealthConfig(enabled=bool(cfg["health_screen"])),
                            max_queue=int(ctx.traffic["max_queue"]),
                            default_deadline_ms=float(ctx.traffic["deadline_ms"]))
    engine = ServingEngine(factory, serve_cfg, tracer=st["tracer"])
    t0 = time.perf_counter()
    engine.start()                       # warm-up: the bucket's program is built here
    ctx.note(f"engine warm-up in {time.perf_counter() - t0:.3f} s")
    st["engine"] = engine


def _window_engine(ctx) -> Window:
    tr, st = ctx.traffic, ctx.state
    engine = st["engine"]
    due = arrivals(tr, ctx.seconds, ctx.seed)
    order = pool_order(len(due), tr["pool"], ctx.seed)
    submit_ms = []                       # host time of each submit call

    def submit(i: int):
        t = time.perf_counter()
        try:
            return engine.submit(st["sections"][int(order[i])])
        finally:
            submit_ms.append((time.perf_counter() - t) * 1e3)

    loop = open_loop(submit, due, int(tr["senders"]))
    wait_all(loop, float(tr["drain_s"]))
    cut = time.perf_counter() * 1e6      # the window's spans all end before this
    summary, profiled = _profile_burst(ctx) if ctx.trace else (None, 0)
    lat = loop.latencies_ms()
    late = loop.lateness_ms()
    ctx.note(f"{len(due)} requests at {tr['rate_per_s']}/s: p50 "
             f"{np.percentile(lat, 50) if lat else float('nan'):.3f} ms, p95 {p95(lat):.3f} ms, "
             f"sender late by up to {max(late) if late else 0.0:.3f} ms "
             f"(p95 {p95(late):.3f} ms)")
    for i, e in sorted(loop.errors.items())[:5]:
        ctx.note(f"request {i} failed: {type(e).__name__}: {e}")
    results = {i: (int(order[i]), r.n_windows, r.image) for i, r in loop.results.items()}
    counters = {"das_serve_steady_state_compiles":
                engine.registry.gauge("das_serve_steady_state_compiles").value}
    readings = Readings(spans=before(st["tracer"].spans, cut), counters=counters,
                        device=summary, units=len(lat),
                        profiled_units=profiled, harness={"submit_ms": submit_ms},
                        config=ctx.config, traffic=tr)
    served, served_s = close_window([loop.done[i] for i in loop.results], loop.t0,
                                    ctx.seconds)
    ctx.note(f"{served} requests served in {served_s:.3f} s")
    value = p95(lat) if lat else 1e300
    return Window(end_to_end={"request_p95_ms": value,
                              "requests_per_s": served / served_s}, attempted=len(due),
                  failed=len(loop.errors), readings=readings, outputs={"results": results})


def _profile_burst(ctx) -> tuple:
    """The traced run's device profile, ``(summary, requests)``: after the
    window has drained, ``profile_requests`` pool chunks sent one after
    another from this thread, so that the dispatcher runs them back to back
    as it does at capacity.  ``torch.profiler`` starts and stops while no
    other thread drives the card: started in the middle of the open loop,
    it held the senders for seconds, and once hung the run."""
    st, n = ctx.state, int(ctx.traffic["profile_requests"])
    prof = DeviceProfile()
    prof.start()
    futures = [st["engine"].submit(st["sections"][k % len(st["sections"])])
               for k in range(n)]
    for f in futures:
        f.result(timeout=float(ctx.traffic["drain_s"]))
    prof.stop()
    return prof.finish(), n


def window(ctx) -> Window:
    if ctx.traffic["driver"] == "directory":
        return _window_directory(ctx)
    return _window_engine(ctx)


def release(ctx) -> None:
    st = ctx.state
    if "engine" in st:
        st.pop("engine").close()
    for key in ("call", "dataset", "sections"):
        st.pop(key, None)
    from das_diff_veh_tpu_torch.pipeline import fused

    fused.clear_programs()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# -- the check ------------------------------------------------------------------

def reference_images(ctx, device, dtype=None) -> list:
    """``[(image or None, n_windows)]`` of the reference for every pool
    chunk, from the day folder's files (batch) or the host arrays
    (serving), in ``dtype``: by default the configuration's float32 on the
    card (TF32 is the caller's), float64 on the CPU, where the tests run."""
    if dtype is None:
        dtype = torch.float32 if torch.device(device).type == "cuda" else torch.float64
    from reference.imaging import chain
    from reference.imaging import config as RC

    cfg, st = ctx.config, ctx.state
    rcfg = pipeline_config(cfg, RC, st["screen_in_chunk"])
    out = []
    if "files" in st:
        for path in st["files"]:
            data, x, t = chain.read_chunk(path, cfg["ch1"], cfg["ch2"], bool(cfg["savgol"]),
                                          cfg["savgol_window"], cfg["savgol_order"])
            out.append(chain.image_chunk(data, x, t, rcfg, True, device, dtype))
    else:
        for data in st["host"]:
            out.append(chain.image_chunk(data, st["x"], st["t"], rcfg, True, device, dtype))
    return out


@contextmanager
def tf32(on: bool):
    """TF32 matrix products on or off for the block (restored after)."""
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def image_gap(got, want) -> float:
    """Largest gap of ``got`` from ``want`` relative to ``want``'s peak;
    0 when neither has an image, infinite when one side lacks it."""
    if got is None and want is None:
        return 0.0
    if got is None or want is None:
        return float("inf")
    got = np.asarray(got, np.float64)
    g = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    return g if np.isfinite(g) else float("inf")


def compare(outputs: dict, ref: list, order) -> dict:
    """``{"count_mismatches", "image_rel_gap", "images"}`` of the window's
    outputs against the reference per pool chunk."""
    mism, worst, n_img = 0, 0.0, 0
    if "calls" in outputs:
        for c in outputs["calls"]:
            want_n = [ref[int(order[i])][1] for i in range(len(c["counts"]))]
            mism += sum(int(a != b) for a, b in zip(c["counts"], want_n))
            imgs = [ref[int(order[i])][0] for i, n in enumerate(want_n) if n > 0]
            want = np.sum(imgs, axis=0) if imgs else None
            worst = max(worst, image_gap(c["image"], want))
            n_img += int(want is not None)
    else:
        for k, n, img in outputs["results"].values():
            want_img, want_n = ref[k]
            mism += int(n != want_n)
            if want_n > 0:
                worst = max(worst, image_gap(img, want_img))
                n_img += 1
    return {"count_mismatches": mism, "image_rel_gap": worst, "images": n_img}


def check(ctx, win) -> list:
    t0 = time.perf_counter()
    with tf32(False):
        ref = reference_images(ctx, ctx.device)
    order = ctx.state.get("order")
    found = compare(win.outputs, ref, order)
    ctx.note(f"reference: {len(ref)} chunks in {time.perf_counter() - t0:.3f} s, "
             f"windows {[n for _, n in ref]}, {found['images']} images compared")
    if "root" in ctx.state:
        shutil.rmtree(ctx.state.pop("root"), ignore_errors=True)
    lim = ctx.config["limits"]
    gap = found["image_rel_gap"]
    return [Check("count_mismatches", float(found["count_mismatches"]),
                  float(lim["count_mismatches"])),
            Check("image_rel_gap", gap if np.isfinite(gap) else 1e300,
                  float(lim["image_rel_gap"])),
            Check("images_compared_short", 0.0 if found["images"] else 1.0, 0.0)]


def control_outputs(ctx) -> dict:
    """The control put in the program's place: the reference in the
    precision just below the configuration's (float32 with TF32 matrix
    products, where the program runs float32 with TF32 off), in the form of
    the window's outputs: one directory call over as many files as a
    window's first call of ``ctx.seconds`` reads, or
    one request a pool chunk."""
    with tf32(True):
        low = reference_images(ctx, ctx.device)
    if ctx.traffic["driver"] == "directory":
        order = ctx.state["order"][:_call_size(ctx.traffic, ctx.seconds, 0.0, 0)]
        counts = [low[int(k)][1] for k in order]
        imgs = [low[int(k)][0] for k in order if low[int(k)][1] > 0]
        return {"calls": [{"counts": counts, "image": np.sum(imgs, axis=0) if imgs else None,
                           "quarantined": []}]}
    return {"results": {k: (k, n, img) for k, (img, n) in enumerate(low)}}
