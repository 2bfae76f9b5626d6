#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``das_diff_veh_tpu_torch``) on one card.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, each of which must pass:

1. device: require a CUDA device; print its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
2. build: compile every CUDA kernel of the port from ``csrc/`` (one nvcc per
   source, all started together);
3. kernel vs plain: the trajectory gather kernel against its plain PyTorch
   version on the card, float32, at the main-path shapes (forward and
   backward cuts, starts truncated at the record end, the backward empty
   slice); the cut is a pure copy, so the two must be ``torch.equal``;
4. main path: one real-size chunk (140 channels x 30000 samples, 2 minutes at
   250 Hz, float32) through ``process_chunk(method="xcorr")`` on the card,
   held against the port's own CPU float64 run of the same scene;
5. times: the chunk's wall time and the kernel's time, its plain version's
   time and its bound, on the inputs the main path gave it;
6. with ``--profile``: device time by kernel over one warm chunk (and, in
   phase 8, over one warm all-pairs call);
7. all-pairs kernels vs plain: the cross-spectra kernel (B3) and the lag-axis
   peak kernel (B4) against their plain versions on the card at edge shapes;
8. all-pairs path: ``xcorr_all_pairs_peak`` at BASELINE config 4 (10000
   channels x 4096 samples at 1 kHz, wlen 1024, float32) on the card, with
   its launch counts, held against the card's plain path and a float64
   NumPy computation; then ``xcorr_all_pairs`` in the lag domain at 4096 x
   4096 channels with 129 lags, held against its plain path;
9. all-pairs times: B3 and B4 on the inputs the path gave them, beside their
   bounds, their plain versions and one PyTorch call computing the same.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside the tensor cores (data sheet)

# The float32 card run against the float64 CPU run of the same chunk: the
# record's FFT band-passes (48750-point transforms of the padded 2-minute
# record) and the gather's FFTs round at ~1e-7 relative per operation, which
# leaves ~1e-5 on the peak-normalised image (9.5e-6 for the port's own CPU
# float32 run of this scene, tools/port_parity.py).  The window starts are decided on
# float64 axes on both devices, so no start flips between the runs.  1e-3
# leaves a factor 100 for cuFFT's and cuBLAS's other summation orders.
IMAGE_PEAK_REL_TOL = 1e-3
SCENE = dict(nch=140, duration=120.0, n_vehicles=6, seed=2, speed_range=(12.0, 18.0))
WARM_RUNS = 5

# BASELINE config 4: 10000 channels at 1 kHz, a 4096-sample record, 1024-sample
# windows at 50 % overlap (7 windows, 513 frequencies); the entry's defaults
# (src_chunk=64, lagmax_block=512) give ceil(10000/64) = 157 launches of B3
# and 157 * ceil(10000/512) = 3140 of B4.
ALLPAIRS = dict(nch=10000, nt=4096, seed=3, wlen=1024)
ALLPAIRS_LAUNCHES = {"traj_gather": 0, "cross_spectra": 157, "lag_absmax": 3140}
LAG_DOMAIN = dict(nch=4096, nt=4096, seed=3, wlen=1024, lag_keep=64)
LAG_DOMAIN_LAUNCHES = {"traj_gather": 0, "cross_spectra": 32, "lag_absmax": 0}
HOST_F64_ROWS = (0, 1, 2, 4999, 5000, 9997, 9998, 9999)
# The float32 card run against float64 NumPy on the same record: each of the
# rfft (1024 points), the 7-window mean and the irfft rounds at ~1e-7
# relative, and the peaks are normalised by the largest (a zero-lag
# autocorrelation, ~1000 for unit white noise), so ~1e-7 is expected (7.2e-8
# for the port's CPU float32 run at 400 channels).  1e-5 leaves a factor 100
# for cuFFT's other rounding; the ceiling set for this check is 1e-4.
ALLPAIRS_PEAK_REL_TOL = 1e-5
SLEEP_CYCLES = 20_000_000          # device sleep ahead of each timed group (event_ms)


def log(msg: str) -> None:
    print(msg, flush=True)


def peak_rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.double().cpu(), ref.double().cpu()
    return float((a - ref).abs().max() / ref.abs().max().clamp(min=1e-300))


def device_ms(fn, inner: int = 50, replays: int = WARM_RUNS * 2) -> float:
    """Device time per call of ``fn``: ``inner`` calls captured in one CUDA
    graph, so the host's per-call overhead stays out of the reading; each
    of ``replays`` warm replays is timed between CUDA events, and the
    median replay is divided by ``inner``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per_replay = []
    for _ in range(replays):
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        per_replay.append(start.elapsed_time(stop))
    return float(np.median(per_replay)) / inner


def event_ms(fn, reps: int, groups: int = WARM_RUNS) -> float:
    """Device time per call of ``fn`` for calls too large for a CUDA graph of
    many: ``groups`` groups of ``reps`` calls back to back between CUDA
    events, each group queued behind a device sleep so that the host's
    enqueue time stays out of the reading; the median group over ``reps``."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per_group = []
    for _ in range(groups):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        per_group.append(start.elapsed_time(stop) / reps)
    return float(np.median(per_group))


def _counted():
    from das_diff_veh_tpu_torch.ops import cross_spectra, lag_absmax, traj_gather

    return {"traj_gather": traj_gather, "cross_spectra": cross_spectra,
            "lag_absmax": lag_absmax}


def reset_counts() -> None:
    for mod in _counted().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in _counted().items()}


@contextmanager
def swapped_launches(cross_spectra_fn, lag_absmax_fn):
    """Inside: the all-pairs wrappers call these in place of the kernels'
    launch functions (``cross_spectra_cuda``, ``lag_absmax_cuda``)."""
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.ops import lag_absmax as la

    saved = cs.cross_spectra_cuda, la.lag_absmax_cuda
    cs.cross_spectra_cuda, la.lag_absmax_cuda = cross_spectra_fn, lag_absmax_fn
    try:
        yield
    finally:
        cs.cross_spectra_cuda, la.lag_absmax_cuda = saved


def plain_kernels():
    """Inside: the kernels' plain versions run on the card instead of the
    kernels (the card's plain path)."""
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.ops import lag_absmax as la

    return swapped_launches(cs.cross_spectra_plain, la.lag_absmax_plain)


def first_inputs(captured: dict):
    """Inside: the kernels launch as always, and the arguments of the first
    launch of B3 and of B4 are kept in ``captured``."""
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.ops import lag_absmax as la

    def keeping(name, launch):
        def call(*args):
            captured.setdefault(name, args)
            return launch(*args)
        return call

    return swapped_launches(keeping("cross_spectra", cs.cross_spectra_cuda),
                            keeping("lag_absmax", la.lag_absmax_cuda))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN where NaN (``torch.equal`` counts NaN unequal)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan]))


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke run needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)          # the card and its power limit, as nvidia-smi gives them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return {"nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> dict:
    from das_diff_veh_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build_all()
    wall = time.perf_counter() - t0
    for name, out in kernels.build_log.items():
        log(f"nvcc {name}: {kernels.build_seconds[name]:.2f} s\n{out.strip()}")
    log(f"build: {wall:.2f} s for {len(kernels.SOURCES)} source(s)")
    return {"build_s": wall, "per_source_s": dict(kernels.build_seconds)}


def phase_kernel_vs_plain() -> dict:
    """Kernel against plain version at the main-path gather shapes: 64 window
    slots of 37 channels x 2000 samples, nsamp=999, wlen=500, offset=250."""
    from das_diff_veh_tpu_torch.ops import traj_gather as tg

    gen = torch.Generator(device="cuda").manual_seed(7)
    nb, nch, nt, nsamp, wlen, offset, pivot = 64, 37, 2000, 999, 500, 250, 28
    nwin = (nsamp - wlen) // offset + 1
    rec = torch.randn((nb, nch, nt), generator=gen, device="cuda", dtype=torch.float32)
    far = torch.arange(29, 36, device="cuda")
    left = torch.arange(10, 28, device="cuda")
    ri = lambda lo, hi, k: torch.randint(lo, hi, (nb, k), generator=gen, device="cuda")
    cases = {
        "forward": (far, ri(0, nt - nsamp, far.numel()), False),
        "forward_truncated_at_end": (far, ri(nt - nsamp, nt + 1, far.numel()), False),
        "backward": (left, ri(nsamp, nt + 1, left.numel()), True),
        "backward_truncated_past_end": (left, ri(nt, nt + 400, left.numel()), True),
        "backward_empty_slice": (left, ri(0, nsamp, left.numel()), True),
    }
    out = {}
    for name, (ch, dt_idx, backward) in cases.items():
        scal = tg.traj_scalars(dt_idx, ch, nch, nt, nsamp, backward).contiguous()
        k_ch, k_pv = tg.pack_windows_cuda(rec, scal, pivot, nwin, wlen, offset)
        p_ch, p_pv = tg.pack_windows_plain(rec, scal, pivot, nwin, wlen, offset)
        torch.cuda.synchronize()
        equal = torch.equal(k_ch, p_ch) and torch.equal(k_pv, p_pv)
        n_valid = int((((torch.arange(nwin, device="cuda") * offset + wlen)
                        <= scal[..., 1:2]).sum()))
        err = max(float((k_ch - p_ch).abs().max()), float((k_pv - p_pv).abs().max()))
        log(f"kernel vs plain [{name}]: equal={equal} max_abs_err={err} "
            f"valid windows {n_valid}/{nb * ch.numel() * nwin}")
        if not equal:
            raise AssertionError(f"traj_gather kernel != plain version in case {name}")
        if name == "backward_empty_slice" and (k_ch.abs().max() != 0 or n_valid != 0):
            raise AssertionError("backward empty slice must give all-zero windows")
        out[name] = {"equal": equal, "max_abs_err": err, "valid_windows": n_valid}
    return out


def _main_path_inputs():
    from das_diff_veh_tpu_torch.io.synthetic import SceneConfig, synthesize_section

    t0 = time.perf_counter()
    section, _ = synthesize_section(SceneConfig(**SCENE))
    log(f"scene {tuple(section.data.shape)} synthesized in "
        f"{time.perf_counter() - t0:.1f} s")
    return section


def phase_main_path(section) -> dict:
    """One chunk on the card, held against the port's CPU float64 run."""
    from das_diff_veh_tpu_torch.config import PipelineConfig
    from das_diff_veh_tpu_torch.ops import traj_gather as tg
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    cfg = PipelineConfig()
    sec32 = section.to(dtype=torch.float32)
    # record the kernel's inputs as the main path gives them (for phase 5);
    # the wrapper counts its launches as always
    captured = []
    launch = tg.pack_windows_cuda

    def recording(*args):
        captured.append(args)
        return launch(*args)

    tg.pack_windows_cuda = recording
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = process_chunk(sec32, cfg, method="xcorr", device="cuda")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_counts()
    finally:
        tg.pack_windows_cuda = launch
    launches = counts["traj_gather"]
    log(f"main path: first chunk {first_s:.3f} s, launches {counts}, "
        f"n_windows {res.n_windows}")
    img = res.disp_image
    if counts != {"traj_gather": 2, "cross_spectra": 0, "lag_absmax": 0}:
        raise AssertionError(f"expected 2 traj_gather launches per chunk and no other, "
                             f"got {counts}")
    if res.n_windows <= 0:
        raise AssertionError("the chunk isolated no window: the image would be all zero")
    if tuple(img.shape) != (cfg.dispersion.n_vels, cfg.dispersion.n_freqs):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not (img.is_cuda and img.dtype == torch.float32 and bool(torch.isfinite(img).all())):
        raise AssertionError("image must be a finite float32 tensor on the card")

    t0 = time.perf_counter()
    ref = process_chunk(section, cfg, method="xcorr", device="cpu")
    cpu_s = time.perf_counter() - t0
    valid_eq = bool(torch.equal(res.batch.valid.cpu(), ref.batch.valid))
    tracks_eq = bool(torch.equal(res.tracks.valid.cpu(), ref.tracks.valid))
    img_err = peak_rel(img, ref.disp_image)
    vsg_err = peak_rel(res.vsg_stack, ref.vsg_stack)
    log(f"vs CPU float64 ({cpu_s:.1f} s): n_windows {res.n_windows} vs {ref.n_windows}, "
        f"batch.valid equal {valid_eq}, tracks.valid equal {tracks_eq}, image "
        f"peak-rel {img_err:.3e} (tol {IMAGE_PEAK_REL_TOL}), vsg_stack peak-rel {vsg_err:.3e}")
    if res.n_windows != ref.n_windows or not valid_eq:
        raise AssertionError("window selection differs from the CPU float64 run")
    if not img_err <= IMAGE_PEAK_REL_TOL:
        raise AssertionError(f"image differs from the CPU float64 run by {img_err:.3e}")
    return {"first_chunk_s": first_s, "launches": launches, "n_windows": res.n_windows,
            "valid_slots": res.batch.valid.nonzero().flatten().tolist(),
            "tracks_valid_equal": tracks_eq, "image_peak_rel_err": img_err,
            "vsg_peak_rel_err": vsg_err, "cpu_float64_s": cpu_s,
            "captured": captured, "sec32": sec32, "cfg": cfg}


def phase_times(main: dict) -> dict:
    from das_diff_veh_tpu_torch.ops import traj_gather as tg
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    walls = []
    for _ in range(WARM_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        process_chunk(main["sec32"], main["cfg"], method="xcorr", device="cuda")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    # the kernel and its plain version on the inputs of the chunk's two launches
    k_ms = p_ms = 0.0
    nbytes = 0
    err = 0.0
    shapes = []
    for rec, scal, pivot, nwin, wlen, offset in main["captured"]:
        k = tg.pack_windows_cuda(rec, scal, pivot, nwin, wlen, offset)
        p = tg.pack_windows_plain(rec, scal, pivot, nwin, wlen, offset)
        if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
            raise AssertionError("kernel != plain version on the main-path inputs")
        err = max(err, float((k[0] - p[0]).abs().max()), float((k[1] - p[1]).abs().max()))
        kernel = lambda: tg.pack_windows_cuda(rec, scal, pivot, nwin, wlen, offset)
        plain = lambda: tg.pack_windows_plain(rec, scal, pivot, nwin, wlen, offset)
        k_ms += device_ms(kernel)
        p_ms += device_ms(plain)
        nbytes += tg.bytes_moved(scal, rec.shape[1], rec.shape[2], pivot, nwin, wlen, offset)
        shapes.append({"record": list(rec.shape), "nk": scal.shape[1], "nwin": nwin,
                       "wlen": wlen, "offset": offset})
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"chunk wall ms over {WARM_RUNS} warm runs: {[round(w, 3) for w in walls]} "
        f"(median {float(np.median(walls)):.3f})")
    log(f"traj_gather per chunk (2 launches, L2-warm inputs, device time from CUDA "
        f"graph replays): kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, bound "
        f"{bound_ms:.5f} ms ({nbytes} B at 3.35 TB/s)")
    kernel = {"name": "traj_gather_pack", "route": "cuda",
              "source": "das_diff_veh_tpu_torch/csrc/traj_gather.cu",
              "replaces": "das_diff_veh_tpu/ops/pallas_gather.py:121",
              "launches": main["launches"], "max_abs_err": err, "ms": k_ms,
              "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": "bytes",
              "library_ms": None}
    return {"chunk_wall_ms": walls, "chunk_wall_ms_median": float(np.median(walls)),
            "kernels": [kernel], "bytes": nbytes, "launch_shapes": shapes}


def profile_call(label: str, fn) -> dict:
    """Device time by operator over one warm call of ``fn`` (``--profile``):
    the device's busy share of the call's wall time and the largest
    consumers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies): an operator's row repeats the
    # device time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    n_kernels = sum(r[2] for r in rows)
    log(f"profile of {label}: wall {wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %), {n_kernels} kernels and copies")
    for key, ms, count in rows[:15]:
        log(f"  {ms:10.4f} ms  x{count:<6d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_ops": n_kernels,
            "top": [{"op": k, "device_ms": m, "count": c} for k, m, c in rows[:40]]}


def phase_profile(main: dict) -> dict:
    """One warm chunk under the profiler."""
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    return profile_call("one chunk", lambda: process_chunk(
        main["sec32"], main["cfg"], method="xcorr", device="cuda"))


def phase_allpairs_kernels_vs_plain() -> dict:
    """B3 and B4 against their plain versions on the card at edge shapes.
    Both must be equal bit for bit: B3 rounds every product and sum where its
    plain version does, in the same order (no FMA contraction), and B4's max
    is a selection."""
    from das_diff_veh_tpu_torch.ops import all_pairs as ap
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.ops import lag_absmax as la

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    # (m, nall, nwin, nf, win_block): one source row; receivers off the
    # 16-row tile; 513 frequencies (off the 32-lane block); a ragged slab
    # (7 = 3 + 3 + 1); one slab; and the automatic 32-window slabs past 48
    b3_cases = {"m1_ragged_slab": (1, 10000 - 7, 7, 513, 3),
                "ragged_tiles_one_slab": (64, 1001, 7, 513, None),
                "auto_slabs": (9, 50, 50, 33, None)}
    for name, (m, nall, nwin, nf, wb) in b3_cases.items():
        wb = ap._resolve_win_block(nwin, wb)
        src = torch.randn((m, nwin, nf), generator=gen, device="cuda", dtype=torch.complex64)
        rcv = torch.randn((nall, nwin, nf), generator=gen, device="cuda",
                          dtype=torch.complex64)
        k = cs.cross_spectra_cuda(src, rcv, nwin, wb)
        p = cs.cross_spectra_plain(src, rcv, nwin, wb)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        log(f"B3 vs plain [{name}: m={m} nall={nall} nwin={nwin} nf={nf} win_block={wb}]: "
            f"equal={torch.equal(k, p)} max_abs_err={err}")
        if not torch.equal(k, p):
            raise AssertionError(f"cross_spectra kernel != plain version in case {name}")
        out[f"cross_spectra/{name}"] = {"equal": True, "max_abs_err": err}
    for nlag in (1024, 1023, 5):
        lag = torch.randn((4099, nlag), generator=gen, device="cuda")
        lag[3, nlag // 2] = float("nan")
        lag[5] = 0.0
        k = la.lag_absmax_cuda(lag)
        p = la.lag_absmax_plain(lag)
        torch.cuda.synchronize()
        equal = same_bits(k, p) and bool(torch.isnan(k[3])) and float(k[5]) == 0.0
        log(f"B4 vs plain [npairs=4099 nlag={nlag}, a NaN row, an all-zero row]: "
            f"equal={equal}")
        if not equal:
            raise AssertionError(f"lag_absmax kernel != plain version at nlag={nlag}")
        out[f"lag_absmax/nlag{nlag}"] = {"equal": True}
    return out


def _host_peak_f64(record: np.ndarray, rows, wlen: int) -> np.ndarray:
    """Peak |xcorr| of ``rows`` against every channel in float64 NumPy: the
    window-mean cross-spectrum of each pair, irfft, max |.| over the lags."""
    x = record.astype(np.float64)
    offset = wlen // 2
    nwin = (x.shape[1] - wlen) // offset + 1
    spec = np.fft.rfft(x[:, np.arange(nwin)[:, None] * offset + np.arange(wlen)], axis=-1)
    out = np.empty((len(rows), x.shape[0]))
    for i, s in enumerate(rows):
        cross = (spec[s][None] * spec.conj()).mean(axis=1)
        out[i] = np.abs(np.fft.irfft(cross, n=wlen, axis=-1)).max(axis=-1)
    return out


def phase_allpairs_path(profile: bool = False) -> dict:
    """``xcorr_all_pairs_peak`` at config 4 on the card: launch counts, the
    card's plain path on the first and the ragged last source chunk, float64
    NumPy on 8 source rows, B3's per-pair invariance, the warm wall time and,
    with ``profile``, device time by kernel over one warm call."""
    from das_diff_veh_tpu_torch.ops import all_pairs as ap
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    nch, wlen = ALLPAIRS["nch"], ALLPAIRS["wlen"]
    rec = make_ambient_record(nch, ALLPAIRS["nt"], seed=ALLPAIRS["seed"])
    captured = {}
    with first_inputs(captured):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        peak = ap.xcorr_all_pairs_peak(rec, wlen)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_counts()
    log(f"all-pairs path: xcorr_all_pairs_peak {tuple(rec.shape)} wlen={wlen} first call "
        f"{first_s:.3f} s, launches {counts}")
    if counts != ALLPAIRS_LAUNCHES:
        raise AssertionError(f"expected launches {ALLPAIRS_LAUNCHES}, got {counts}")
    if not (peak.is_cuda and peak.dtype == torch.float32 and tuple(peak.shape) == (nch, nch)
            and bool(torch.isfinite(peak).all())):
        raise AssertionError("the peaks must be a finite (nch, nch) float32 tensor on the card")

    wf = ap._window_spectra(rec, wlen, 0.5)
    plain_equal = {}
    chunk = 64                                   # the entry's default src_chunk
    last = slice((nch - 1) // chunk * chunk, nch)  # 16 rows at config 4
    for label, rows in (("first_chunk", slice(0, chunk)), ("ragged_last_chunk", last)):
        with plain_kernels():
            ref = ap.peak_from_spectra(wf[rows], wf, wlen, chunk, True)
        plain_equal[label] = bool(torch.equal(peak[rows], ref))
    log(f"vs the card's plain path (kernels' plain versions, same shapes): {plain_equal}")
    if not all(plain_equal.values()):
        raise AssertionError(f"all-pairs peaks differ from the card's plain path: {plain_equal}")

    t0 = time.perf_counter()
    host = _host_peak_f64(rec.cpu().numpy(), HOST_F64_ROWS, wlen)
    got = peak[list(HOST_F64_ROWS)].double().cpu().numpy()
    f64_err = float(np.abs(got - host).max() / np.abs(host).max())
    f64_elem = float((np.abs(got - host) / host).max())
    log(f"vs float64 NumPy ({len(HOST_F64_ROWS)} source rows x {nch}, "
        f"{time.perf_counter() - t0:.1f} s): peak-rel {f64_err:.3e} "
        f"(tol {ALLPAIRS_PEAK_REL_TOL}), largest pair-relative {f64_elem:.3e}")
    if not f64_err <= ALLPAIRS_PEAK_REL_TOL:
        raise AssertionError(f"peaks differ from float64 NumPy by {f64_err:.3e}")

    nwin = wf.shape[1]
    sub = slice(nch // 10, 3 * nch // 10 + 1)
    k64 = cs.cross_spectra_cuda(wf[:64], wf, nwin, nwin)
    k16 = cs.cross_spectra_cuda(wf[:16], wf, nwin, nwin)
    ksub = cs.cross_spectra_cuda(wf[:16], wf[sub].contiguous(), nwin, nwin)
    invariant = bool(torch.equal(k64[:16], k16) and torch.equal(k16[:, sub], ksub))
    log(f"B3 per-pair invariance (64 vs 16 source rows, receivers {sub.start}:{sub.stop}): "
        f"{invariant}")
    if not invariant:
        raise AssertionError("B3's result for a pair depends on the launch's shape")
    del k64, k16, ksub, wf, ref, peak

    walls = []
    torch.cuda.synchronize()
    held_bytes = torch.cuda.memory_allocated()   # the record and the kept B3/B4 inputs
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ap.xcorr_all_pairs_peak(rec, wlen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak_bytes = torch.cuda.max_memory_allocated()
    log(f"all-pairs wall ms over 3 warm calls: {[round(w, 3) for w in walls]} (median "
        f"{float(np.median(walls)):.3f}), device memory peak {peak_bytes} B "
        f"({held_bytes} B held before the calls)")
    prof = profile_call("xcorr_all_pairs_peak at config 4",
                        lambda: ap.xcorr_all_pairs_peak(rec, wlen)) if profile else None
    return {"first_call_s": first_s, "launches": counts, "plain_path_equal": plain_equal,
            "f64_peak_rel_err": f64_err, "f64_largest_pair_rel_err": f64_elem,
            "b3_pair_invariant": invariant, "wall_ms": walls,
            "wall_ms_median": float(np.median(walls)), "device_memory_peak_bytes": peak_bytes,
            "device_memory_held_bytes": held_bytes, "profile": prof, "captured": captured}


def phase_lag_domain() -> dict:
    """``xcorr_all_pairs`` at 4096 x 4096 channels keeping 129 lags (an
    8.66 GB result) on the card: launch counts and the card's plain path on
    the first and the last source chunk."""
    from das_diff_veh_tpu_torch.ops import all_pairs as ap
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    nch, wlen, keep = LAG_DOMAIN["nch"], LAG_DOMAIN["wlen"], LAG_DOMAIN["lag_keep"]
    rec = make_ambient_record(nch, LAG_DOMAIN["nt"], seed=LAG_DOMAIN["seed"])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    lags = ap.xcorr_all_pairs(rec, wlen, lag_keep=keep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"lag-domain path: xcorr_all_pairs {tuple(rec.shape)} wlen={wlen} lag_keep={keep}: "
        f"{tuple(lags.shape)} in {wall:.3f} s (first call), launches {counts}")
    if counts != LAG_DOMAIN_LAUNCHES:
        raise AssertionError(f"expected launches {LAG_DOMAIN_LAUNCHES}, got {counts}")
    if not (lags.is_cuda and lags.dtype == torch.float32
            and tuple(lags.shape) == (nch, nch, 2 * keep + 1)
            and bool(torch.isfinite(lags).all())):
        raise AssertionError("the lags must be a finite (nch, nch, 129) float32 tensor")
    wf = ap._window_spectra(rec, wlen, 0.5)
    mid = wlen // 2
    equal = {}
    with plain_kernels():
        cross = ap._make_cross_fn(wf, True, ap._resolve_win_block(wf.shape[1], None))
        chunk = 128                              # the entry's default src_chunk
        for label, rows in (("first_chunk", slice(0, chunk)),
                            ("last_chunk", slice(nch - chunk, nch))):
            c = torch.fft.irfft(cross(wf[rows]), n=wlen, dim=-1)
            ref = torch.roll(c, mid, dims=-1)[..., mid - keep:mid + keep + 1]
            equal[label] = bool(torch.equal(lags[rows], ref))
    log(f"vs the card's plain path: {equal}")
    if not all(equal.values()):
        raise AssertionError(f"lag-domain result differs from the card's plain path: {equal}")
    return {"first_call_s": wall, "launches": counts, "plain_path_equal": equal,
            "result_bytes": lags.numel() * 4}


def _bound(nbytes: float, ops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_allpairs_times(path: dict) -> list:
    """B3 and B4 on the inputs of their first launch on the config-4 path
    (single launches between CUDA events; each output is ~2.6 GB for B3, too
    large for a CUDA graph of many calls), beside their bounds, their plain
    versions and one PyTorch call computing the same function."""
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.ops import lag_absmax as la

    src, rcv, nwin, wb = path["captured"]["cross_spectra"]
    (lag,) = path["captured"]["lag_absmax"]
    m, nall, nf = src.shape[0], rcv.shape[0], src.shape[2]
    k, p = cs.cross_spectra_cuda(src, rcv, nwin, wb), cs.cross_spectra_plain(src, rcv, nwin, wb)
    b3_err = float((k - p).abs().max())
    if not torch.equal(k, p):
        raise AssertionError("B3 != plain version on the path's inputs")
    del k, p
    b3 = {"ms": event_ms(lambda: cs.cross_spectra_cuda(src, rcv, nwin, wb), reps=5),
          "plain_ms": event_ms(lambda: cs.cross_spectra_plain(src, rcv, nwin, wb), reps=2),
          "library_ms": event_ms(lambda: torch.einsum("swf,rwf->srf", src, rcv.conj()) / nwin,
                                 reps=5)}
    b3_bound, b3_by = _bound(cs.bytes_moved(m, nall, nwin, nf), cs.flops(m, nall, nwin, nf))
    npairs, nlag = lag.shape
    k, p = la.lag_absmax_cuda(lag), la.lag_absmax_plain(lag)
    if not same_bits(k, p):
        raise AssertionError("B4 != plain version on the path's inputs")
    b4_err = float((k - p).abs().max())
    inf = float("inf")
    b4 = {"ms": event_ms(lambda: la.lag_absmax_cuda(lag), reps=50),
          "plain_ms": event_ms(lambda: la.lag_absmax_plain(lag), reps=50),
          "library_ms": event_ms(lambda: torch.linalg.vector_norm(lag, ord=inf, dim=-1),
                                 reps=50)}
    b4_bound, b4_by = _bound(la.bytes_moved(npairs, nlag), 2 * npairs * nlag)
    log(f"B3 per launch (m={m}, nall={nall}, nwin={nwin}, nf={nf}, win_block={wb}): kernel "
        f"{b3['ms']:.4f} ms, plain {b3['plain_ms']:.4f} ms, einsum {b3['library_ms']:.4f} ms, "
        f"bound {b3_bound:.4f} ms ({b3_by})")
    log(f"B4 per launch (npairs={npairs}, nlag={nlag}): kernel {b4['ms']:.5f} ms, plain "
        f"{b4['plain_ms']:.5f} ms, vector_norm {b4['library_ms']:.5f} ms, bound "
        f"{b4_bound:.5f} ms ({b4_by})")
    launches = path["launches"]
    return [
        {"name": "cross_spectra", "route": "cuda",
         "source": "das_diff_veh_tpu_torch/csrc/cross_spectra.cu",
         "replaces": "das_diff_veh_tpu/ops/pallas_xcorr.py:230",
         "launches": launches["cross_spectra"], "max_abs_err": b3_err, **b3,
         "bound_ms": b3_bound, "bound_by": b3_by},
        {"name": "lag_absmax", "route": "cuda",
         "source": "das_diff_veh_tpu_torch/csrc/lag_absmax.cu",
         "replaces": "das_diff_veh_tpu/ops/pallas_xcorr.py:137",
         "launches": launches["lag_absmax"], "max_abs_err": b4_err, **b4,
         "bound_ms": b4_bound, "bound_by": b4_by},
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm chunk and one warm all-pairs call "
                         "with torch.profiler")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    results = {}
    try:
        results["device"] = phase_device()
        import das_diff_veh_tpu_torch  # noqa: F401  (fails outside the repository)
        results["build"] = phase_build()
        results["kernel_vs_plain"] = phase_kernel_vs_plain()
        section = _main_path_inputs()
        main_path = phase_main_path(section)
        results["times"] = phase_times(main_path)
        if args.profile:
            results["profile"] = phase_profile(main_path)
        results["main_path"] = {k: v for k, v in main_path.items()
                                if k not in ("captured", "sec32", "cfg")}
        del main_path
        results["allpairs_kernels_vs_plain"] = phase_allpairs_kernels_vs_plain()
        allpairs = phase_allpairs_path(profile=args.profile)
        results["lag_domain"] = phase_lag_domain()
        results["times"]["kernels"] += phase_allpairs_times(allpairs)
        results["allpairs"] = {k: v for k, v in allpairs.items() if k != "captured"}
        del allpairs
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr, flush=True)
        return 1
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    dev = results["device"]
    log(json.dumps({"chunk": {"wall_ms_median": results["times"]["chunk_wall_ms_median"],
                              "n_windows": results["main_path"]["n_windows"],
                              "image_peak_rel_err": results["main_path"]["image_peak_rel_err"]}}))
    log(json.dumps({"allpairs": {k: results["allpairs"][k] for k in (
        "wall_ms_median", "device_memory_peak_bytes", "f64_peak_rel_err")}}))
    log(dev["nvidia_smi"])
    log(json.dumps({"kernels": results["times"]["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
