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
   slice) and at rows of 99 and 1250 floats (not multiples of 4, so the
   kernel's 16-byte stores straddle windows and rows); the cut is a pure
   copy, so the two must be ``torch.equal``;
4. main path: one real-size chunk (140 channels x 30000 samples, 2 minutes at
   250 Hz, float32) through ``process_chunk(method="xcorr")`` on the card,
   held against the port's own CPU float64 run of the same scene;
5. times: the chunk's wall time and the kernel's time, its plain version's
   time and its bound, on the inputs the main path gave it;
6. with ``--profile``: device time by kernel over one warm chunk (and, in
   phase 8, over one warm all-pairs call);
7. all-pairs kernels vs plain: the cross-spectra kernel (B3) in both tiers
   (complex64, and bf16 pairs) and the lag-axis peak kernel (B4) against
   their plain versions on the card at edge shapes;
8. all-pairs path: ``xcorr_all_pairs_peak`` at BASELINE config 4 (10000
   channels x 4096 samples at 1 kHz, wlen 1024, float32) on the card, with
   its launch counts, held against the card's plain path and a float64
   NumPy computation; again with ``precision="bf16"``, held against the
   card's bf16 plain path and the f32 peaks; B3's per-pair invariance in
   both tiers; then ``xcorr_all_pairs`` in the lag domain at 4096 x 4096
   channels with 129 lags, held against its plain path;
9. all-pairs times: B3 in both tiers and B4 on the inputs the path gave
   them, beside their bounds, their plain versions and one PyTorch call
   computing the same; B3 at the long-record entry's shapes (2048 channels
   x 61440 samples, 119 windows in slabs of 32);
10. dot kernel vs plain: the dot finish (B2) against its plain version on the
   card in both precision tiers, forward and swapped, at edge shapes (wlen
   250, 256, 64, 33 and 128; one window, 16 at wlen 256 and 64 at wlen 128,
   the joint cap's two corners; 64 slots of 18, 7 or 1 rows; rows truncated
   at the record end and backward empty slices): the f32 tier equal bit for
   bit, the bf16 tier (tensor cores) within 1e-5 peak-relative of the plain
   version and of a float64 evaluation of the same bfloat16 operands;
11. dot chunk: the chunk scene through ``process_chunk(method="xcorr")`` with
   a 1 s window and ``traj_gather_finish="dot"`` (2 launches of B2, none of
   B1), held against the port's CPU float64 run; the dot-vs-rfft image gap on
   the card; the same chunk in the bf16 tiers against the float32 one; then
   the chunk with 16 s windows, where the time-reversed launch reaches the
   image, against its CPU float64 run (its rows live, and the image moved
   when that launch returns zeros);
12. surface_wave chunk: the chunk scene through ``process_chunk(method=
   "surface_wave")`` against its CPU float64 run, and the phase-shift image
   of the dot chunk's stack against the CPU float64 one;
13. dot times: B2 per chunk in both tiers on the inputs the dot chunks gave
   it (held to its plain version again: f32 bit for bit, bf16 within 1e-5),
   beside its bound, the f32 tier's issue floor and its plain version; the
   rfft finish on the same inputs as a yardstick; the warm wall times of the
   dot and surface_wave chunks (``--profile`` adds a per-operator breakdown
   of each);
14. batch: ``run_directory`` over a folder of 8 full-size chunk files (the
   chunk scene at seeds 2-9, one planted degraded file, one poisoned, one
   garbage) with the health screen on: the accumulated image at prefetch
   depths 0 and 2, and after a resume, equal to a serial loop of
   ``process_chunk`` bit for bit; exactly the planted files quarantined
   (garbage at "load", poisoned at "compute") and one degraded; 2 launches
   of B1 per computed chunk; the health screen on the card ``torch.equal``
   to the CPU's; the trace's loader spans overlapping compute at depth 2;
   then chunks/s at depths 0 and 2 (median of 3 runs each, the reader's
   savgol pre-smooth on) and the host, staging and compute ms per file; all
   again with ``chunk_pipeline="fused"`` (the program cache emptied before
   each correctness run, so its first chunk captures beside the loader at
   depth 2), held to the same serial staged loop, its files/s in turns with
   the staged runs;
15. fused chunk: ``process_chunk`` with ``chunk_pipeline="fused"`` (one CUDA
   graph per geometry, ``pipeline/fused.py``) for the default, the dot (f32
   and bf16) and the surface_wave chunks at full size: every field
   ``torch.equal`` to the staged chunk (a continuous field that a library
   rounds otherwise on the capture stream is named and held within 1e-7),
   also on other data of the geometry; one program and one capture on the
   first call, none in 20 warm calls (20 dispatches); a zero-signal chunk
   through the cached program (``n_windows`` 0, finite image); no aliasing
   between results; the launches a replay recorded (B1 2, or B2 2) and the
   kernel names a profiled replay lists; fused and staged walls in turns
   (median, p90), device-busy share and kernels per chunk of one profiled
   replay and one staged chunk, warm-up and capture time, the graph's pool;
   the body under ``set_sync_debug_mode("error")``; ``clear_programs()``
   frees the device memory.

The line before the last is a JSON object ``{"kernels": [...]}``, after
``{"batch": {...}}``, ``{"fused": {...}}`` and the card's name and power
limit; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import dataclasses
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
ALLPAIRS_LAUNCHES = {"traj_gather": 0, "traj_dot": 0, "cross_spectra": 157, "lag_absmax": 3140}
LAG_DOMAIN = dict(nch=4096, nt=4096, seed=3, wlen=1024, lag_keep=64)
LAG_DOMAIN_LAUNCHES = {"traj_gather": 0, "traj_dot": 0, "cross_spectra": 32, "lag_absmax": 0}
HOST_F64_ROWS = (0, 1, 2, 4999, 5000, 9997, 9998, 9999)
# The float32 card run against float64 NumPy on the same record: each of the
# rfft (1024 points), the 7-window mean and the irfft rounds at ~1e-7
# relative, and the peaks are normalised by the largest (a zero-lag
# autocorrelation, ~1000 for unit white noise), so ~1e-7 is expected (7.2e-8
# for the port's CPU float32 run at 400 channels).  1e-5 leaves a factor 100
# for cuFFT's other rounding; the ceiling set for this check is 1e-4.
ALLPAIRS_PEAK_REL_TOL = 1e-5
# The bf16 peaks against the f32 ones: tests/test_precision.py's ring budget.
RING_BF16_BUDGET = 1e-2
# (m, nall, nwin, nf, win_block or None for the entry's default) of the B3
# edge cases, both tiers: one, 63 and 64 source rows (the resident group is
# 64); fewer receivers than one 16-row tile and 10000 - 7; 513 frequencies
# (16 segments of 32 and a one-frequency tail), 33 and 1 (a tail alone); a
# ragged slab (7 = 3 + 3 + 1); and the automatic 32-window slabs past 48
# windows, where the windows stream through the ring 7 at a time.
B3_CASES = {"m1_ragged_slab": (1, 10000 - 7, 7, 513, 3),
            "m63_one_slab": (63, 1001, 7, 513, None),
            "m64_nall9993": (64, 10000 - 7, 7, 513, None),
            "nall_below_tile_nf33": (64, 5, 7, 33, None),
            "nf1": (7, 300, 7, 1, None),
            "auto_slabs_nwin50": (9, 50, 50, 33, None),
            "auto_slabs_nwin119": (64, 200, 119, 513, None)}
# bench.py's long-record entry: 2048 channels x 61440 samples at wlen 1024
# (119 windows, slabs of 32, 32, 32 and 23), one launch of 64 source rows
LONG_RECORD = dict(nch=2048, nt=61440, seed=3, wlen=1024, m=64)
SLEEP_CYCLES = 20_000_000          # device sleep ahead of each timed group (event_ms)
CHUNK_LAUNCHES = {"traj_gather": 2, "traj_dot": 0, "cross_spectra": 0, "lag_absmax": 0}
# The dot chunk: GatherConfig(wlen=1.0, traj_gather_finish="dot") at 250 Hz gives
# wlen 250, nsamp 999, offset 125, nwin 6 (nwin*wlen^2 = 375000, inside both
# caps); "auto" takes B2 on both trajectory sides and B1 never.
DOT_WLEN_S = 1.0
DOT_LAUNCHES = {"traj_gather": 0, "traj_dot": 2, "cross_spectra": 0, "lag_absmax": 0}
# With the default 8 s windows the vehicle sits at the window's centre, so
# every time-reversed row (which ends delta_t before the vehicle reaches its
# channel) has less than time_window of record before it: a backward empty
# slice.  16 s windows at the default 8 s isolation spacing leave the rows
# near the pivot live, and the image then sees both B2 launches.
LIVE_WINDOW = dict(wlen_sw=16.0, temporal_spacing=8.0)
NO_LAUNCHES = {"traj_gather": 0, "traj_dot": 0, "cross_spectra": 0, "lag_absmax": 0}
# (name, wlen, nsamp) of the B2 edge cases; offset wlen//2.  The last is the
# gate's other corner (64 windows of 128, nwin*wlen^2 = 2^20): the kernel
# stages the windows 8 at a time.
DOT_CASES = (("wlen250_nwin6", 250, 999), ("wlen256_nwin16", 256, 15 * 128 + 256),
             ("wlen256_nwin1", 256, 300), ("wlen64_nwin8", 64, 7 * 32 + 64),
             ("wlen33_nwin1", 33, 40), ("wlen128_nwin64", 128, 63 * 64 + 128))
# B2's bf16 tier runs on the tensor cores: the bfloat16 products are exact in
# float32, but the tensor core sums them in its own order, so the tier is
# held at 1e-5 peak-relative per launch against its plain version's
# sequential float32 sum and against a float64 evaluation of the same
# bfloat16 operands (the bound at which tests/test_torch_traj_dot.py holds
# the plain version against the JAX bf16 kernel).
DOT_BF16_TOL = 1e-5
# The f32 tier's issue floor: its contract rounds every product and every sum
# on its own (no FMA), one instruction each, at 132 SMs x 128 lanes x 1.98 GHz
# (H100 SXM data sheet)
FP32_LANE_INSTR_PER_S = 132 * 128 * 1.98e9
# The bf16 chunk against the float32 card chunk: the image within the sum of
# the gather-dot (2e-2) and f-k (3e-2) bf16 budgets of tests/test_precision.py,
# the stack (which only the gather's tier reaches) within the gather-dot one.
GATHER_DOT_BF16_BUDGET = 2e-2
BF16_IMAGE_BUDGET = 5e-2
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense (data sheet)


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
    """Kernel name -> (wrapper module, its launch counter)."""
    from das_diff_veh_tpu_torch.ops import cross_spectra, lag_absmax, traj_gather

    return {"traj_gather": (traj_gather, "launches"),
            "traj_dot": (traj_gather, "dot_launches"),
            "cross_spectra": (cross_spectra, "launches"),
            "lag_absmax": (lag_absmax, "launches")}


def reset_counts() -> None:
    for mod, attr in _counted().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _counted().items()}


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
    rec = torch.randn((nb, nch, nt), generator=gen, device="cuda", dtype=torch.float32)
    far = torch.arange(29, 36, device="cuda")
    left = torch.arange(10, 28, device="cuda")
    ri = lambda lo, hi, k: torch.randint(lo, hi, (nb, k), generator=gen, device="cuda")
    main = (nsamp, wlen, offset)
    cases = {
        "forward": (far, ri(0, nt - nsamp, far.numel()), False, main),
        "forward_truncated_at_end": (far, ri(nt - nsamp, nt + 1, far.numel()), False, main),
        "backward": (left, ri(nsamp, nt + 1, left.numel()), True, main),
        "backward_truncated_past_end": (left, ri(nt, nt + 400, left.numel()), True, main),
        "backward_empty_slice": (left, ri(0, nsamp, left.numel()), True, main),
        # rows of 3 x 33 and 5 x 250 floats: not multiples of 4
        "rows_of_99": (far, ri(0, nt + 99, far.numel()), False, (99, 33, 33)),
        "rows_of_1250": (left, ri(0, nt + 750, left.numel()), True, (750, 250, 125)),
    }
    out = {}
    for name, (ch, dt_idx, backward, (nsamp, wlen, offset)) in cases.items():
        nwin = (nsamp - wlen) // offset + 1
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
    if counts != CHUNK_LAUNCHES:
        raise AssertionError(f"expected launches {CHUNK_LAUNCHES} per chunk, got {counts}")
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
    # the image's offsets (-150..0 m) take no row that B1 cuts on this scene
    # (the time-reversed rows of the isolated windows are empty slices), so
    # the stack is what holds the kernel's output against the CPU
    if not vsg_err <= IMAGE_PEAK_REL_TOL:
        raise AssertionError(f"vsg_stack differs from the CPU float64 run by {vsg_err:.3e}")
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
    valid = []
    for rec, scal, pivot, nwin, wlen, offset in main["captured"]:
        valid.append(int(((torch.arange(nwin, device=scal.device) * offset + wlen)
                          <= scal[..., 1:2]).sum()))
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
                       "wlen": wlen, "offset": offset, "valid_windows": valid[-1]})
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"chunk wall ms over {WARM_RUNS} warm runs: {[round(w, 3) for w in walls]} "
        f"(median {float(np.median(walls)):.3f})")
    log(f"traj_gather per chunk (2 launches, L2-warm inputs, device time from CUDA "
        f"graph replays): kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, bound "
        f"{bound_ms:.5f} ms ({nbytes} B at 3.35 TB/s); valid windows per launch {valid} "
        f"of {[s['nk'] * s['record'][0] * s['nwin'] for s in shapes]}")
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
    """B3 in both tiers and B4 against their plain versions on the card at
    edge shapes (``B3_CASES``).  Both must be equal bit for bit: B3 rounds
    every product and sum where its plain version does, in the same order
    (no FMA contraction), and B4's max is a selection."""
    from das_diff_veh_tpu_torch.ops import all_pairs as ap
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.ops import lag_absmax as la

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for name, (m, nall, nwin, nf, wb) in B3_CASES.items():
        wb = ap._resolve_win_block(nwin, wb)
        src = torch.randn((m, nwin, nf), generator=gen, device="cuda", dtype=torch.complex64)
        rcv = torch.randn((nall, nwin, nf), generator=gen, device="cuda",
                          dtype=torch.complex64)
        for tier, (s, r) in (("f32", (src, rcv)),
                             ("bf16", (cs.to_bf16_pairs(src), cs.to_bf16_pairs(rcv)))):
            k = cs.cross_spectra_cuda(s, r, nwin, wb)
            p = cs.cross_spectra_plain(s, r, nwin, wb)
            torch.cuda.synchronize()
            equal = bool(torch.equal(k, p))
            err = float((k - p).abs().max())
            log(f"B3 {tier} vs plain [{name}: m={m} nall={nall} nwin={nwin} nf={nf} "
                f"win_block={wb}]: equal={equal} max_abs_err={err}")
            if not equal:
                raise AssertionError(f"cross_spectra kernel ({tier}) != plain version in "
                                     f"case {name}")
            out[f"cross_spectra_{tier}/{name}"] = {"equal": True, "max_abs_err": err}
            del k, p
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


def _b3_pair_invariant(wf: torch.Tensor, precision: str) -> bool:
    """One pair's B3 bits do not depend on the launch's source rows (64 vs
    16) or its receiver set (all vs a slice)."""
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs

    nch, nwin = wf.shape[0], wf.shape[1]
    prep = cs.to_bf16_pairs if precision == "bf16" else (lambda x: x.contiguous())
    rcv = prep(wf)
    sub = slice(nch // 10, 3 * nch // 10 + 1)
    k64 = cs.cross_spectra_cuda(prep(wf[:64]), rcv, nwin, nwin)
    k16 = cs.cross_spectra_cuda(prep(wf[:16]), rcv, nwin, nwin)
    ksub = cs.cross_spectra_cuda(prep(wf[:16]), prep(wf[sub]), nwin, nwin)
    invariant = bool(torch.equal(k64[:16], k16) and torch.equal(k16[:, sub], ksub))
    log(f"B3 {precision} per-pair invariance (64 vs 16 source rows, receivers "
        f"{sub.start}:{sub.stop}): {invariant}")
    if not invariant:
        raise AssertionError(f"B3's {precision} result for a pair depends on the launch's "
                             f"shape")
    return invariant


def _allpairs_walls(rec: torch.Tensor, wlen: int, precision: str) -> dict:
    """Median wall time of 3 warm calls and the device memory peak."""
    from das_diff_veh_tpu_torch.ops import all_pairs as ap

    walls = []
    torch.cuda.synchronize()
    held_bytes = torch.cuda.memory_allocated()   # the record and the kept B3/B4 inputs
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ap.xcorr_all_pairs_peak(rec, wlen, precision=precision)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak_bytes = torch.cuda.max_memory_allocated()
    log(f"all-pairs {precision} wall ms over 3 warm calls: {[round(w, 3) for w in walls]} "
        f"(median {float(np.median(walls)):.3f}), device memory peak {peak_bytes} B "
        f"({held_bytes} B held before the calls)")
    return {"wall_ms": walls, "wall_ms_median": float(np.median(walls)),
            "device_memory_peak_bytes": peak_bytes, "device_memory_held_bytes": held_bytes}


def phase_allpairs_path(profile: bool = False) -> dict:
    """``xcorr_all_pairs_peak`` at config 4 on the card, f32 then bf16: launch
    counts, the card's plain path on the first and the ragged last source
    chunk, float64 NumPy on 8 source rows (f32), the f32 peaks (bf16), B3's
    per-pair invariance, the warm wall time and, with ``profile``, device
    time by kernel over one warm f32 call."""
    from das_diff_veh_tpu_torch.ops import all_pairs as ap
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    nch, wlen = ALLPAIRS["nch"], ALLPAIRS["wlen"]
    rec = make_ambient_record(nch, ALLPAIRS["nt"], seed=ALLPAIRS["seed"])
    wf = ap._window_spectra(rec, wlen, 0.5)
    chunk = 64                                   # the entry's default src_chunk
    last = slice((nch - 1) // chunk * chunk, nch)  # 16 rows at config 4
    out = {"captured": {}}
    peaks = {}
    for tier in ("f32", "bf16"):
        captured = {}
        with first_inputs(captured):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            peak = ap.xcorr_all_pairs_peak(rec, wlen, precision=tier)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counts = read_counts()
        log(f"all-pairs path ({tier}): xcorr_all_pairs_peak {tuple(rec.shape)} wlen={wlen} "
            f"first call {first_s:.3f} s, launches {counts}")
        if counts != ALLPAIRS_LAUNCHES:
            raise AssertionError(f"expected launches {ALLPAIRS_LAUNCHES}, got {counts}")
        if not (peak.is_cuda and peak.dtype == torch.float32
                and tuple(peak.shape) == (nch, nch) and bool(torch.isfinite(peak).all())):
            raise AssertionError("the peaks must be a finite (nch, nch) float32 tensor on "
                                 "the card")
        plain_equal = {}
        for label, rows in (("first_chunk", slice(0, chunk)), ("ragged_last_chunk", last)):
            with plain_kernels():
                ref = ap.peak_from_spectra(wf[rows], wf, wlen, chunk, True, precision=tier)
            plain_equal[label] = bool(torch.equal(peak[rows], ref))
        log(f"{tier} vs the card's plain path (kernels' plain versions, same shapes): "
            f"{plain_equal}")
        if not all(plain_equal.values()):
            raise AssertionError(f"{tier} all-pairs peaks differ from the card's plain path: "
                                 f"{plain_equal}")
        res = {"first_call_s": first_s, "launches": counts, "plain_path_equal": plain_equal}
        if tier == "f32":
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
            res.update(f64_peak_rel_err=f64_err, f64_largest_pair_rel_err=f64_elem)
        else:
            gap = peak_rel(peak, peaks["f32"])
            changed = not bool(torch.equal(peak, peaks["f32"]))
            log(f"bf16 peaks vs f32 peaks: peak-rel {gap:.3e} (budget {RING_BF16_BUDGET}), "
                f"bits changed {changed}")
            if not (changed and gap < RING_BF16_BUDGET):
                raise AssertionError(f"bf16 peaks vs f32: gap {gap:.3e}, changed {changed}")
            res.update(bf16_vs_f32_peak_rel=gap)
        res["b3_pair_invariant"] = _b3_pair_invariant(wf, tier)
        peaks[tier] = peak
        out[tier] = res
        out["captured"][tier] = captured
        del ref
    del wf, peaks, peak
    for tier in ("f32", "bf16"):
        out[tier].update(_allpairs_walls(rec, wlen, tier))
    out["profile"] = profile_call("xcorr_all_pairs_peak at config 4",
                                  lambda: ap.xcorr_all_pairs_peak(rec, wlen)) if profile else None
    return out


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


def _bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _b3_times(src, rcv, nwin: int, wb: int, precision: str, reps: int = 5) -> dict:
    """B3 on one launch's inputs: held against its plain version, then the
    kernel, the plain version and the einsum (on the spectra the tier's
    kernel sees, widened to complex64 beforehand) timed between CUDA events,
    beside the tier's bound."""
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs

    m, nall, nf = src.shape[0], rcv.shape[0], src.shape[2]
    k, p = cs.cross_spectra_cuda(src, rcv, nwin, wb), cs.cross_spectra_plain(src, rcv, nwin, wb)
    err = float((k - p).abs().max())
    if not torch.equal(k, p):
        raise AssertionError(f"B3 ({precision}) != plain version on m={m} nall={nall} "
                             f"nwin={nwin} nf={nf}")
    del k, p
    if precision == "bf16":
        s_c, r_c = (torch.view_as_complex(x.float()) for x in (src, rcv))
    else:
        s_c, r_c = src, rcv
    t = {"ms": event_ms(lambda: cs.cross_spectra_cuda(src, rcv, nwin, wb), reps=reps),
         "plain_ms": event_ms(lambda: cs.cross_spectra_plain(src, rcv, nwin, wb), reps=2),
         "library_ms": event_ms(lambda: torch.einsum("swf,rwf->srf", s_c, r_c.conj()) / nwin,
                                reps=reps)}
    # bf16 operands with float32 sums: the card's rate for that function is the
    # bf16 tensor cores', though B3 runs it on the CUDA cores
    rate = BF16_OPS_PER_S if precision == "bf16" else FP32_OPS_PER_S
    bound, by = _bound(cs.bytes_moved(m, nall, nwin, nf, precision),
                       cs.flops(m, nall, nwin, nf), rate)
    log(f"B3 {precision} per launch (m={m}, nall={nall}, nwin={nwin}, nf={nf}, "
        f"win_block={wb}): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, einsum "
        f"{t['library_ms']:.4f} ms, bound {bound:.4f} ms ({by})")
    return {**t, "bound_ms": bound, "bound_by": by, "max_abs_err": err}


def phase_long_record() -> dict:
    """B3 at the long-record entry's shapes, both tiers: 64 source rows of
    2048 channels x 119 windows, streamed in slabs of 32 (the windows pass
    through the kernel's ring 7 at a time)."""
    from das_diff_veh_tpu_torch.ops import all_pairs as ap
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    lr = LONG_RECORD
    rec = make_ambient_record(lr["nch"], lr["nt"], seed=lr["seed"])
    wf = ap._window_spectra(rec, lr["wlen"], 0.5)
    del rec
    nwin = wf.shape[1]
    wb = ap._resolve_win_block(nwin, None)
    out = {"nwin": nwin, "win_block": wb}
    for tier in ("f32", "bf16"):
        prep = cs.to_bf16_pairs if tier == "bf16" else (lambda x: x.contiguous())
        out[tier] = _b3_times(prep(wf[:lr["m"]]), prep(wf), nwin, wb, tier, reps=3)
    return out


def phase_allpairs_times(path: dict) -> list:
    """B3 in both tiers and B4 on the inputs of their first launch on the
    config-4 path (single launches between CUDA events; each output is
    ~2.6 GB for B3, too large for a CUDA graph of many calls), beside their
    bounds, their plain versions and one PyTorch call computing the same
    function."""
    from das_diff_veh_tpu_torch.ops import lag_absmax as la

    entries = []
    for tier in ("f32", "bf16"):
        src, rcv, nwin, wb = path["captured"][tier]["cross_spectra"]
        b3 = _b3_times(src, rcv, nwin, wb, tier)
        entries.append({"name": "cross_spectra" + ("" if tier == "f32" else "_bf16"),
                        "route": "cuda",
                        "source": "das_diff_veh_tpu_torch/csrc/cross_spectra.cu",
                        "replaces": "das_diff_veh_tpu/ops/pallas_xcorr.py:230",
                        "launches": path[tier]["launches"]["cross_spectra"], **b3})
    (lag,) = path["captured"]["f32"]["lag_absmax"]
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
    log(f"B4 per launch (npairs={npairs}, nlag={nlag}): kernel {b4['ms']:.5f} ms, plain "
        f"{b4['plain_ms']:.5f} ms, vector_norm {b4['library_ms']:.5f} ms, bound "
        f"{b4_bound:.5f} ms ({b4_by})")
    entries.append({"name": "lag_absmax", "route": "cuda",
                    "source": "das_diff_veh_tpu_torch/csrc/lag_absmax.cu",
                    "replaces": "das_diff_veh_tpu/ops/pallas_xcorr.py:137",
                    "launches": path["f32"]["launches"]["lag_absmax"], "max_abs_err": b4_err,
                    **b4, "bound_ms": b4_bound, "bound_by": b4_by})
    return entries


def _dot_cfg(precision: str = "f32", finish: str = "dot"):
    """The default configuration with a 1 s correlation window through the
    given finish; ``precision`` sets both the gather's and the image's tier."""
    from das_diff_veh_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    return cfg.replace(
        gather=dataclasses.replace(cfg.gather, wlen=DOT_WLEN_S, traj_gather_finish=finish,
                                   precision=precision),
        dispersion=dataclasses.replace(cfg.dispersion, precision=precision))


def _bf16_gaps(k, plain, args) -> tuple:
    """B2's bf16 output ``k`` against its plain version's output ``plain``
    and against a float64 evaluation of the same bfloat16 operands,
    peak-relative."""
    from das_diff_veh_tpu_torch.ops import traj_gather as tg
    from das_diff_veh_tpu_torch.ops.precision import bf16_round

    rec, scal, pivot, nwin, wlen, offset, swap, _ = args
    f64 = tg.correlate_dot_plain(bf16_round(rec).double(), scal, pivot, nwin, wlen, offset, swap)
    return peak_rel(k, plain), peak_rel(k, f64)


def phase_dot_kernel_vs_plain() -> dict:
    """B2 against its plain version on the card at the edge shapes of
    ``DOT_CASES``, both tiers, forward and backward starts, swap off and on:
    f32 bit for bit, bf16 within ``DOT_BF16_TOL`` of the plain version and
    of float64.  Starts are drawn over [0, nt + nsamp/2), so some rows are
    truncated at the record end and, backward, some are empty slices
    (start < nsamp)."""
    from das_diff_veh_tpu_torch.ops import traj_gather as tg

    gen = torch.Generator(device="cuda").manual_seed(17)
    nb, nch, nt, pivot = 64, 37, 4800, 28
    rec = torch.randn((nb, nch, nt), generator=gen, device="cuda")
    out = {}
    seen = {"truncated": 0, "empty": 0}
    bf16_gap = [0.0, 0.0]
    for i, (name, wlen, nsamp) in enumerate(DOT_CASES):
        offset = wlen // 2
        nwin = (nsamp - wlen) // offset + 1
        nk = (18, 7, 1)[i % 3]
        ch = torch.arange(pivot - nk, pivot, device="cuda")
        for backward in (False, True):
            idx = torch.randint(0, nt + nsamp // 2, (nb, nk), generator=gen, device="cuda")
            scal = tg.traj_scalars(idx, ch, nch, nt, nsamp, backward).contiguous()
            n_eff = ((torch.arange(nwin, device="cuda") * offset + wlen)
                     <= scal[..., 1:2]).sum(-1)
            empty = n_eff == 0
            seen["truncated"] += int(((n_eff > 0) & (n_eff < nwin)).sum())
            seen["empty"] += int(empty.sum())
            for swap in (False, True):
                for precision in ("f32", "bf16"):
                    args = (rec, scal, pivot, nwin, wlen, offset, swap, precision)
                    k = tg.correlate_dot_cuda(*args)
                    p = tg.correlate_dot_plain(*args)
                    torch.cuda.synchronize()
                    equal = bool(torch.equal(k, p))
                    err = float((k - p).abs().max())
                    label = (f"{name}/nk{nk}/{'backward' if backward else 'forward'}/"
                             f"swap{int(swap)}/{precision}")
                    res = {"equal": equal, "max_abs_err": err}
                    if precision == "f32" and not equal:
                        raise AssertionError(f"traj_dot kernel != plain version in {label}: "
                                             f"max_abs_err {err}")
                    if precision == "bf16":
                        gaps = _bf16_gaps(k, p, args)
                        res.update(peak_rel_plain=gaps[0], peak_rel_f64=gaps[1])
                        bf16_gap = [max(a, b) for a, b in zip(bf16_gap, gaps)]
                        if not max(gaps) <= DOT_BF16_TOL:
                            raise AssertionError(f"traj_dot bf16 kernel off its plain version "
                                                 f"or float64 in {label}: {gaps}")
                    if bool(k[empty].any()):
                        raise AssertionError(f"rows without a valid window must be 0 ({label})")
                    out[label] = res
        log(f"B2 vs plain [{name}: wlen={wlen} nwin={nwin} nk={nk}, 64 slots, both "
            f"directions, swap 0/1]: f32 equal=True, bf16 within {DOT_BF16_TOL}")
    log(f"B2 edge rows seen: {seen['truncated']} truncated at the record end, "
        f"{seen['empty']} without a valid window; largest bf16 gap peak-rel "
        f"{bf16_gap[0]:.3e} to the plain version, {bf16_gap[1]:.3e} to float64 "
        f"(tol {DOT_BF16_TOL})")
    if not (seen["truncated"] and seen["empty"]):
        raise AssertionError(f"the edge cases did not reach every edge: {seen}")
    return {"cases": out, "edge_rows": seen, "bf16_gap_plain": bf16_gap[0],
            "bf16_gap_f64": bf16_gap[1]}


def _gather_geometry(section, cfg):
    """``(geometry, offsets, dt)`` of the chunk's gather, as ``chunk_body``
    builds them."""
    from das_diff_veh_tpu_torch.models import vsg as V
    from das_diff_veh_tpu_torch.models.windows import window_x_slice

    x_win = window_x_slice(np.asarray(section.x), cfg.imaging.x0, cfg.window)
    dt = float(section.t[1] - section.t[0])
    g = V.VsgGeometry.build(x_win, dt, cfg.imaging.x0,
                            cfg.imaging.x0 + cfg.imaging.disp_start_x,
                            cfg.imaging.x0 + cfg.gather.far_offset, cfg.gather)
    return g, g.offsets(x_win), dt


@contextmanager
def dot_launches_through(fn):
    """Inside: the dot finish calls ``fn(launch, *args)`` in place of B2's
    launch function ``correlate_dot_cuda`` (``launch``)."""
    from das_diff_veh_tpu_torch.ops import traj_gather as tg

    launch = tg.correlate_dot_cuda
    tg.correlate_dot_cuda = lambda *args: fn(launch, *args)
    try:
        yield
    finally:
        tg.correlate_dot_cuda = launch


def _run_counted(sec, cfg, method: str, keep: list):
    """One chunk on the card with the counts set to 0 just before it and read
    just after; ``(arguments, output)`` of every B2 launch go to ``keep``."""
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    def recording(launch, *args):
        keep.append((args, launch(*args)))
        return keep[-1][1]

    with dot_launches_through(recording):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = process_chunk(sec, cfg, method=method, device="cuda")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_counts()
    return res, counts, first_s


def _live_rows(captured, valid) -> list:
    """``[live, rows]`` of each B2 launch: rows of the isolated windows'
    slots with a nonzero correlation."""
    return [[int(out[valid].abs().amax(-1).gt(0).sum()), int(out[valid].shape[:2].numel())]
            for _, out in captured]


def _check_image(res, cfg, label: str) -> None:
    img = res.disp_image
    if tuple(img.shape) != (cfg.dispersion.n_vels, cfg.dispersion.n_freqs):
        raise AssertionError(f"{label}: image shape {tuple(img.shape)}")
    if not (img.is_cuda and img.dtype == torch.float32 and bool(torch.isfinite(img).all())):
        raise AssertionError(f"{label}: image must be a finite float32 tensor on the card")
    if res.n_windows <= 0:
        raise AssertionError(f"{label}: the chunk isolated no window")


def phase_dot_chunk(section) -> dict:
    """The dot chunk on the card (f32 and bf16 tiers), held against the
    port's CPU float64 run, and its dot-vs-rfft image gap on the card."""
    from das_diff_veh_tpu_torch.config import DispersionConfig
    from das_diff_veh_tpu_torch.models import vsg as V
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    cfg = _dot_cfg()
    sec32 = section.to(dtype=torch.float32)
    captured = []
    res, counts, first_s = _run_counted(sec32, cfg, "xcorr", captured)
    live = _live_rows(captured, res.batch.valid)
    log(f"dot chunk: first chunk {first_s:.3f} s, launches {counts}, n_windows "
        f"{res.n_windows}, B2 launch shapes "
        f"{[(tuple(a[0].shape), tuple(a[1].shape), a[3], a[4], a[6]) for a, _ in captured]}, "
        f"[live, rows] of the isolated windows per launch {live}")
    if counts != DOT_LAUNCHES:
        raise AssertionError(f"expected launches {DOT_LAUNCHES} in the dot chunk, got {counts}")
    _check_image(res, cfg, "dot chunk")

    t0 = time.perf_counter()
    ref = process_chunk(section, cfg, method="xcorr", device="cpu")
    cpu_s = time.perf_counter() - t0
    valid_eq = bool(torch.equal(res.batch.valid.cpu(), ref.batch.valid))
    tracks_eq = bool(torch.equal(res.tracks.valid.cpu(), ref.tracks.valid))
    img_err = peak_rel(res.disp_image, ref.disp_image)
    vsg_err = peak_rel(res.vsg_stack, ref.vsg_stack)
    log(f"dot chunk vs CPU float64 ({cpu_s:.1f} s): n_windows {res.n_windows} vs "
        f"{ref.n_windows}, batch.valid equal {valid_eq}, tracks.valid equal {tracks_eq}, "
        f"image peak-rel {img_err:.3e} (tol {IMAGE_PEAK_REL_TOL}), vsg_stack peak-rel "
        f"{vsg_err:.3e}")
    if res.n_windows != ref.n_windows or not (valid_eq and tracks_eq):
        raise AssertionError("dot chunk: window or track masks differ from the CPU float64 run")
    if not img_err <= IMAGE_PEAK_REL_TOL:
        raise AssertionError(f"dot chunk image differs from the CPU float64 run by {img_err:.3e}")
    # with 8 s windows only the main side's rows are live, and they reach the
    # stack, not the image (phase_dot_chunk_live reaches both)
    if not vsg_err <= IMAGE_PEAK_REL_TOL:
        raise AssertionError(f"dot chunk vsg_stack differs from the CPU float64 run by "
                             f"{vsg_err:.3e}")

    rfft = process_chunk(sec32, _dot_cfg(finish="rfft"), method="xcorr", device="cuda")
    rfft_img_gap = peak_rel(res.disp_image, rfft.disp_image)
    rfft_vsg_gap = peak_rel(res.vsg_stack, rfft.vsg_stack)
    log(f"dot vs rfft finish on the card at wlen {DOT_WLEN_S} s: image peak-rel "
        f"{rfft_img_gap:.3e}, vsg_stack peak-rel {rfft_vsg_gap:.3e}")

    bcfg = _dot_cfg("bf16")
    captured_bf16 = []
    bres, bcounts, _ = _run_counted(sec32, bcfg, "xcorr", captured_bf16)
    _check_image(bres, bcfg, "bf16 dot chunk")
    bf16_gap = peak_rel(bres.disp_image, res.disp_image)
    bf16_vsg_gap = peak_rel(bres.vsg_stack, res.vsg_stack)
    bf16_valid_eq = bool(torch.equal(bres.batch.valid, res.batch.valid))
    log(f"bf16 dot chunk: launches {bcounts}, batch.valid equal {bf16_valid_eq}, image "
        f"peak-rel to the f32 card image {bf16_gap:.3e} (budget {BF16_IMAGE_BUDGET}), "
        f"vsg_stack {bf16_vsg_gap:.3e} (budget {GATHER_DOT_BF16_BUDGET})")
    if bcounts != DOT_LAUNCHES:
        raise AssertionError(f"expected launches {DOT_LAUNCHES} in the bf16 chunk, got {bcounts}")
    if not (bf16_valid_eq and bf16_gap <= BF16_IMAGE_BUDGET
            and bf16_vsg_gap <= GATHER_DOT_BF16_BUDGET):
        raise AssertionError(f"bf16 dot chunk: windows equal {bf16_valid_eq}, image gap "
                             f"{bf16_gap:.3e}, vsg_stack gap {bf16_vsg_gap:.3e}")

    _, offsets, dt = _gather_geometry(section, cfg)
    ps_cfg = DispersionConfig(method="phase_shift")
    ps = [V.gather_disp_image(stack, offsets, dt, cfg.interrogator.dx, ps_cfg,
                              cfg.imaging.disp_start_x, cfg.imaging.disp_end_x)
          for stack in (res.vsg_stack, ref.vsg_stack)]
    ps_err = peak_rel(ps[0], ps[1])
    log(f"phase-shift image of the dot chunk's stack, card vs CPU float64: peak-rel "
        f"{ps_err:.3e} (tol {IMAGE_PEAK_REL_TOL})")
    if not (ps[0].is_cuda and bool(torch.isfinite(ps[0]).all()) and ps_err <= IMAGE_PEAK_REL_TOL):
        raise AssertionError(f"phase-shift image differs from the CPU float64 one by {ps_err:.3e}")
    return {"first_chunk_s": first_s, "launches": counts, "launches_bf16": bcounts,
            "n_windows": res.n_windows, "tracks_valid_equal": tracks_eq, "live_rows": live,
            "image_peak_rel_err": img_err, "vsg_peak_rel_err": vsg_err, "cpu_float64_s": cpu_s,
            "dot_vs_rfft_image_gap": rfft_img_gap, "dot_vs_rfft_vsg_gap": rfft_vsg_gap,
            "bf16_vs_f32_image_gap": bf16_gap, "bf16_vs_f32_vsg_gap": bf16_vsg_gap,
            "phase_shift_peak_rel_err": ps_err,
            "captured": captured, "captured_bf16": captured_bf16, "sec32": sec32}


def phase_dot_chunk_live(section) -> dict:
    """The dot chunk with ``LIVE_WINDOW``, where both B2 launches have live
    rows in the isolated windows and the time-reversed one reaches the
    image: the image held against the port's CPU float64 run, the stack of
    the card's own windows against the CPU float64 gather of the same
    windows, and how far the card's image moves when the time-reversed
    launch returns zeros.

    The chunk's stack is not held end to end here: the card's float32
    tracks differ from the CPU's in a few trajectory samples (a
    ``floor`` of a float32 Kalman state flips), which moves the start of
    the farthest main-side row, live only with these windows, by a few
    samples."""
    from das_diff_veh_tpu_torch.models import vsg as V
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    cfg = _dot_cfg()
    cfg = cfg.replace(window=dataclasses.replace(cfg.window, **LIVE_WINDOW))
    sec32 = section.to(dtype=torch.float32)
    captured = []
    res, counts, first_s = _run_counted(sec32, cfg, "xcorr", captured)
    _check_image(res, cfg, "live dot chunk")
    live = _live_rows(captured, res.batch.valid)
    ref = process_chunk(section, cfg, method="xcorr", device="cpu")
    masks_eq = (res.n_windows == ref.n_windows
                and bool(torch.equal(res.batch.valid.cpu(), ref.batch.valid))
                and bool(torch.equal(res.tracks.valid.cpu(), ref.tracks.valid)))
    img_err = peak_rel(res.disp_image, ref.disp_image)
    vsg_err = peak_rel(res.vsg_stack, ref.vsg_stack)
    tk, tc = res.tracks.t_idx.cpu().double(), ref.tracks.t_idx.double()
    finite = torch.isfinite(tk) & torch.isfinite(tc)
    traj_flips = [int((tk.floor() != tc.floor())[finite].sum()), int(finite.sum())]

    g, _, _ = _gather_geometry(section, cfg)
    b = res.batch
    b64 = dataclasses.replace(b, data=b.data.cpu().double(), x=b.x.cpu(), t=b.t.cpu(),
                              traj_x=b.traj_x.cpu(), traj_t=b.traj_t.cpu(), valid=b.valid.cpu())
    stage = [V.stack_gathers(V.build_gather_batch(w, g, cfg.gather), w.valid) for w in (b, b64)]
    stage_err = peak_rel(*stage)

    def zero_time_reversed(launch, *args):
        out = launch(*args)
        return torch.zeros_like(out) if args[6] else out

    with dot_launches_through(zero_time_reversed):
        zeroed = process_chunk(sec32, cfg, method="xcorr", device="cuda")
    moved = peak_rel(zeroed.disp_image, res.disp_image)
    log(f"live dot chunk ({LIVE_WINDOW}): first chunk {first_s:.3f} s, launches {counts}, "
        f"n_windows {res.n_windows} vs {ref.n_windows} on the CPU, masks equal {masks_eq}, "
        f"[live, rows] per launch {live}, image peak-rel {img_err:.3e} (tol "
        f"{IMAGE_PEAK_REL_TOL}); stack of the card's windows vs their CPU float64 gather "
        f"{stage_err:.3e} (tol {IMAGE_PEAK_REL_TOL}); chunk stack end to end {vsg_err:.3e} "
        f"(not held: {traj_flips[0]} of {traj_flips[1]} track samples floor to another "
        f"tracking step than on the CPU); zeroing the time-reversed launch moves the image by {moved:.3e}")
    if counts != DOT_LAUNCHES:
        raise AssertionError(f"expected launches {DOT_LAUNCHES} in the live dot chunk, "
                             f"got {counts}")
    if not masks_eq:
        raise AssertionError("live dot chunk: window or track masks differ from the CPU run")
    if not (img_err <= IMAGE_PEAK_REL_TOL and stage_err <= IMAGE_PEAK_REL_TOL):
        raise AssertionError(f"live dot chunk differs from the CPU float64 run: image "
                             f"{img_err:.3e}, stack of the same windows {stage_err:.3e}")
    if not (all(n > 0 for n, _ in live) and moved > IMAGE_PEAK_REL_TOL):
        raise AssertionError(f"live dot chunk: the image check does not see both launches "
                             f"(live rows {live}, image moves {moved:.3e})")
    return {"first_chunk_s": first_s, "launches": counts, "n_windows": res.n_windows,
            "live_rows": live, "image_peak_rel_err": img_err,
            "same_windows_stack_peak_rel_err": stage_err, "vsg_peak_rel_err": vsg_err,
            "trajectory_samples_differing": traj_flips,
            "image_moves_without_time_reversed": moved}


def phase_surface_wave_chunk(section) -> dict:
    """``process_chunk(method="surface_wave")`` on the card against the port's
    CPU float64 run.  The path runs none of the port's kernels."""
    from das_diff_veh_tpu_torch.config import PipelineConfig
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    cfg = PipelineConfig()
    sec32 = section.to(dtype=torch.float32)
    res, counts, first_s = _run_counted(sec32, cfg, "surface_wave", [])
    _check_image(res, cfg, "surface_wave chunk")
    if counts != NO_LAUNCHES or res.vsg_stack is not None:
        raise AssertionError(f"surface_wave chunk: launches {counts}")
    t0 = time.perf_counter()
    ref = process_chunk(section, cfg, method="surface_wave", device="cpu")
    cpu_s = time.perf_counter() - t0
    valid_eq = bool(torch.equal(res.batch.valid.cpu(), ref.batch.valid))
    img_err = peak_rel(res.disp_image, ref.disp_image)
    log(f"surface_wave chunk: first chunk {first_s:.3f} s, n_windows {res.n_windows} vs "
        f"{ref.n_windows} on the CPU ({cpu_s:.1f} s), batch.valid equal {valid_eq}, image "
        f"peak-rel {img_err:.3e} (tol {IMAGE_PEAK_REL_TOL})")
    if res.n_windows != ref.n_windows or not valid_eq:
        raise AssertionError("surface_wave chunk: windows differ from the CPU float64 run")
    if not img_err <= IMAGE_PEAK_REL_TOL:
        raise AssertionError(f"surface_wave image differs from the CPU float64 run by "
                             f"{img_err:.3e}")
    return {"first_chunk_s": first_s, "n_windows": res.n_windows, "image_peak_rel_err": img_err,
            "cpu_float64_s": cpu_s, "sec32": sec32, "cfg": cfg}


def _rfft_finish(rec, scal, pivot, nwin, wlen, offset, swap, precision="f32"):
    """The port's rfft finish on B2's inputs: B1's cut, two rffts, the
    product, the irfft, the window mean and the roll."""
    from das_diff_veh_tpu_torch.ops import traj_gather as tg
    from das_diff_veh_tpu_torch.ops.xcorr import _circ_corr_freq

    wc, wp = tg.pack_windows_cuda(rec, scal, pivot, nwin, wlen, offset)
    cf, pf = torch.fft.rfft(wc, dim=-1), torch.fft.rfft(wp, dim=-1)
    c = _circ_corr_freq(pf, cf, wlen) if swap else _circ_corr_freq(cf, pf, wlen)
    n_eff = ((torch.arange(nwin, device=rec.device) * offset + wlen) <= scal[..., 1:2]).sum(-1)
    return torch.roll(c.sum(-2) / n_eff.clamp(min=1)[..., None], wlen // 2, dims=-1)


def phase_dot_times(dot: dict, sw: dict, profile: bool = False) -> dict:
    """B2 per chunk in both tiers on the dot chunks' inputs (device time from
    CUDA-graph replays), its plain version, its bound and the rfft-finish
    yardstick; the warm wall times of the dot and surface_wave chunks."""
    from das_diff_veh_tpu_torch.ops import traj_gather as tg
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    entries, yard_ms, yard_gap = [], 0.0, 0.0
    for tier, captured, launches in (("f32", dot["captured"], dot["launches"]),
                                     ("bf16", dot["captured_bf16"], dot["launches_bf16"])):
        k_ms = p_ms = err = 0.0
        flops = nbytes = 0
        valid, gaps = [], [0.0, 0.0]
        for args, _ in captured:
            rec, scal, pivot, nwin, wlen, offset, swap, precision = args
            k, p = tg.correlate_dot_cuda(*args), tg.correlate_dot_plain(*args)
            if tier == "f32" and not torch.equal(k, p):
                raise AssertionError("B2 (f32) != plain version on the dot chunk's inputs")
            if tier == "bf16":
                gaps = [max(a, b) for a, b in zip(gaps, _bf16_gaps(k, p, args))]
                if not max(gaps) <= DOT_BF16_TOL:
                    raise AssertionError(f"B2 (bf16) off its plain version or float64 on the "
                                         f"dot chunk's inputs: {gaps}")
            err = max(err, float((k - p).abs().max()))
            valid.append(tg.dot_flops(scal, nwin, wlen, offset) // (2 * wlen * wlen))
            k_ms += device_ms(lambda: tg.correlate_dot_cuda(*args))
            p_ms += device_ms(lambda: tg.correlate_dot_plain(*args), inner=2)
            flops += tg.dot_flops(scal, nwin, wlen, offset)
            nbytes += tg.bytes_moved(scal, rec.shape[1], rec.shape[2], pivot, nwin, wlen,
                                     offset, out_elems=scal.shape[0] * scal.shape[1] * wlen)
            if tier == "f32":
                y = _rfft_finish(*args)
                yard_gap = max(yard_gap, peak_rel(k, y))
                yard_ms += device_ms(lambda: _rfft_finish(*args))
        # bf16 operands with float32 sums: the bf16 tier runs on the tensor
        # cores, at their rate
        ops_rate = FP32_OPS_PER_S if tier == "f32" else BF16_OPS_PER_S
        bound_ms, bound_by = _bound(nbytes, flops, ops_rate)
        # one instruction per product and per sum: flops instructions
        floor_ms = flops / FP32_LANE_INSTR_PER_S * 1e3 if tier == "f32" else None
        floor = f", issue floor {floor_ms:.6f} ms" if floor_ms is not None else ""
        gap = (f", bf16 gap peak-rel {gaps[0]:.3e} to the plain version and {gaps[1]:.3e} "
               f"to float64" if tier == "bf16" else "")
        log(f"B2 {tier} per chunk ({len(captured)} launches, device time from CUDA graph "
            f"replays): kernel {k_ms:.5f} ms, plain {p_ms:.4f} ms, bound {bound_ms:.6f} ms "
            f"({bound_by}: {flops} FLOP at {ops_rate / 1e12:g} TFLOP/s, {nbytes} B at "
            f"3.35 TB/s){floor}; valid windows per launch {valid}{gap}")
        entries.append({"name": "traj_dot_correlate" + ("" if tier == "f32" else "_bf16"),
                        "route": "cuda", "source": "das_diff_veh_tpu_torch/csrc/traj_dot.cu",
                        "replaces": "das_diff_veh_tpu/ops/pallas_gather.py:138",
                        "launches": launches["traj_dot"], "max_abs_err": err, "ms": k_ms,
                        "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None, "flops": flops, "bytes": nbytes,
                        "issue_floor_ms": floor_ms, "valid_windows": valid})
    log(f"yardstick: the rfft finish (B1 cut + rfft + product + irfft + mean + roll) on the "
        f"f32 dot chunk's B2 inputs: {yard_ms:.5f} ms per chunk, peak-rel gap to B2 "
        f"{yard_gap:.3e}")
    walls = {}
    for label, sec, cfg, method in (("dot", dot["sec32"], _dot_cfg(), "xcorr"),
                                    ("surface_wave", sw["sec32"], sw["cfg"], "surface_wave")):
        runs = []
        for _ in range(WARM_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            process_chunk(sec, cfg, method=method, device="cuda")
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        walls[label] = runs
        log(f"{label} chunk wall ms over {WARM_RUNS} warm runs: {[round(w, 3) for w in runs]} "
            f"(median {float(np.median(runs)):.3f})")
    profiles = None
    if profile:
        profiles = {label: profile_call(f"one {label} chunk", lambda s=sec, c=cfg, m=method:
                                        process_chunk(s, c, method=m, device="cuda"))
                    for label, sec, cfg, method in (
                        ("dot", dot["sec32"], _dot_cfg(), "xcorr"),
                        ("surface_wave", sw["sec32"], sw["cfg"], "surface_wave"))}
    return {"kernels": entries, "rfft_finish_ms": yard_ms, "rfft_finish_gap": yard_gap,
            "dot_wall_ms": walls["dot"], "dot_wall_ms_median": float(np.median(walls["dot"])),
            "surface_wave_wall_ms": walls["surface_wave"],
            "surface_wave_wall_ms_median": float(np.median(walls["surface_wave"])),
            "profile": profiles}


# The fused chunk (phase 15): each scene's staged and fused configurations,
# method, and the launches a replay must hold.  FUSED_FIELDS are held
# torch.equal between fused and staged; a continuous field that a library
# call rounds otherwise on the capture stream is named and held within
# FUSED_BAR peak-relative (the bar JAX's fused path discloses,
# tests/test_fused_pipeline.py:1-25); masks and counts stay exact.
FUSED_WARM_CALLS = 20
FUSED_BAR = 1e-7
FUSED_CONTINUOUS = ("disp_image", "vsg_stack", "batch.data", "tracks.t_idx")
FUSED_KERNEL_NAMES = {"traj_gather": "traj_gather_pack_kernel", "traj_dot": "traj_dot_kernel"}


def _fused_scenes():
    from das_diff_veh_tpu_torch.config import PipelineConfig

    return {"default": (PipelineConfig(), "xcorr", {"traj_gather": 2, "traj_dot": 0}),
            "dot_f32": (_dot_cfg("f32"), "xcorr", {"traj_gather": 0, "traj_dot": 2}),
            "dot_bf16": (_dot_cfg("bf16"), "xcorr", {"traj_gather": 0, "traj_dot": 2}),
            "surface_wave": (PipelineConfig(), "surface_wave",
                             {"traj_gather": 0, "traj_dot": 0})}


def _chunk_fields(res) -> dict:
    """Name -> tensor of every field of a chunk result."""
    out = {"n_windows": torch.as_tensor(res.n_windows), "disp_image": res.disp_image}
    if res.vsg_stack is not None:
        out["vsg_stack"] = res.vsg_stack
    for obj in ("tracks", "batch"):
        for f in dataclasses.fields(getattr(res, obj)):
            out[f"{obj}.{f.name}"] = getattr(getattr(res, obj), f.name)
    return out


def _fused_vs_staged(fused, staged, label: str) -> dict:
    """Field name -> peak-relative gap of every field that is not the same
    bits; raises past ``FUSED_BAR`` or on any other field."""
    f, s = _chunk_fields(fused), _chunk_fields(staged)
    if f.keys() != s.keys():
        raise AssertionError(f"{label}: fused fields {sorted(f)} vs staged {sorted(s)}")
    gaps = {}
    for name in f:
        a, b = f[name].cpu(), s[name].cpu()
        if a.dtype == b.dtype and a.shape == b.shape and same_bits(a, b):
            continue
        gap = peak_rel(a.nan_to_num(), b.nan_to_num()) if a.is_floating_point() else float("inf")
        gaps[name] = gap
        if name not in FUSED_CONTINUOUS or not gap <= FUSED_BAR \
                or not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"{label}: fused {name} differs from staged (peak-rel {gap:.3e})")
    return gaps


def _kernel_names(fn) -> tuple:
    """``(busy ms, wall ms, kernels and copies, names)`` of one call of ``fn``
    under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    return busy, wall_ms, sum(e.count for e in rows), {e.key: e.count for e in rows}


def phase_fused(section, nvidia_smi: str) -> dict:
    """``process_chunk(..., cfg.replace(chunk_pipeline="fused"))`` on the card
    for the default, dot (f32, bf16) and surface_wave chunks at full size:
    one capture per geometry, 0 in 20 warm calls; every field equal to the
    staged chunk; a zero-signal chunk through the cached program; no
    aliasing between results; the launches a replay records and the kernel
    names a profiled replay lists; fused and staged walls in turns, the
    device-busy share, the capture time and the graph's pool."""
    from das_diff_veh_tpu_torch.core import constants
    from das_diff_veh_tpu_torch.pipeline import fused as F
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk, resolve_chunk_metadata

    sec32 = section.to("cuda", torch.float32)
    # another chunk of the geometry: the same record 30 s later (vehicles move)
    other = dataclasses.replace(sec32, data=torch.roll(sec32.data, 7500, dims=1))
    zero = dataclasses.replace(sec32, data=torch.zeros_like(sec32.data))
    F.clear_programs()
    torch.cuda.synchronize()
    held0 = torch.cuda.memory_allocated()
    out = {}
    for label, (cfg, method, per_replay) in _fused_scenes().items():
        fcfg = cfg.replace(chunk_pipeline="fused")
        run = lambda sec, c=cfg: process_chunk(sec, c, method=method, device="cuda")
        frun = lambda sec, c=fcfg: process_chunk(sec, c, method=method, device="cuda")
        staged = run(sec32)
        caps, progs, reps = F.n_captures(), F.n_programs(), F.n_replays()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        first = frun(sec32)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_counts()
        prog = F.programs()[-1]
        if (F.n_captures(), F.n_programs(), F.n_replays()) != (caps + 1, progs + 1, reps + 1):
            raise AssertionError(f"fused {label}: the first call must capture one program")
        lpr = prog.launches_per_replay
        if {k: lpr.get(k, 0) for k in per_replay} != per_replay:
            raise AssertionError(f"fused {label}: launches per replay {lpr}, expected "
                                 f"{per_replay}")
        gaps = _fused_vs_staged(first, staged, f"fused {label}")
        kept = {k: v.clone() for k, v in _chunk_fields(first).items()}
        second = frun(other)
        gaps_other = _fused_vs_staged(second, run(other), f"fused {label} (other data)")
        aliased = [k for k, v in _chunk_fields(first).items() if not same_bits(v, kept[k])]
        if aliased:
            raise AssertionError(f"fused {label}: a later call overwrote {aliased}")
        z = frun(zero)
        z_ok = int(z.n_windows) == 0 and bool(torch.isfinite(z.disp_image).all())
        if not z_ok or F.n_programs() != progs + 1:
            raise AssertionError(f"fused {label}: zero-signal chunk n_windows {int(z.n_windows)}, "
                                 f"programs {F.n_programs() - progs}")
        caps, progs, disp = F.n_captures(), F.n_programs(), F.n_dispatches("process_chunk")
        walls, swalls = [], []
        for _ in range(FUSED_WARM_CALLS):
            for fn, acc in ((frun, walls), (run, swalls)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(sec32)
                torch.cuda.synchronize()
                acc.append((time.perf_counter() - t0) * 1e3)
        if (F.n_captures(), F.n_programs()) != (caps, progs) or \
                F.n_dispatches("process_chunk") != disp + FUSED_WARM_CALLS:
            raise AssertionError(f"fused {label}: warm calls captured "
                                 f"{F.n_captures() - caps}, built {F.n_programs() - progs}")
        busy, pwall, n_ops, names = _kernel_names(lambda: frun(sec32))
        seen = {k: sum(c for n, c in names.items() if FUSED_KERNEL_NAMES[k] in n)
                for k in per_replay}
        if seen != per_replay:
            raise AssertionError(f"fused {label}: the profiled replay lists {seen} of the "
                                 f"kernels, expected {per_replay}")
        sbusy, swall, s_ops, _ = _kernel_names(lambda: run(sec32))
        pool = prog.pool_bytes()
        res = {"first_call_s": first_s, "warmup_s": prog.warmup_s, "capture_s": prog.capture_s,
               "launches_first_call": counts, "launches_per_replay": lpr,
               "n_windows": int(first.n_windows), "gaps_to_staged": gaps,
               "gaps_to_staged_other_data": gaps_other,
               "fused_wall_ms": walls, "staged_wall_ms": swalls,
               "fused_wall_ms_median": float(np.median(walls)),
               "fused_wall_ms_p90": float(np.percentile(walls, 90)),
               "staged_wall_ms_median": float(np.median(swalls)),
               "staged_wall_ms_p90": float(np.percentile(swalls, 90)),
               "profiled_replay": {"wall_ms": pwall, "device_busy_ms": busy,
                                   "busy_share": busy / pwall, "kernels_and_copies": n_ops,
                                   "kernel_launches_seen": seen},
               "profiled_staged": {"wall_ms": swall, "device_busy_ms": sbusy,
                                   "busy_share": sbusy / swall, "kernels_and_copies": s_ops},
               "pool_bytes": pool,
               "static_in_bytes": prog.static_in.numel() * prog.static_in.element_size()}
        log(f"fused {label} ({nvidia_smi}): first call {first_s:.3f} s (warm-up "
            f"{prog.warmup_s:.3f}, capture {prog.capture_s:.3f}), launches in it {counts}, per "
            f"replay {lpr}; n_windows {res['n_windows']}; fields not bit-equal to staged "
            f"{gaps or 'none'} (other data {gaps_other or 'none'}); zero-signal chunk hit the "
            f"cache, n_windows 0; warm walls ms fused median {res['fused_wall_ms_median']:.3f} "
            f"p90 {res['fused_wall_ms_p90']:.3f}, staged median "
            f"{res['staged_wall_ms_median']:.3f} p90 {res['staged_wall_ms_p90']:.3f} (in "
            f"turns, {FUSED_WARM_CALLS} each); profiled replay: busy {busy:.3f} of {pwall:.3f} "
            f"ms ({100 * busy / pwall:.1f} %), {n_ops} kernels and copies, {seen}; staged "
            f"profiled: busy {sbusy:.3f} of {swall:.3f} ms ({100 * sbusy / swall:.1f} %), "
            f"{s_ops}; pool {res['pool_bytes']} B")
        out[label] = res
        del prog                        # clear_programs() below must free its graph
    # the body at full size does not synchronise (the constants are cached)
    cfg, method, _ = _fused_scenes()["default"]
    x, t, _ = resolve_chunk_metadata(sec32, cfg)
    body = F._program(sec32.data.shape, sec32.data.dtype, sec32.data.device, x, t,
                      cfg.replace(chunk_pipeline="fused"), method, False).body
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        body(sec32.data)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    del body
    torch.cuda.synchronize()
    held, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    const_bytes = constants.nbytes("cuda:0")
    pools = sum(r["pool_bytes"] for r in out.values())
    F.clear_programs()
    torch.cuda.synchronize()
    freed = held - torch.cuda.memory_allocated()
    released = reserved - torch.cuda.memory_reserved()
    log(f"fused programs: {len(out)} geometries held {held - held0} B allocated (static "
        f"buffers, outputs, {const_bytes} B of cached constants) and {pools} B of graph "
        f"pools; clear_programs() freed {freed} B allocated and gave back {released} B of reserved "
        f"device memory; the body synchronises nowhere (set_sync_debug_mode('error'))")
    if freed <= 0 or released < pools:
        raise AssertionError(f"clear_programs() freed {freed} B and released {released} B of "
                             f"the pools' {pools} B")
    return {"scenes": out, "allocated_bytes_held": held - held0, "pool_bytes_total": pools,
            "constants_bytes": const_bytes, "freed_bytes": freed, "released_bytes": released,
            "device": nvidia_smi}


# The batch phase: 8 files of one date at 2-minute spacing, each the chunk
# scene at full size (seeds 2-9; the first is the main path's scene).  File 3
# gets 3 NaN channels and a constant one (degraded), file 5 80 NaN channels
# (80/140 > max_masked_fraction 0.5: poisoned), file 6 garbage bytes.  A NaN
# channel is a burst of a quarter of the record inside it, as the fault
# injector plants one: the reader's savgol pre-smooth refuses NaN at the
# record's ends (its edge fit), which would quarantine the file at "load"
# before the health screen sees it.
BATCH_DATE = "20230301"
BATCH_SEEDS = tuple(range(2, 10))
BATCH_DEGRADED, BATCH_POISONED, BATCH_GARBAGE = 3, 5, 6
BATCH_NAN_CHANNELS = (10, 50, 90)
BATCH_FLAT_CHANNEL = 120
BATCH_POISON_CHANNELS = 80
BATCH_NAN_BURST = slice(10000, 17500)
BATCH_TIMED_RUNS = 3


def _batch_file(i: int) -> str:
    return f"{BATCH_DATE}_{i * 2 // 60:02d}{i * 2 % 60:02d}00.npz"


def _write_batch_file(day: str, i: int, seed: int, data=None, x=None, t=None) -> str:
    """Write file ``i`` of the batch folder (the scene of ``seed`` unless its
    arrays are given), with its planted fault.  Top level, so that a
    spawned worker can run it."""
    import os

    sys.path.insert(0, str(REPO))
    from das_diff_veh_tpu_torch.io.synthetic import SceneConfig, synthesize_section

    path = os.path.join(day, _batch_file(i))
    if i == BATCH_GARBAGE:
        with open(path, "wb") as f:
            f.write(b"not an npz file: the loader must quarantine this chunk")
        return path
    if data is None:
        sec, _ = synthesize_section(SceneConfig(**{**SCENE, "seed": seed}))
        data, x, t = sec.data.numpy(), sec.x.numpy(), sec.t.numpy()
    data = np.array(data)
    if i == BATCH_DEGRADED:
        data[list(BATCH_NAN_CHANNELS), BATCH_NAN_BURST] = np.nan
        data[BATCH_FLAT_CHANNEL] = 0.25
    if i == BATCH_POISONED:
        data[:BATCH_POISON_CHANNELS, BATCH_NAN_BURST] = np.nan
    np.savez(path, data=data, x_axis=x, t_axis=t)
    return path


def _batch_folder(root: str, section) -> str:
    """The 8 files, synthesized in parallel (one spawned worker each; the
    first reuses the main path's scene)."""
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor

    day = os.path.join(root, BATCH_DATE)
    os.makedirs(day)
    _write_batch_file(day, 0, BATCH_SEEDS[0], section.data.numpy(), section.x.numpy(),
                      section.t.numpy())
    rest = list(enumerate(BATCH_SEEDS))[1:]
    with ProcessPoolExecutor(max_workers=min(len(rest), os.cpu_count() or 1),
                             mp_context=mp.get_context("spawn")) as pool:
        for fut in [pool.submit(_write_batch_file, day, i, s) for i, s in rest]:
            fut.result()
    return day


def _overlaps(events, names=("read", "preprocess")) -> int:
    """Loader spans (``names``) that overlap a compute span of another
    thread."""
    spans = [e for e in events if e["ph"] == "X"]
    comp = [e for e in spans if e["name"] == "compute"]
    return sum(1 for a in spans if a["name"] in names for c in comp
               if a["tid"] != c["tid"] and a["ts"] < c["ts"] + c["dur"]
               and c["ts"] < a["ts"] + a["dur"])


def _stage_ms(events, name: str) -> float:
    """Median duration of the ``name`` spans of a trace, in ms."""
    return float(np.median([e["dur"] / 1e3 for e in events
                            if e["ph"] == "X" and e["name"] == name]))


def phase_batch(section, nvidia_smi: str) -> dict:
    """``run_directory`` over a folder of full-size chunks on the card:
    prefetch at depths 0 and 2 against a serial loop of ``process_chunk``,
    quarantine of the planted faults, resume, the health screen on the card
    against the CPU, B1's launches, the loader's spans against compute, and
    the batch times; again with ``chunk_pipeline="fused"`` (the program cache
    emptied before each run, so its first chunk captures beside the loader),
    held to the same serial staged loop, with its files/s beside the
    staged ones."""
    import os
    import tempfile

    from scipy.signal import savgol_coeffs

    from das_diff_veh_tpu_torch.config import HealthConfig, PipelineConfig
    from das_diff_veh_tpu_torch.io.readers import DirectoryDataset
    from das_diff_veh_tpu_torch.pipeline import fused as F
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk
    from das_diff_veh_tpu_torch.pipeline.workflow import run_directory
    from das_diff_veh_tpu_torch.resilience.health import screen_arrays
    from das_diff_veh_tpu_torch.runtime import RuntimeConfig, load_trace

    cfg = PipelineConfig().replace(health=HealthConfig(enabled=True))
    cfgs = {"staged": cfg, "fused": cfg.replace(chunk_pipeline="fused")}
    computed = [i for i in range(len(BATCH_SEEDS)) if i not in (BATCH_POISONED, BATCH_GARBAGE)]
    want_quarantine = {_batch_file(BATCH_GARBAGE): "load", _batch_file(BATCH_POISONED): "compute"}
    chunk_launches = {**NO_LAUNCHES, "traj_gather": 2 * len(computed)}
    (REPO / "build").mkdir(exist_ok=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="batch_smoke_") as root:
        _batch_folder(root, section)
        folder_s = time.perf_counter() - t_phase
        log(f"batch folder: {len(BATCH_SEEDS)} files of {tuple(section.data.shape)} float64 "
            f"written in {folder_s:.1f} s")

        def dataset(smoothing: bool):
            return DirectoryDataset(BATCH_DATE, root=root, ch1=None, ch2=None,
                                    smoothing=smoothing, rescale_after=None)

        def run(depth: int, smoothing: bool = False, trace=None, pipeline="staged", **kw):
            runtime = RuntimeConfig(prefetch_depth=depth, retry_backoff_s=0.0,
                                    trace_path=trace)
            reset_counts()
            res = run_directory(dataset(smoothing), cfgs[pipeline], x_is_channels=False,
                                runtime=runtime, device="cuda", **kw)
            counts = read_counts()
            got_q = {q.key: q.stage for q in res.quarantined}
            return res, counts, got_q

        # the serial reference: process_chunk file by file, in sorted order
        ds = dataset(False)
        ref, ref_veh, ref_chunks, ref_deg = None, 0, 0, 0
        for i in computed:
            chunk = process_chunk(ds[i].to("cuda", torch.float32), cfg, x_is_channels=False,
                                  device="cuda")
            ref_deg += int(chunk.health.degraded)
            if chunk.n_windows > 0:
                img = chunk.disp_image.cpu().numpy()
                ref = img if ref is None else ref + img
                ref_veh += chunk.n_windows
                ref_chunks += 1
        log(f"batch serial reference: {ref_chunks} chunks with windows, {ref_veh} vehicles, "
            f"{ref_deg} degraded")
        if ref is None or ref_deg != 1:
            raise AssertionError("the serial reference must image vehicles and degrade file 3")

        results = {}
        for depth in (0, 2):
            trace = os.path.join(root, f"trace_depth{depth}.jsonl")
            res, counts, got_q = run(depth, trace=trace)
            events = load_trace(trace)
            spans = {e["name"] for e in events if e["ph"] == "X"}
            overlap = _overlaps(events)
            equal = res.avg_image is not None and bool(np.array_equal(res.avg_image, ref))
            log(f"batch depth {depth}: avg_image equal to the serial loop {equal}, vehicles "
                f"{res.n_vehicles}, chunks {res.n_chunks}, degraded {res.n_degraded}, "
                f"quarantined {got_q}, launches {counts}, loader spans overlapping compute "
                f"{overlap}")
            if not equal or (res.n_vehicles, res.n_chunks) != (ref_veh, ref_chunks):
                raise AssertionError(f"batch depth {depth}: the run differs from the serial loop")
            if got_q != want_quarantine or res.n_degraded != 1:
                raise AssertionError(f"batch depth {depth}: quarantined {got_q}, degraded "
                                     f"{res.n_degraded}; planted {want_quarantine} and 1")
            if counts != chunk_launches:
                raise AssertionError(f"batch depth {depth}: launches {counts}, expected "
                                     f"{chunk_launches}")
            missing = {"read", "preprocess", "device_put", "compute", "accumulate"} - spans
            if missing:
                raise AssertionError(f"batch trace lacks the spans {missing}")
            if depth == 2 and overlap == 0:
                raise AssertionError("batch depth 2: no read/preprocess span overlaps compute")
            results[depth] = {"n_vehicles": res.n_vehicles, "n_chunks": res.n_chunks,
                              "launches": counts, "loader_compute_overlaps": overlap}

        out = os.path.join(root, "out")
        first, c1, _ = run(2, out_dir=out, max_chunks=3)
        second, c2, q2 = run(2, out_dir=out)
        resumed_equal = second.avg_image is not None and bool(np.array_equal(second.avg_image,
                                                                             ref))
        log(f"batch resume: first run {c1['traj_gather'] // 2} chunks (complete "
            f"{first.complete}), second run resumed {second.n_resumed} and computed "
            f"{c2['traj_gather'] // 2}, quarantined {q2}, avg_image equal {resumed_equal}")
        if first.complete or second.n_resumed != 3 or not second.complete \
                or c2["traj_gather"] != 2 * (len(computed) - 3) or q2 != want_quarantine \
                or not resumed_equal:
            raise AssertionError("batch resume: the resumed run differs from the whole one")

        # the fused chunk: each run starts with an empty program cache, so its
        # first computed chunk warms up and captures (at depth 2 beside the
        # loader); B1 launches in the warm-up and the capture only
        fused = {}
        for depth in (0, 2, "resume"):
            F.clear_programs()
            caps, reps = F.n_captures(), F.n_replays()
            if depth == "resume":
                out_f = os.path.join(root, "out_fused")
                r1, _, _ = run(2, out_dir=out_f, max_chunks=3, pipeline="fused")
                res, counts, got_q = run(2, out_dir=out_f, pipeline="fused")
                ok = (not r1.complete and res.n_resumed == 3 and res.complete
                      and F.n_replays() - reps == len(computed))
            else:
                res, counts, got_q = run(depth, pipeline="fused")
                ok = F.n_replays() - reps == len(computed)
            equal = res.avg_image is not None and bool(np.array_equal(res.avg_image, ref))
            log(f"batch fused {depth}: avg_image equal to the serial staged loop {equal}, "
                f"vehicles {res.n_vehicles}, degraded {res.n_degraded}, quarantined {got_q}, "
                f"captures {F.n_captures() - caps}, replays {F.n_replays() - reps}, launches "
                f"{counts}")
            # the resumed half replays the program its first half captured
            want = NO_LAUNCHES if depth == "resume" else {**NO_LAUNCHES, "traj_gather": 4}
            if not (equal and ok and got_q == want_quarantine and res.n_degraded == 1
                    and F.n_captures() - caps == 1 and counts == want):
                raise AssertionError(f"batch fused {depth}: differs from the staged batch")
            fused[str(depth)] = {"equal": equal, "n_vehicles": res.n_vehicles,
                                 "replays": F.n_replays() - reps}

        data32 = ds[BATCH_DEGRADED].data.to(torch.float32)
        card_data, card_h = screen_arrays(data32.cuda(), cfg.health, tag="batch_check")
        cpu_data, cpu_h = screen_arrays(data32, cfg.health, tag="batch_check")
        screen_equal = bool(torch.equal(card_data.cpu(), cpu_data)
                            and np.array_equal(card_h.healthy, cpu_h.healthy)
                            and card_h.summary() == cpu_h.summary()
                            and card_h.nan_fraction == cpu_h.nan_fraction)
        log(f"batch health screen of file {BATCH_DEGRADED}, card vs CPU: equal {screen_equal}, "
            f"{card_h.summary()}")
        if not screen_equal or card_h.n_masked != len(BATCH_NAN_CHANNELS) + 1:
            raise AssertionError("the card's health screen differs from the CPU's")

        # the times: the reader as users run it (savgol pre-smooth on); one
        # warm run, then untraced runs at each depth in turns for chunks/s,
        # and one traced run at each depth for the time by stage
        gain = float(savgol_coeffs(21, 15).sum())
        run(2, smoothing=True)
        run(2, smoothing=True, pipeline="fused")      # the smoothed files' program
        kinds = [(pl, d) for pl in ("staged", "fused") for d in (0, 2)]
        times, traces, smooth = {k: [] for k in kinds}, {}, {}
        for rep in range(BATCH_TIMED_RUNS + 1):
            for pl, depth in kinds:
                trace = os.path.join(root, f"timed_{pl}_{depth}.jsonl") if rep == 0 else None
                res, counts, got_q = run(depth, smoothing=True, trace=trace, pipeline=pl)
                if trace is None:
                    times[pl, depth].append(res.chunks_per_s)
                else:
                    traces[pl, depth] = load_trace(trace)
                smooth.setdefault((pl, depth), (res.avg_image, res.n_vehicles, got_q))
                want = chunk_launches if pl == "staged" else NO_LAUNCHES
                if counts != want or got_q != want_quarantine:
                    raise AssertionError(f"batch timed run ({pl}): launches {counts}, "
                                         f"quarantined {got_q}")
        a0 = smooth["staged", 0]
        for k in kinds[1:]:
            a2 = smooth[k]
            same = a0[1] == a2[1] and a0[2] == a2[2] and (
                (a0[0] is None and a2[0] is None) or
                (a0[0] is not None and a2[0] is not None and np.array_equal(a0[0], a2[0])))
            if not same:
                raise AssertionError(f"batch timed runs: {k} differs from staged depth 0")
    names = ("read", "preprocess", "device_put", "compute")
    stage = {name: _stage_ms(traces["staged", 0], name) for name in names}
    # the same stages while the loader and the compute thread overlap
    stage2 = {name: _stage_ms(traces["staged", 2], name) for name in names}
    fstage = {d: {name: _stage_ms(traces["fused", d], name) for name in names} for d in (0, 2)}
    batch = {"device": nvidia_smi, "files": len(BATCH_SEEDS), "computed_chunks": len(computed),
             "chunks_per_s_depth0": float(np.median(times["staged", 0])),
             "chunks_per_s_depth2": float(np.median(times["staged", 2])),
             "chunks_per_s_runs": {f"{pl}_{d}": times[pl, d] for pl, d in times},
             "fused_chunks_per_s_depth0": float(np.median(times["fused", 0])),
             "fused_chunks_per_s_depth2": float(np.median(times["fused", 2])),
             "fused_stage_ms": {str(d): fstage[d] for d in fstage},
             "read_preprocess_ms_per_file": stage["read"] + stage["preprocess"],
             "read_ms_per_file": stage["read"], "preprocess_ms_per_file": stage["preprocess"],
             "device_staging_ms_per_file": stage["device_put"],
             "compute_ms_per_chunk": stage["compute"],
             "depth2_stage_ms": stage2,
             "loader_compute_overlaps_depth2": _overlaps(traces["staged", 2]),
             "smoothed_n_vehicles": a0[1], "savgol_21_15_dc_gain": gain,
             "launches_per_run": chunk_launches["traj_gather"], "folder_s": folder_s,
             "phase_s": time.perf_counter() - t_phase}
    log(f"batch times ({nvidia_smi}; savgol pre-smooth on, its (21, 15) DC gain {gain:.3e}, "
        f"{a0[1]} vehicles; untraced runs, staged and fused in turns): chunks/s staged depth 0 "
        f"{times['staged', 0]} (median {batch['chunks_per_s_depth0']:.3f}), depth 2 "
        f"{times['staged', 2]} (median {batch['chunks_per_s_depth2']:.3f}); fused depth 0 "
        f"{times['fused', 0]} (median {batch['fused_chunks_per_s_depth0']:.3f}), depth 2 "
        f"{times['fused', 2]} (median {batch['fused_chunks_per_s_depth2']:.3f}); per file "
        f"(medians of a traced depth-0 run): read {stage['read']:.1f} ms, preprocess "
        f"{stage['preprocess']:.1f} ms, staging {stage['device_put']:.1f} ms; compute "
        f"{stage['compute']:.1f} ms per chunk; at depth 2 "
        f"{({k: round(v, 1) for k, v in stage2.items()})}; fused "
        f"{({d: {k: round(v, 1) for k, v in fstage[d].items()} for d in fstage})}; the phase "
        f"took {batch['phase_s']:.1f} s")
    return {"batch": batch, "correctness": results, "serial_n_vehicles": ref_veh,
            "fused_correctness": fused,
            "resume": {"first_complete": first.complete, "second_resumed": second.n_resumed},
            "screen_equal": screen_equal}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm chunk of each kind and one warm "
                         "all-pairs call with torch.profiler")
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
        allpairs_kernels = phase_allpairs_times(allpairs)
        results["allpairs"] = {k: v for k, v in allpairs.items() if k != "captured"}
        del allpairs
        torch.cuda.empty_cache()
        results["long_record"] = phase_long_record()
        torch.cuda.empty_cache()
        results["dot_kernel_vs_plain"] = phase_dot_kernel_vs_plain()
        dot = phase_dot_chunk(section)
        results["dot_chunk_live"] = phase_dot_chunk_live(section)
        sw = phase_surface_wave_chunk(section)
        dot_times = phase_dot_times(dot, sw, profile=args.profile)
        results["dot_chunk"] = {k: v for k, v in dot.items()
                                if k not in ("captured", "captured_bf16", "sec32")}
        results["surface_wave_chunk"] = {k: v for k, v in sw.items() if k not in ("sec32", "cfg")}
        del dot, sw
        # B1, B2 (both tiers), B3 (both tiers), B4
        results["times"]["kernels"] += dot_times.pop("kernels") + allpairs_kernels
        results["dot_times"] = dot_times
        results["batch"] = phase_batch(section, results["device"]["nvidia_smi"])
        results["fused"] = phase_fused(section, results["device"]["nvidia_smi"])
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
    ap_ = results["allpairs"]
    log(json.dumps({"allpairs": {
        "wall_ms_median": ap_["f32"]["wall_ms_median"],
        "bf16_wall_ms_median": ap_["bf16"]["wall_ms_median"],
        "device_memory_peak_bytes": ap_["f32"]["device_memory_peak_bytes"],
        "f64_peak_rel_err": ap_["f32"]["f64_peak_rel_err"],
        "bf16_vs_f32_peak_rel": ap_["bf16"]["bf16_vs_f32_peak_rel"],
        "long_record_b3_ms": {t: results["long_record"][t]["ms"] for t in ("f32", "bf16")}}}))
    dt_ = results["dot_times"]
    log(json.dumps({"dot_chunk": {
        "wall_ms_median": dt_["dot_wall_ms_median"],
        "n_windows": results["dot_chunk"]["n_windows"],
        "image_peak_rel_err": results["dot_chunk"]["image_peak_rel_err"],
        "dot_vs_rfft_image_gap": results["dot_chunk"]["dot_vs_rfft_image_gap"],
        "bf16_vs_f32_image_gap": results["dot_chunk"]["bf16_vs_f32_image_gap"],
        "live_window_image_peak_rel_err": results["dot_chunk_live"]["image_peak_rel_err"],
        "rfft_finish_ms": dt_["rfft_finish_ms"]}}))
    log(json.dumps({"surface_wave_chunk": {
        "wall_ms_median": dt_["surface_wave_wall_ms_median"],
        "image_peak_rel_err": results["surface_wave_chunk"]["image_peak_rel_err"]}}))
    log(json.dumps({"batch": results["batch"]["batch"]}))
    fu = results["fused"]
    log(json.dumps({"fused": {
        "device": fu["device"], "pool_bytes_total": fu["pool_bytes_total"],
        "freed_bytes": fu["freed_bytes"], "released_bytes": fu["released_bytes"],
        **{label: {k: r[k] for k in ("fused_wall_ms_median", "fused_wall_ms_p90",
                                      "staged_wall_ms_median", "staged_wall_ms_p90",
                                      "warmup_s", "capture_s", "launches_per_replay",
                                      "gaps_to_staged", "pool_bytes")}
           | {"busy_share": r["profiled_replay"]["busy_share"],
              "kernels_and_copies": r["profiled_replay"]["kernels_and_copies"]}
           for label, r in fu["scenes"].items()},
        "batch_files_per_s": {k: results["batch"]["batch"][k] for k in (
            "chunks_per_s_depth0", "chunks_per_s_depth2", "fused_chunks_per_s_depth0",
            "fused_chunks_per_s_depth2")}}}))
    log(dev["nvidia_smi"])
    log(json.dumps({"kernels": results["times"]["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
