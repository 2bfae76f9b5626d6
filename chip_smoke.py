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
   x 61440 samples, 119 windows in slabs of 32); then the ambient day stack
   at the PoroTomo DASH deployment's size (``pipeline.ambient``): one
   8721 x 30000 record through ``DayStack.add`` with its launch counts (137
   of B3, none else), B3's output of the first, the first full-band and the
   last launch equal bit for bit to its plain version on that launch's own
   inputs, the pairs past the array's ends zero, a second record's time;
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
   frees the device memory;
16. mesh: ``parallel.sharded_all_pairs_peak`` at config 4 on ``make_mesh(1)``
   and on 4 slots of the card (``make_mesh(4, device="cuda")``), ``torch.equal``
   to the unsharded ``xcorr_all_pairs_peak`` in the ring, replicated and
   serialized-copy layouts and in the bf16 tier; 640 launches of B3 and 3200 of
   B4 at 4 slots; walls and memory peaks of both rings and the unsharded call
   in turns; B3 at the receiver shard's shape (64 x 2500); one planted
   ``parallel.ring`` fault through ``resilient_all_pairs_peak`` (one demotion,
   the replicated result, no second fire, the ring back after ``reset()``);
   the chunk scene's 64-slot window batch through ``sharded_stack_pipeline``
   on 1 slot (``torch.equal`` to ``stack_gathers`` and its image) and 4 slots
   (within 1e-6; 2 launches of B1 a slot); ``run_directory`` over phase 14's
   folder, staged and fused, with one planted ``runtime.compute`` fault: one
   ``gather.fused`` demotion each, B1 launched by no chunk from the failure on
   and a new fused program without it, the images within 1e-3 of the serial
   loop and of the CPU float64 chunk, B1 again after ``reset()``;
17. science: (a) ``make_window_batch(64 windows, seed 4)`` through
   ``build_gather_batch`` (2 launches of B1), ``bootstrap_disp`` with
   ``BootstrapConfig()`` (30 x 60 windows, four bands, 242 x 1000 images) in
   float64 on the card against the CPU float64 run (images within 1e-9
   peak-relative, raw ridge picks equal but near ties, counted), the float32
   run's picks printed, ``gather_disp_image(enhance=True)`` equal on both,
   and the full convergence sweep (60 sizes x 30) held to the CPU at sizes
   1, 30 and 60; (b) tests/test_full_stack.py's truth scene on the card
   (a float32 chunk, 4 launches of B1) with its assertions; (c) the speed
   search space at full width (``invert_multirun``: 3 runs x 50, 400-point
   grid, ``invalid="truncate"``; maxiter and refine steps cut to 40) on
   curves predicted from ``INVERSION_PARITY.json``'s 700_mid_speed model, in
   float64 and float32: the misfit at ``x_best`` within 1e-10 of the CPU's,
   a non-increasing history, a warm start from ``x_best`` ending at or below
   it, seconds per PSO iteration and refine step, a profiled iteration's
   busy share and kernels, memory peaks; (d) ``invert_fleet`` at (c)'s width
   (2 runs x 50, 8 refine starts; maxiter and refine steps cut to 20) over 8
   noisy copies of those curves on one slot and on ``make_mesh(4,
   device="cuda")`` (equal, or the gap printed with its cause and at most
   1e-12), intervals containing the estimates, then ``FleetVsMonitor``
   against two epochs of 8 new noise draws: of the model with its top
   layer 20 % faster (layer 0 flagged on at least 6 targets, each event
   counted in ``das_fleet_vs_shift_total`` and written as a ``vs_shift``
   record) and of the same model (its false alarms printed by layer, fewer
   than the shifted epoch's events in all and at layer 0); and
   ``phase_sensitivity`` at 3 periods against the CPU within 1e-9;
18. serve: ``ServingEngine`` + ``ImagingComputeFactory`` at the chunk scene's
   geometry (buckets 140 x 30000 and 140 x 15000, the admission health
   screen on), staged and fused: phase 14's 8 scenes, a truncated tail
   (padded), a segment one hour into the recording (rebased: no capture), a
   4-segment session and, in the fused run, one full-size request over HTTP,
   each image equal to a direct ``process_chunk`` on the card; a poison
   request over HTTP answered 422 with its structured body; ``cache_misses``
   and ``das_serve_steady_state_compiles`` 0 after warm-up; B1 2 launches a
   staged request, 2 a fused replay; closed-loop latency (p50, p99,
   requests/s) at 1 and 4 clients, the spans, the card's busy share over a
   warm request, the HTTP decode time; the dispatcher's device and stream
   against the warm-up's, and two replica slots of the card sharing the
   fused program; the dot factory (B2, both tiers, 2 launches a request);
   ``MeshServingEngine`` + ``AllPairsComputeFactory`` with the config-4 ring
   on 4 slots of the card (640 B3 and 3200 B4 launches a request) and
   2048-channel requests on 2 replicas, equal to the single-device engine
   and the direct call, walls and memory peaks in turns;
19. ops layers: (a) the CLI's ``--figures`` at its defaults (16 windows;
   where matplotlib is absent, as on the card machine, the figure set's port
   calls without the plots, and a line saying so): 2 launches of B1, held to
   its plain version bit for bit on the inputs the figure set gave it, the
   stack and the image against a CPU float64 run; (b) phase 14's folder
   through ``run_directory`` fused with a profiler window (chunks 4 and 5):
   captured, ``das_obs_profiled_steps`` 2, one Chrome trace naming B1 from
   the graph replays, the image equal to the run without the window and to
   phase 14's serial loop, files/s of both; (c) ``HBMSampler`` at 10 ms
   around one config-4 call and inside a serving engine over its warm-up and
   4 fused requests: the largest sampled bytes in use above 0 and at most
   ``das_device_peak_bytes``, which equals ``max_memory_allocated()``, the
   thread joined; (d) ``tune()`` with CUDA-event timing (each candidate
   warmed outside the clock, best of 2) over config 4 (``ring.win_block`` 2,
   4; ``ring.lagmax_block`` 256, 1024) and the dot chunk scene
   (``chunk_pipeline`` "fused", ``gather.traj_gather_finish`` "dot"): the
   trace, the winners, every candidate against the default (all-pairs within
   1e-6, the chunk within 1e-3, ``chunk_pipeline`` bit for bit), a second
   ``tune()`` hitting the store without timing; the chunk winners through
   ``run_directory`` over phase 14's folder (one ``hit`` consult, the image
   equal to the winners set by hand) and a tuned ``ServingEngine``
   (``tuned_warmups`` 1, ``cache_misses`` 0, no build after warm-up); the
   phase within 120 s and the sweeps within 60 s;
20. the mesh across processes: the parent has built the kernels; 4 gloo
   ranks (``torch.distributed``, a ``file://`` rendezvous, a 120 s group
   timeout, joined by a deadline, stragglers killed), one slot each on the
   card, load them (each prints its ``build_seconds``, which must be 0) and
   run (a) config 4 through ``sharded_all_pairs_peak`` on
   ``make_mesh(4, device="cuda:0")`` in ring mode (double-buffered and
   serialized), replicated and bf16: rank 0's matrix ``torch.equal`` to the
   unsharded call and to phase 16's single-process 4-slot ring (which rank 0
   recomputes), 160 B3 and 800 B4 launches a rank in ring mode, the bytes
   sent between ranks a call, each rank's memory peak, and the walls of
   both rings in turns; (b) the chunk scene's 64-slot window batch through
   ``sharded_stack_pipeline``, ``torch.equal`` to phase 16's 4-slot stack,
   2 B1 launches a rank; (c) an 8-target fleet at phase 17's width (maxiter
   and refine steps cut to 8) equal to one slot (the refined members within
   1e-12); (d) one ``parallel.ring`` fault planted on rank 1 only through
   ``resilient_all_pairs_peak``: every rank demotes once (one ``demotion:``
   line a rank) and rank 0's result equals the unsharded call.  With 2 or
   more cards, (a) and (b) again over NCCL, one rank a card; on one card a
   line says why not.

Every demotion of the degradation ladder is printed with its component, its
error and its phase; a demotion that phases 16 and 20 did not plant fails
the run.  The line before the last is a JSON object ``{"kernels": [...]}``,
after ``{"batch": {...}}``, ``{"fused": {...}}``, ``{"mesh": {...}}``,
``{"science": {...}}``, ``{"serve": {...}}``, ``{"ops": {...}}``,
``{"multiproc": {...}}`` and the card's name and power limit (each kernel
carries ``launches_phase19`` and ``launches_phase20``, the launches those
phases added); the last line is ``{"ok": true, "device": {...}}``.  Without
a CUDA device, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
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
            "auto_slabs_nwin119": (64, 200, 119, 513, None),
            # the day stack's launches (DAY_STACK): a full band, the band
            # clipped at row 0, the ragged last chunk against its clipped band
            "dash_full_band": (64, 664, 13, 2049, None),
            "dash_first_band": (64, 364, 13, 2049, None),
            "dash_last_chunk": (17, 317, 13, 2049, None)}
# The PoroTomo DASH day stack (``pipeline.ambient`` at ``AmbientConfig()``'s
# defaults, the cell allpairs_record): 8721 channels x 30000 samples at 1 kHz,
# 4096-sample windows at 50 % (13 windows, 2049 bins), receivers within 300
# channels, chunks of 64 sources: ceil(8721/64) = 137 launches of B3 a record.
# Launch 0 (64 x 364, its band clipped at row 0), launch 5 (the first full
# band, 64 x 664) and launch 136 (17 x 317) are held against B3's plain
# version on their own inputs, and so are the band finish's launches of the
# same chunks (csrc/band_lag_add.cu, one a chunk: whitening leaves bins
# 9..204), within DAY_STACK_BAND_GAP of each gather's peak.
DAY_STACK = dict(nch=8721, nt=30000, seed=29)
DAY_STACK_LAUNCHES = {"traj_gather": 0, "traj_dot": 0, "cross_spectra": 137, "lag_absmax": 0}
DAY_STACK_BAND_LAUNCHES = 137
DAY_STACK_BAND_GAP = 1e-6
DAY_STACK_HELD = {0: (64, 364), 5: (64, 664), 136: (17, 317)}
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

# Phase 16: the config-4 ring over 4 slots of the card.  Each slot holds
# 10000 / 4 = 2500 rows; per step and slot ceil(2500/64) = 40 launches of B3
# and 40 * ceil(2500/512) = 200 of B4, over 4 steps and 4 slots.
MESH_SLOTS = 4
MESH_LAUNCHES = {"traj_gather": 0, "traj_dot": 0, "cross_spectra": 640, "lag_absmax": 3200}
# The sharded stack over 4 slots adds the slots' window sums in another order
# than one sum over the 64 slots: float32 rounding only.
STACK_REL_TOL = 1e-6
GATHER_FAULT_FILE = 1              # a computed file of the batch folder


class DemotionWatch:
    """The flight recorder of the process's degradation ladder in this run:
    it prints every demotion with its component, its error and the phase it
    happened in.  Phase 16 marks the demotions it plants; any other one fails
    the run, so a fallback never hides a failed kernel."""

    def __init__(self):
        self.phase = "start"
        self.seen = []

    def record(self, kind: str, **fields) -> None:
        if kind == "degrade":
            self.seen.append({"phase": self.phase, "component": fields["component"],
                              "error": fields["error"], "planted": False})
            log(f"demotion: component {fields['component']}, error {fields['error']!r}, "
                f"phase {self.phase}")

    def planted(self, since: int, component: str) -> dict:
        """The one demotion since ``since``, which must be of ``component``."""
        new = self.seen[since:]
        if len(new) != 1 or new[0]["component"] != component:
            raise AssertionError(f"phase {self.phase}: planted one {component} demotion, "
                                 f"saw {new}")
        new[0]["planted"] = True
        return new[0]


WATCH = DemotionWatch()


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
            "captured": captured, "sec32": sec32, "cfg": cfg, "cpu_image": ref.disp_image}


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


def phase_day_stack() -> dict:
    """One PoroTomo DASH record (``DAY_STACK``) through ``DayStack.add`` on
    the card: its launch counts, B3's output of the launches in
    ``DAY_STACK_HELD`` against its plain version on those launches' own
    inputs (bit for bit, as in ``phase_allpairs_kernels_vs_plain``), the
    band finish's launches of the same chunks against its plain version
    (:func:`_band_finish_held`), the pairs past either end of the array
    zero, a second record's time, then the band finish's times
    (:func:`_band_finish_times`)."""
    from das_diff_veh_tpu_torch.config import AmbientConfig
    from das_diff_veh_tpu_torch.ops import band_lag_add as bla
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.ops import lag_absmax as la
    from das_diff_veh_tpu_torch.pipeline.ambient import DayStack
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    cfg = AmbientConfig()
    nch = DAY_STACK["nch"]
    rec = make_ambient_record(nch, DAY_STACK["nt"], seed=DAY_STACK["seed"])
    stack = DayStack(nch, cfg)
    kept: dict = {}
    band_kept: dict = {}
    launch, band_launch = cs.cross_spectra_cuda, bla.band_lag_add_cuda
    seen, band_seen = [0], [0]

    def keeping(*args):
        out = launch(*args)
        if seen[0] in DAY_STACK_HELD:
            kept[seen[0]] = (args, out)
        seen[0] += 1
        return out

    def band_keeping(cross, out, *rest):
        band_launch(cross, out, *rest)
        if band_seen[0] in DAY_STACK_HELD:       # the stack's rows held nothing before
            band_kept[band_seen[0]] = (cross, rest, out.clone())
        band_seen[0] += 1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bla.band_lag_add_cuda = band_keeping
    try:
        with swapped_launches(keeping, la.lag_absmax_cuda):
            reset_counts()
            b0 = bla.launches
            t0 = time.perf_counter()
            stack.add(rec)
            first_s = time.perf_counter() - t0
            counts = read_counts()
            band_launches = bla.launches - b0
    finally:
        bla.band_lag_add_cuda = band_launch
    log(f"day stack: DayStack.add of {tuple(rec.shape)} into {tuple(stack.sum.shape)} in "
        f"{first_s:.3f} s (first call), launches {counts}, band finish {band_launches}")
    if counts != DAY_STACK_LAUNCHES or band_launches != DAY_STACK_BAND_LAUNCHES:
        raise AssertionError(f"expected launches {DAY_STACK_LAUNCHES} and "
                             f"{DAY_STACK_BAND_LAUNCHES} of the band finish in the day stack, "
                             f"got {counts} and {band_launches}")
    band_held = _band_finish_held(band_kept)
    held = {}
    for i, (src, rcv, nwin, wb), out in ((i, *kept[i]) for i in sorted(DAY_STACK_HELD)):
        shape = (src.shape[0], rcv.shape[0])
        p = cs.cross_spectra_plain(src, rcv, nwin, wb)
        torch.cuda.synchronize()
        equal = shape == DAY_STACK_HELD[i] and bool(torch.equal(out, p))
        log(f"day stack B3 launch {i} vs plain [m={shape[0]} nall={shape[1]} nwin={nwin} "
            f"nf={src.shape[2]} win_block={wb}]: equal={equal}")
        if not equal:
            raise AssertionError(f"day stack: B3 launch {i} ({shape}, expected "
                                 f"{DAY_STACK_HELD[i]}) != its plain version")
        held[f"launch{i}"] = {"m": shape[0], "nall": shape[1], "equal": True}
        del p
    del kept
    ends = stack.flush([0, nch - 1])
    off = cfg.max_offset
    zero_outside = bool(np.all(ends[0, :off] == 0) and np.all(ends[1, off + 1:] == 0))
    live_inside = bool(np.all(np.isfinite(ends)) and np.all(np.abs(ends[0, off:]).max(axis=1) > 0)
                       and np.all(np.abs(ends[1, :off + 1]).max(axis=1) > 0))
    log(f"day stack: pairs past the array's ends zero {zero_outside}, finite and live "
        f"inside {live_inside}")
    if not (zero_outside and live_inside):
        raise AssertionError("day stack: the end sources' gathers are not zero exactly past "
                             "the array's ends")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stack.add(rec)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"day stack: second record {warm_s:.3f} s, memory peak {peak} B")
    del stack, rec
    torch.cuda.empty_cache()
    band_times = _band_finish_times(band_kept[5], cfg)
    del band_kept
    torch.cuda.empty_cache()
    return {"first_add_s": first_s, "warm_add_s": warm_s,
            "launches": {**counts, "band_lag_add": band_launches},
            "held_vs_plain": held, "band_held_vs_plain": band_held,
            "band_finish_times": band_times, "ends_zero_outside": True,
            "memory_peak_bytes": peak}


def _band_finish_held(band_kept: dict) -> dict:
    """Each held launch of the band finish (its cross-spectra and the stack
    rows it wrote, which held zeros before) against the plain version on
    the same inputs on the card, within ``DAY_STACK_BAND_GAP`` of each
    gather's peak."""
    from das_diff_veh_tpu_torch.ops import band_lag_add as bla

    held = {}
    for i in sorted(DAY_STACK_HELD):
        cross, (lead, lo, hi, wlen, lag), got = band_kept[i]
        want = torch.zeros_like(got)
        bla.band_lag_add_plain(cross, want, lead, lo, hi, wlen, lag)
        torch.cuda.synchronize()
        peak = want.abs().flatten(1).amax(1)
        gap = float(((got - want).abs().flatten(1).amax(1) / peak).max())
        shape = (cross.shape[0], cross.shape[1])
        log(f"day stack band finish launch {i} vs plain [m={shape[0]} nb={shape[1]} "
            f"lead={lead} bins {lo}..{hi}]: gap {gap:.3e} of each gather's peak")
        if shape != DAY_STACK_HELD[i] or not gap <= DAY_STACK_BAND_GAP:
            raise AssertionError(f"day stack: band finish launch {i} ({shape}) is {gap} of "
                                 f"its gathers' peaks off its plain version")
        held[f"launch{i}"] = {"m": shape[0], "nb": shape[1], "gap": gap}
        del want
    return held


def _band_finish_times(launch5, cfg) -> dict:
    """The band finish on a full chunk's inputs (launch 5: 64 sources x
    664 receiver rows) into a scratch stack slice, between CUDA events,
    beside its bound, its plain version, and the irfft finish it replaces
    on the same chunk (``_banded_finish`` without a band: the clone cuFFT
    asks for, the padded c2r and the strided band add) as the yardstick."""
    from das_diff_veh_tpu_torch.ops import all_pairs as ap
    from das_diff_veh_tpu_torch.ops import band_lag_add as bla

    cross, (lead, lo, hi, wlen, lag), _ = launch5
    m, nb = cross.shape[:2]
    width = 2 * cfg.max_offset + 1
    s0 = 5 * cfg.src_chunk
    r0 = s0 - cfg.max_offset + lead
    scratch = torch.zeros((m, width, 2 * lag + 1), device=cross.device)
    ms = event_ms(lambda: bla.band_lag_add_cuda(cross, scratch, lead, lo, hi, wlen, lag),
                  reps=20)
    plain_ms = event_ms(lambda: bla.band_lag_add_plain(cross, scratch, lead, lo, hi, wlen, lag),
                        reps=2)
    irfft_ms = event_ms(lambda: ap._banded_finish(cross, scratch, s0, r0, wlen, cfg.max_offset,
                                                  lag, cfg.src_chunk), reps=20)
    nbytes = bla.bytes_moved(m, nb, width, lead, lo, hi, lag)
    ops = bla.flops(m, nb, width, lead, lo, hi, wlen, lag)
    bound, by = _bound(nbytes, ops)
    log(f"band finish per launch [m={m} nb={nb} bins {lo}..{hi}]: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, irfft finish {irfft_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
        f"{nbytes / 1e9:.3f} GB, {ops / 1e9:.1f} GFLOP), {100 * bound / ms:.1f} % of it")
    del scratch
    return {"ms": ms, "plain_ms": plain_ms, "irfft_finish_ms": irfft_ms, "bound_ms": bound,
            "bound_by": by, "bytes": nbytes, "flops": ops,
            "source": "das_diff_veh_tpu_torch/csrc/band_lag_add.cu", "replaces": None}


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


def phase_batch(section, nvidia_smi: str, root: str) -> dict:
    """``run_directory`` over a folder of full-size chunks on the card:
    prefetch at depths 0 and 2 against a serial loop of ``process_chunk``,
    quarantine of the planted faults, resume, the health screen on the card
    against the CPU, B1's launches, the loader's spans against compute, and
    the batch times; again with ``chunk_pipeline="fused"`` (the program cache
    emptied before each run, so its first chunk captures beside the loader),
    held to the same serial staged loop, with its files/s beside the
    staged ones."""
    import os

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
    t_phase = time.perf_counter()
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
    serial_images = {}
    for i in computed:
        chunk = process_chunk(ds[i].to("cuda", torch.float32), cfg, x_is_channels=False,
                              device="cuda")
        ref_deg += int(chunk.health.degraded)
        if chunk.n_windows > 0:
            img = serial_images[i] = chunk.disp_image.cpu().numpy()
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
            "serial_images": serial_images,
            "fused_correctness": fused,
            "resume": {"first_complete": first.complete, "second_resumed": second.n_resumed},
            "screen_equal": screen_equal}


def _mesh_ring(nvidia_smi: str) -> dict:
    """The config-4 ring on one slot and on 4 slots of the card against the
    unsharded call, bit for bit: launch counts, every mode and buffering, the
    bf16 tier, walls and memory peaks in turns, B3 at the shard's shape, and
    the all-pairs ladder with one planted ring fault."""
    from das_diff_veh_tpu_torch.config import RingConfig
    from das_diff_veh_tpu_torch.obs.registry import default_registry
    from das_diff_veh_tpu_torch.ops import all_pairs as ap
    from das_diff_veh_tpu_torch.parallel import make_mesh, sharded_all_pairs_peak
    from das_diff_veh_tpu_torch.resilience import degrade, faults
    from das_diff_veh_tpu_torch.resilience.faults import FaultPlan, FaultSpec
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    wlen = ALLPAIRS["wlen"]
    rec = make_ambient_record(ALLPAIRS["nch"], ALLPAIRS["nt"], seed=ALLPAIRS["seed"])
    mesh1, mesh4 = make_mesh(1), make_mesh(MESH_SLOTS, device="cuda")
    want = ap.xcorr_all_pairs_peak(rec, wlen)
    out = {"slots": MESH_SLOTS, "devices": [str(d) for d in mesh4.devices]}

    def ring(mesh, **kw):
        return sharded_all_pairs_peak(rec, wlen, mesh, **kw)

    captured = {}
    with first_inputs(captured):
        torch.cuda.synchronize()
        reset_counts()
        got4 = ring(mesh4)
        torch.cuda.synchronize()
        counts4 = read_counts()
    reset_counts()
    got1 = ring(mesh1)
    torch.cuda.synchronize()
    counts1 = read_counts()
    replicated = ring(mesh4, ring=RingConfig(mode="replicated"))
    equal = {"d4": bool(torch.equal(got4, want)), "d1": bool(torch.equal(got1, want)),
             "d4_replicated": bool(torch.equal(replicated, want)),
             "d4_serialized_copies": bool(torch.equal(ring(mesh4, ring=RingConfig(
                 double_buffer=False)), want))}
    del got1
    want_bf16 = ap.xcorr_all_pairs_peak(rec, wlen, precision="bf16")
    equal["d4_bf16"] = bool(torch.equal(ring(mesh4, ring=RingConfig(precision="bf16")),
                                        want_bf16))
    del want_bf16
    log(f"mesh ring at config 4 ({tuple(rec.shape)}, wlen {wlen}): launches at D=4 {counts4} "
        f"(reckoned {MESH_LAUNCHES}), at D=1 {counts1} (unsharded {ALLPAIRS_LAUNCHES}); "
        f"torch.equal to the unsharded call {equal}")
    if counts4 != MESH_LAUNCHES or counts1 != ALLPAIRS_LAUNCHES:
        raise AssertionError(f"ring launches {counts4} / {counts1}")
    if not all(equal.values()):
        raise AssertionError(f"the ring differs from the unsharded call: {equal}")
    if not (got4.is_cuda and got4.dtype == torch.float32 and tuple(got4.shape) == tuple(
            want.shape) and bool(torch.isfinite(got4).all())):
        raise AssertionError("the ring's peaks must be a finite (nch, nch) float32 tensor")
    del got4
    out.update(launches_d4=counts4, launches_d1=counts1, equal=equal)

    # walls and memory peaks: 3 warm calls of each, in turns
    calls = {"ring_d1": lambda: ring(mesh1), "ring_d4": lambda: ring(mesh4),
             "unsharded": lambda: ap.xcorr_all_pairs_peak(rec, wlen)}
    walls = {k: [] for k in calls}
    peaks = {k: 0 for k in calls}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    for _ in range(3):
        for label, fn in calls.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[label].append((time.perf_counter() - t0) * 1e3)
            peaks[label] = max(peaks[label], torch.cuda.max_memory_allocated())
    med = {k: float(np.median(v)) for k, v in walls.items()}
    log(f"mesh walls ({nvidia_smi}; ms, 3 warm calls each, in turns): "
        f"{({k: [round(w, 3) for w in v] for k, v in walls.items()})}, medians "
        f"{({k: round(v, 3) for k, v in med.items()})}; device memory peaks {peaks} B "
        f"({held} B held before the calls)")
    out.update(wall_ms=walls, wall_ms_median=med, device_memory_peak_bytes=peaks,
               device_memory_held_bytes=held)

    # B3 on the inputs of the D=4 ring's first launch: 64 sources x 2500 receivers
    src, rcv, nwin, wb = captured["cross_spectra"]
    b3 = _b3_times(src, rcv, nwin, wb, "f32")
    del captured, src, rcv
    kernel = {"name": "cross_spectra_ring_shard", "route": "cuda",
              "source": "das_diff_veh_tpu_torch/csrc/cross_spectra.cu",
              "replaces": "das_diff_veh_tpu/ops/pallas_xcorr.py:230",
              "launches": counts4["cross_spectra"], **b3}

    # the all-pairs ladder: one planted ring fault -> the replicated layout
    reg = default_registry()
    builds = reg.counter("das_ring_builds_total", "", labels=("mode",))
    WATCH.phase = "16 mesh: all-pairs ladder"
    n0 = len(WATCH.seen)
    with faults.injected(FaultPlan(specs=(FaultSpec("parallel.ring", "error"),))) as inj:
        fell = degrade.resilient_all_pairs_peak(rec, wlen, mesh4)
        fired = inj.n_injected
        again = degrade.resilient_all_pairs_peak(rec, wlen, mesh4)
        fired_again = inj.n_injected
    demotion = WATCH.planted(n0, degrade.PARALLEL_RING)
    same = bool(torch.equal(fell, replicated) and torch.equal(again, replicated))
    del fell, again, replicated
    degrade.reset()
    rings = builds.labels(mode="ring").value
    restored = bool(torch.equal(degrade.resilient_all_pairs_peak(rec, wlen, mesh4), want))
    ring_after_reset = builds.labels(mode="ring").value - rings
    log(f"mesh all-pairs ladder: planted parallel.ring fault fired {fired} time(s), a second "
        f"call fired {fired_again - fired} more; demoted once ({demotion['error']}); output "
        f"equal to the replicated layout {same}; after reset() the ring ran again "
        f"({ring_after_reset:.0f} ring call) and equals the unsharded call {restored}")
    if not (fired == fired_again == 1 and same and restored and ring_after_reset == 1
            and len(WATCH.seen) == n0 + 1):
        raise AssertionError("the all-pairs ladder did not fall back and recover as planted")
    out["ladder"] = {"fired": fired, "second_call_fired": fired_again - fired,
                     "equal_to_replicated": same, "restored_equal": restored}
    return out, kernel


def _mesh_stack(section, nvidia_smi: str) -> dict:
    """The chunk scene's 64-slot window batch through the sharded stack on 1
    and 4 slots of the card against ``stack_gathers`` and its image."""
    from das_diff_veh_tpu_torch.config import PipelineConfig
    from das_diff_veh_tpu_torch.models import vsg as V
    from das_diff_veh_tpu_torch.parallel import make_mesh, sharded_stack_pipeline
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    cfg = PipelineConfig()
    res = process_chunk(section.to("cuda", torch.float32), cfg, device="cuda")
    batch = res.batch
    g, offs, dt = _gather_geometry(section, cfg)
    stack1 = V.stack_gathers(V.build_gather_batch(batch, g, cfg.gather), batch.valid)
    img1 = V.gather_disp_image(stack1, offs, dt, cfg.interrogator.dx, cfg.dispersion,
                               cfg.imaging.disp_start_x, cfg.imaging.disp_end_x)
    out = {"max_windows": batch.max_windows, "n_windows": int(batch.valid.sum())}
    for slots in (1, MESH_SLOTS):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        stack, img = sharded_stack_pipeline(
            batch, g, offs, make_mesh(slots, device="cuda"), cfg.gather, cfg.dispersion,
            disp_start_x=cfg.imaging.disp_start_x, disp_end_x=cfg.imaging.disp_end_x,
            dx=cfg.interrogator.dx)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        equal = bool(torch.equal(stack, stack1) and torch.equal(img, img1))
        gaps = (peak_rel(stack, stack1), peak_rel(img, img1))
        log(f"mesh sharded stack on {slots} slot(s) ({out['max_windows']} window slots, "
            f"{out['n_windows']} valid): launches {counts}, torch.equal to stack_gathers and "
            f"its image {equal}, peak-rel stack {gaps[0]:.3e} image {gaps[1]:.3e}, wall "
            f"{wall:.3f} ms (first call)")
        if counts != {**NO_LAUNCHES, "traj_gather": 2 * slots}:
            raise AssertionError(f"sharded stack on {slots} slots: launches {counts}")
        if (slots == 1 and not equal) or max(gaps) > STACK_REL_TOL:
            raise AssertionError(f"sharded stack on {slots} slots differs: {gaps}")
        out[f"d{slots}"] = {"launches": counts, "equal": equal, "stack_peak_rel": gaps[0],
                            "image_peak_rel": gaps[1]}
    return out


def _mesh_gather_ladder(cpu_image, root: str, serial_images: dict) -> dict:
    """``run_directory`` over phase 14's folder, staged then fused, with one
    planted compute fault: one ``gather.fused`` demotion each, no launch of
    B1 from the failure on, a new fused program without it, the images
    within the card's bar; after ``reset()`` B1 again."""
    from das_diff_veh_tpu_torch.config import HealthConfig, PipelineConfig
    from das_diff_veh_tpu_torch.io.readers import DirectoryDataset
    from das_diff_veh_tpu_torch.pipeline import fused as F
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk
    from das_diff_veh_tpu_torch.pipeline.workflow import run_directory
    from das_diff_veh_tpu_torch.resilience import degrade, faults
    from das_diff_veh_tpu_torch.resilience.faults import FaultPlan, FaultSpec
    from das_diff_veh_tpu_torch.runtime import RuntimeConfig

    cfg = PipelineConfig().replace(health=HealthConfig(enabled=True))
    key = _batch_file(GATHER_FAULT_FILE)
    plan = FaultPlan(specs=(FaultSpec("runtime.compute", "error", keys=(key,)),))
    want_q = {_batch_file(BATCH_GARBAGE): "load", _batch_file(BATCH_POISONED): "compute",
              key: "compute"}
    # the files after the fault run the serialized cut; the sum of the
    # serial loop's images (kernel route) without the failed file
    ref = sum(img for i, img in serial_images.items() if i != GATHER_FAULT_FILE)
    ds = DirectoryDataset(BATCH_DATE, root=root, ch1=None, ch2=None, smoothing=False,
                          rescale_after=None)
    # file 0 holds the main path's scene, so its CPU float64 image is phase 4's;
    # read back from the folder it keys the run's fused program
    sec32 = ds[0].to("cuda", torch.float32)
    out = {}
    for pipeline in ("staged", "fused"):
        pcfg = cfg.replace(chunk_pipeline=pipeline)
        F.clear_programs()
        caps = F.n_captures()
        WATCH.phase = f"16 mesh: gather ladder ({pipeline})"
        n0 = len(WATCH.seen)
        reset_counts()
        with faults.injected(plan):
            res = run_directory(ds, pcfg, x_is_channels=False, device="cuda",
                                runtime=RuntimeConfig(prefetch_depth=0, retry_backoff_s=0.0))
        counts = read_counts()
        demotion = WATCH.planted(n0, degrade.GATHER_FUSED)
        got_q = {q.key: q.stage for q in res.quarantined}
        gap = peak_rel(torch.from_numpy(res.avg_image), torch.from_numpy(ref))
        # file 0 runs before the fault: 2 launches staged; fused, its program's
        # warm-up and capture launch 2 each.  Nothing launches B1 afterwards.
        want_counts = {**NO_LAUNCHES, "traj_gather": 2 if pipeline == "staged" else 4}
        progs = F.programs()
        new_prog = progs[-1].launches_per_replay if pipeline == "fused" else None
        # one chunk of the main scene while demoted, against its CPU float64 run
        reset_counts()
        single = process_chunk(sec32, pcfg, x_is_channels=False, device="cuda")
        torch.cuda.synchronize()
        single_counts = read_counts()
        single_gap = peak_rel(single.disp_image, cpu_image)
        log(f"mesh gather ladder ({pipeline}): planted runtime.compute fault on {key}; "
            f"demotions {[(d['component'], d['error']) for d in WATCH.seen[n0:]]}; quarantined "
            f"{got_q}; launches over the run {counts}; captures {F.n_captures() - caps}, the "
            f"demoted program's launches per replay {new_prog}; avg image vs the serial loop "
            f"without the failed file peak-rel {gap:.3e}; a chunk of the main scene while "
            f"demoted: launches {single_counts}, image vs CPU float64 peak-rel "
            f"{single_gap:.3e} (tol {IMAGE_PEAK_REL_TOL})")
        ok = (got_q == want_q and counts == want_counts and single_counts == NO_LAUNCHES
              and gap <= IMAGE_PEAK_REL_TOL and single_gap <= IMAGE_PEAK_REL_TOL)
        if pipeline == "fused":
            ok = ok and F.n_captures() - caps == 2 and len(progs) == 2 and \
                new_prog == {"traj_gather": 0, "traj_dot": 0}
        if not ok:
            raise AssertionError(f"gather ladder ({pipeline}) did not run as planted")
        degrade.reset()
        # after reset(): the kernel route again (fused: the first program)
        caps = F.n_captures()
        reset_counts()
        back = process_chunk(sec32, pcfg, x_is_channels=False, device="cuda")
        torch.cuda.synchronize()
        back_counts = read_counts()
        back_gap = peak_rel(back.disp_image, cpu_image)
        if pipeline == "staged":
            relaunched = back_counts == {**NO_LAUNCHES, "traj_gather": 2}
        else:
            relaunched = (back_counts == NO_LAUNCHES and F.n_captures() == caps
                          and progs[0].launches_per_replay["traj_gather"] == 2)
        log(f"mesh gather ladder ({pipeline}) after reset(): launches {back_counts}, "
            f"captures {F.n_captures() - caps}, B1 on the route again {relaunched}, image vs "
            f"CPU float64 peak-rel {back_gap:.3e}")
        if not (relaunched and back_gap <= IMAGE_PEAK_REL_TOL):
            raise AssertionError(f"gather ladder ({pipeline}): B1 did not come back")
        out[pipeline] = {"demotion_error": demotion["error"], "quarantined": got_q,
                         "launches": counts, "avg_image_peak_rel": gap,
                         "demoted_chunk_image_peak_rel": single_gap,
                         "after_reset_launches": back_counts, "after_reset_peak_rel": back_gap}
    F.clear_programs()
    return out


def phase_mesh(section, cpu_image, root: str, serial_images: dict, nvidia_smi: str) -> tuple:
    """Phase 16: the all-pairs ring and the window-sharded stack over a mesh of
    slots of the card, and both consumers of the degradation ladder."""
    t0 = time.perf_counter()
    WATCH.phase = "16 mesh: ring"
    ring, kernel = _mesh_ring(nvidia_smi)
    torch.cuda.empty_cache()
    WATCH.phase = "16 mesh: sharded stack"
    stack = _mesh_stack(section, nvidia_smi)
    gather = _mesh_gather_ladder(cpu_image, root, serial_images)
    mesh = {"device": nvidia_smi, "ring": ring, "stack": stack, "gather_ladder": gather,
            "phase_s": time.perf_counter() - t0}
    log(f"mesh phase ({nvidia_smi}) took {mesh['phase_s']:.1f} s")
    return mesh, kernel


# Phase 17: the science path.  (a) the bootstrap at the reference's size:
# make_window_batch(64 windows, seed 4), BootstrapConfig() (30 repetitions x
# 60 windows, four bands) on DispersionConfig()'s 242 x 1000 grid, and the
# full convergence sweep (60 sizes x 30 repetitions); (b) the truth scene of
# tests/test_full_stack.py; (c) BASELINE config 5's search space at full
# width, the depth cut; (d) a fleet of 8 targets and the monitor.
SCIENCE_WINDOWS = dict(n_windows=64, seed=4)
# float64 on both devices: cuFFT and MKL/pocketfft round otherwise per
# transform (~1e-16 relative); 1e-9 peak-relative leaves a factor 1e6
SCIENCE_IMAGE_TOL = 1e-9
SCIENCE_MISFIT_TOL = 1e-10
SCIENCE_SENS_TOL = 1e-9
# the reference's convergence sweep (imaging_diff_speed cells 30-31): bt_size
# 1..60, 30 repetitions each; compared with the CPU at three sizes
SCIENCE_CONV = dict(max_sample_num=60, bt_times=30)
SCIENCE_CONV_AT = (1, 30, 60)
# (c): invert_multirun at BASELINE config 5's width; maxiter and the refine
# steps cut to fit the run (reference 1000 iterations; the parity runs 400
# iterations and 250 refine steps, INVERSION_PARITY.json "config")
SCIENCE_SEARCH = dict(n_runs=3, popsize=50, n_grid=400, n_subdiv=1, n_refine_starts=8,
                      invalid="truncate", maxiter=40, n_refine_steps=40, seed=0)
SCIENCE_REDUCED = {"maxiter": {"run": 40, "reference": 1000, "parity": 400},
                   "n_refine_steps": {"run": 40, "parity": 250},
                   "fleet_maxiter": {"run": 20, "invert_fleet_default": 200},
                   "fleet_n_refine_steps": {"run": 20, "invert_fleet_default": 80}}
# scripts/inversion_parity.py:83, 700_mid_speed: (BootstrapConfig band, mode, weight)
SCIENCE_BANDS = ((0, 0, 2.0), (2, 3, 1.0), (3, 4, 1.0))
# (d): (c)'s width (popsize 50, 8 refine starts, 400-point grid), the depth cut
SCIENCE_FLEET = dict(n_runs=2, maxiter=20, popsize=50, n_refine_starts=8, n_refine_steps=20,
                     n_grid=400, invalid="truncate", seed=0)
SCIENCE_TARGETS = 8
# the monitor's bars.  A credible interval is the spread of one search's
# ensemble, not of the estimate over noise draws, so an unshifted epoch
# flags layers too (11 of 48 cells on the H100); its false alarms are
# printed by layer and held below the shifted epoch's, in all and at the
# shifted layer (layer 0), which must be flagged on at least 6 targets
SCIENCE_MONITOR = {"shifted_layer0_min": 6}
# B1 in phase 17: the 64-window batch (2), the truth scene's chunk (2) and
# its per-window gathers (2)
SCIENCE_LAUNCHES = {"traj_gather": 6, "traj_dot": 0, "cross_spectra": 0, "lag_absmax": 0}


def _ridge_pick_check(img_card, img_cpu, freqs, vels, bcfg) -> dict:
    """Raw ridge picks (a one-tap smoother) of the card's and the CPU's
    images, band by band: equal, except where the CPU image's values at the
    two picks lie within 1e-9 of its peak (a near tie), counted."""
    from das_diff_veh_tpu_torch.analysis.ridge import extract_ridge_batch

    out = {"compared": 0, "differ": 0, "near_ties": 0}
    for m in range(len(bcfg.freq_lb)):
        band = (freqs >= bcfg.freq_lb[m]) & (freqs < bcfg.freq_ub[m])
        ref_idx = int(bcfg.ref_freq_idx[m] - np.sum(freqs < bcfg.freq_lb[m]))
        cols = np.nonzero(band)[0]
        picks = []
        for img in (img_card, img_cpu):
            sub = img[:, :, torch.as_tensor(cols, device=img.device)]
            picks.append(extract_ridge_batch(freqs[band], vels, sub, ref_freq_idx=ref_idx,
                                             sigma=float(bcfg.sigma[m]), vel_max=bcfg.vel_max,
                                             sg_window=1, sg_order=0).cpu().numpy())
        cpu = img_cpu.cpu().numpy()
        out["compared"] += picks[0].size
        for r, j in zip(*np.nonzero(picks[0] != picks[1])):
            rows = [int(round((p[r, j] - vels[0]) / (vels[1] - vels[0]))) for p in picks]
            col = cpu[r, :, cols[j]]
            gap = abs(col[rows[0]] - col[rows[1]]) / np.abs(cpu[r]).max()
            out["differ"] += 1
            out["near_ties"] += int(gap <= 1e-9)
    if out["differ"] != out["near_ties"]:
        raise AssertionError(f"ridge picks differ beyond near ties: {out}")
    return out


def _science_bootstrap(nvidia_smi: str) -> dict:
    """(a): the bootstrap and the convergence sweep at the reference's size."""
    from das_diff_veh_tpu_torch import workloads
    from das_diff_veh_tpu_torch.analysis import bootstrap as B
    from das_diff_veh_tpu_torch.config import (BootstrapConfig, DispersionConfig,
                                               GatherConfig, ImagingConfig)
    from das_diff_veh_tpu_torch.models import vsg as V

    gcfg, dcfg, bcfg, icfg = GatherConfig(), DispersionConfig(), BootstrapConfig(), ImagingConfig()
    batch32, x = workloads.make_window_batch(**SCIENCE_WINDOWS, device="cuda")
    geo = workloads.make_gather_geometry(x)
    gathers32 = V.build_gather_batch(batch32, geo, gcfg)                 # B1, 2 launches
    batch64, _ = workloads.make_window_batch(**SCIENCE_WINDOWS, dtype=np.float64, device="cpu")
    gathers_cpu = V.build_gather_batch(batch64, geo, gcfg)
    gathers64 = gathers_cpu.to("cuda")
    gather_gap = peak_rel(gathers32, gathers_cpu)
    offs, dt, dx = geo.offsets(x), geo.dt, 8.16
    args = (offs, dt, dx)
    win = dict(disp_start_x=icfg.disp_start_x, disp_end_x=icfg.disp_end_x)
    n = SCIENCE_WINDOWS["n_windows"]
    idx = B.sample_indices(n, bcfg.bt_size, bcfg.bt_times, np.random.default_rng(0))

    images = {}
    for name, g in (("card", gathers64), ("cpu", gathers_cpu)):
        stacks = B._resample_stacks(g, torch.as_tensor(idx, device=g.device))
        images[name] = V.gather_disp_image(stacks, offs, dt, dx, dcfg, icfg.disp_start_x,
                                           icfg.disp_end_x)
    image_err = peak_rel(images["card"], images["cpu"])
    log(f"bootstrap images (30 x {tuple(images['card'].shape[1:])}), card float64 vs CPU "
        f"float64: peak-rel {image_err:.3e}; f32 gathers (B1) vs CPU f64 gathers: "
        f"{gather_gap:.3e}")
    if not image_err <= SCIENCE_IMAGE_TOL:
        raise AssertionError(f"bootstrap images differ by {image_err:.3e}")
    picks = _ridge_pick_check(images["card"], images["cpu"], dcfg.freqs(), dcfg.vels(), bcfg)
    log(f"raw ridge picks card vs CPU: {picks}")
    enh_card = V.gather_disp_image(gathers64[1], offs, dt, dx, dcfg, enhance=True, **{
        "start_x": icfg.disp_start_x, "end_x": icfg.disp_end_x})
    enh_cpu = V.gather_disp_image(gathers_cpu[1], offs, dt, dx, dcfg, enhance=True, **{
        "start_x": icfg.disp_start_x, "end_x": icfg.disp_end_x})
    if enh_card.dtype != torch.int32 or not torch.equal(enh_card.cpu(), enh_cpu):
        raise AssertionError("enhanced image differs between the card and the CPU")
    del images

    walls = {}
    ridges = {}
    for name, g in (("f64", gathers64), ("f32", gathers32), ("cpu_f64", gathers_cpu)):
        for _ in range(2):                  # the second call is warm (plans, constants)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ridges[name], freqs = B.bootstrap_disp(g, *args, idx, bcfg, dcfg, **win)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
    smooth_gap = max(float(np.abs(a - b).max()) for a, b in zip(ridges["f64"], ridges["cpu_f64"]))
    f32_gap = [np.abs(a - b) for a, b in zip(ridges["f32"], ridges["cpu_f64"])]
    f32 = {"max_abs_m_s": max(float(d.max()) for d in f32_gap),
           "share_within_1_m_s": float(np.mean(np.concatenate([d.ravel() for d in f32_gap])
                                              <= 1.0))}
    log(f"bootstrap_disp (30 x 60, 4 bands) walls ({nvidia_smi}): card f64 {walls['f64']:.3f} s, "
        f"card f32 {walls['f32']:.3f} s, CPU f64 {walls['cpu_f64']:.3f} s; smoothed ridges "
        f"card f64 vs CPU {smooth_gap:.3e} m/s; f32 vs CPU f64 {f32}")
    if picks["near_ties"] == 0 and not smooth_gap <= 1e-6:
        raise AssertionError(f"bootstrap ridges differ by {smooth_gap} m/s without a near tie")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    top, reps = SCIENCE_CONV["max_sample_num"], SCIENCE_CONV["bt_times"]
    conv = B.convergence_test(gathers64, *args, top, reps, np.random.default_rng(1), bcfg, dcfg)
    torch.cuda.synchronize()
    conv_wall = time.perf_counter() - t0
    # the CPU at three sizes, the index matrices replayed from the same stream
    rng = np.random.default_rng(1)
    conv_cpu = {}
    for size in range(1, top + 1):
        sel = B.sample_indices(n, size, reps, rng)
        if size in SCIENCE_CONV_AT:
            sel = np.concatenate([sel, np.broadcast_to(sel[:, :1], (reps, top - size))], axis=1)
            rid, _ = B.bootstrap_disp(gathers_cpu, *args, sel, bcfg, dcfg,
                                      counts=np.full(reps, size))
            conv_cpu[size] = [float(np.sum(np.std(r, axis=0))) for r in rid]
    conv_gap = max(abs(conv[m, s - 1] - conv_cpu[s][m]) / max(abs(conv_cpu[s][m]), 1e-12)
                   for s in SCIENCE_CONV_AT for m in range(conv.shape[0]))
    log(f"convergence sweep ({top} sizes x {reps} repetitions = {top * reps} stacks and images) "
        f"on the card: "
        f"{conv_wall:.2f} s ({nvidia_smi}); at sizes {SCIENCE_CONV_AT} card vs CPU float64 "
        f"rel {conv_gap:.3e}; spread at 60: {conv[:, -1].round(3).tolist()} m/s")
    if not (np.isfinite(conv).all() and conv_gap <= 1e-9):
        raise AssertionError(f"convergence curve differs from the CPU's by {conv_gap:.3e}")
    return {"image_peak_rel_err": image_err, "raw_picks": picks, "enhance_equal": True,
            "smoothed_ridge_gap_m_s": smooth_gap, "f32_picks": f32,
            "bootstrap_wall_s": walls, "convergence_wall_s": conv_wall,
            "convergence_rel_err": conv_gap, "gathers_f32_vs_f64": gather_gap,
            "convergence_spread_at": {str(s): conv[:, s - 1].tolist() for s in SCIENCE_CONV_AT}}


def _science_truth(nvidia_smi: str) -> dict:
    """(b): tests/test_full_stack.py's scene and budget on the card."""
    from das_diff_veh_tpu_torch.analysis.bootstrap import bootstrap_disp, sample_indices
    from das_diff_veh_tpu_torch.config import BootstrapConfig, ImagingConfig, PipelineConfig
    from das_diff_veh_tpu_torch.inversion import (LayerBounds, LayeredModel, ModelSpec,
                                                  curves_from_ridges, density_gardner_linear,
                                                  invert, phase_velocity, vp_from_poisson)
    from das_diff_veh_tpu_torch.io.synthetic import SceneConfig, synthesize_section
    from das_diff_veh_tpu_torch.models import vsg as V
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    t0 = time.perf_counter()
    vs = torch.tensor([0.24, 0.55], dtype=torch.float64, device="cuda")
    vp = vp_from_poisson(vs, 0.4375)
    truth = LayeredModel(torch.tensor([0.018, 0.05], dtype=torch.float64, device="cuda"), vp,
                         vs, density_gardner_linear(vp))
    f_grid = np.linspace(0.5, 30.0, 400)
    c_grid = phase_velocity(1.0 / f_grid, truth, mode=0, n_grid=800).cpu().numpy() * 1000.0
    if not np.isfinite(c_grid).all():
        raise AssertionError("the truth model's fundamental mode is missing somewhere")

    def c_of_f(freqs):
        return np.interp(np.clip(np.asarray(freqs, float), f_grid[0], f_grid[-1]), f_grid, c_grid)

    section, _ = synthesize_section(SceneConfig(nch=100, duration=300.0, n_vehicles=8, seed=3,
                                                speed_range=(10.0, 20.0), noise_std=0.005,
                                                phase_velocity=c_of_f))
    cfg = PipelineConfig().replace(imaging=ImagingConfig(x0=400.0))
    res = process_chunk(section.to(dtype=torch.float32), cfg, method="xcorr", device="cuda")
    dt = float(section.t[1] - section.t[0])
    x = res.batch.x.cpu().numpy()
    g = V.VsgGeometry.build(x, dt, cfg.imaging.x0, cfg.imaging.x0 + cfg.imaging.disp_start_x,
                            cfg.imaging.x0 + cfg.gather.far_offset, cfg.gather)
    gathers = V.build_gather_batch(res.batch, g, cfg.gather)[res.batch.valid]
    n = int(gathers.shape[0])
    bcfg = BootstrapConfig(bt_times=8, bt_size=n - 3, sigma=(35.0,), ref_freq_idx=(87,),
                           freq_lb=(3.5,), freq_ub=(10.0,))
    idx = sample_indices(n, n - 3, 8, np.random.default_rng(0))
    ridges, freqs = bootstrap_disp(gathers, g.offsets(x), dt, cfg.interrogator.dx, idx, bcfg,
                                   cfg.dispersion, disp_start_x=cfg.imaging.disp_start_x,
                                   disp_end_x=cfg.imaging.disp_end_x)
    band = (freqs >= 3.5) & (freqs < 10.0)
    spread = float(ridges[0].std(axis=0).max())
    med_err = float(np.median(np.abs(ridges[0].mean(axis=0) - c_of_f(freqs[band]))
                              / c_of_f(freqs[band])))
    c = curves_from_ridges(freqs, [3.5], [10.0], [ridges[0]], band_modes=[0])[0]
    cur = c._replace(period=c.period[::3], velocity=c.velocity[::3],
                     uncertainty=np.maximum(c.uncertainty[::3], 1.5e-2))
    spec = ModelSpec(layers=(LayerBounds((0.006, 0.035), (0.15, 0.45)),
                             LayerBounds((0.02, 0.08), (0.35, 0.9))))
    r = invert(spec, [cur], popsize=20, maxiter=60, n_refine_starts=6, n_refine_steps=50,
               n_grid=200, seed=0, device="cuda")
    vs_rec = r.model.vs.cpu().numpy()
    th_rec = float(r.model.thickness[0])
    pred = phase_velocity(cur.period, r.model, mode=0, n_grid=200).cpu().numpy()
    closure = float(np.median(np.abs(pred - cur.velocity) / cur.velocity))
    wall = time.perf_counter() - t0
    out = {"n_windows": int(res.n_windows), "ridge_spread_max_m_s": spread,
           "ridge_median_rel_err": med_err, "vs_km_s": vs_rec.tolist(),
           "vs_rel_err": (np.abs(vs_rec - [0.24, 0.55]) / [0.24, 0.55]).tolist(),
           "thickness_km": th_rec, "misfit": float(r.misfit), "closure_median_rel_err": closure,
           "wall_s": wall}
    log(f"truth scene on the card ({nvidia_smi}): {out}")
    checks = [out["n_windows"] >= 5, spread > 0.0, med_err < 0.08,
              out["vs_rel_err"][0] < 0.10, out["vs_rel_err"][1] < 0.20,
              abs(th_rec - 0.018) / 0.018 < 0.40, out["misfit"] < 1.5,
              np.isfinite(pred).all(), closure < 0.05]
    if not all(checks):
        raise AssertionError(f"truth scene: a check of tests/test_full_stack.py failed: {checks}")
    return out


def _science_curves(model, freqs, bcfg, noise_seed=None):
    """700_mid_speed's curves predicted by ``model``: BootstrapConfig bands 0,
    2 and 3 as modes 0, 3 and 4 (weights 2, 1, 1) at 0.1 Hz steps, 2 %
    uncertainty, points below cutoff dropped; with ``noise_seed``, one
    draw of Gaussian noise at the uncertainty."""
    from das_diff_veh_tpu_torch.inversion import Curve, phase_velocity

    rng = None if noise_seed is None else np.random.default_rng(noise_seed)
    curves = []
    for band, mode, weight in SCIENCE_BANDS:
        sel = (freqs >= bcfg.freq_lb[band]) & (freqs < bcfg.freq_ub[band])
        periods = (1.0 / freqs[sel])[::-1].copy()
        vel = phase_velocity(periods, model, mode=mode).cpu().numpy()
        keep = np.isfinite(vel)
        v, unc = vel[keep], 0.02 * vel[keep]
        if rng is not None:
            v = v + rng.normal(0.0, unc)
        curves.append(Curve(periods[keep], v, mode, weight, unc))
    return curves


def _science_search(nvidia_smi: str) -> tuple:
    """(c): the full-width search against its CPU float64 misfit."""
    import importlib

    from das_diff_veh_tpu_torch.config import BootstrapConfig, DispersionConfig
    from das_diff_veh_tpu_torch.inversion import (invert_multirun, make_misfit_fn,
                                                  speed_model_spec)

    I = importlib.import_module("das_diff_veh_tpu_torch.inversion.invert")
    parity = json.loads((REPO / "INVERSION_PARITY.json").read_text())["700_mid_speed"]
    spec = speed_model_spec()
    x_ref = torch.tensor(parity["x_best"], dtype=torch.float64, device="cuda")
    model = spec.to_model(x_ref)
    curves = _science_curves(model, DispersionConfig().freqs(), BootstrapConfig())
    n_pts = sum(len(c.period) for c in curves)
    kw = {k: v for k, v in SCIENCE_SEARCH.items()}
    out = {"points": n_pts, "points_per_curve": [len(c.period) for c in curves]}
    results = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = invert_multirun(spec, curves, dtype=dtype, device="cuda", **kw)
        torch.cuda.synchronize()
        hist = res.history.double().cpu().numpy()
        results[name] = res
        out[name] = {"wall_s": time.perf_counter() - t0, "misfit": float(res.misfit),
                     "device_memory_peak_bytes": torch.cuda.max_memory_allocated(),
                     "history_first_last": [float(hist[0]), float(hist[-1])],
                     "history_non_increasing": bool((np.diff(hist) <= 0).all())}
        if not out[name]["history_non_increasing"]:
            raise AssertionError(f"{name} search: the gbest history rose")
    x_best = results["f64"].x_best
    f_card = make_misfit_fn(spec, curves, n_grid=400, n_subdiv=1, invalid="truncate")
    m_card = float(f_card(x_best))
    m_cpu = float(f_card(x_best.cpu()))
    m_f32 = float(make_misfit_fn(spec, curves, n_grid=400, n_subdiv=1, dtype=torch.float32,
                                 invalid="truncate")(x_best.float()))
    rel = abs(m_card - m_cpu) / abs(m_cpu)
    out["misfit_at_x_best"] = {"card_f64": m_card, "cpu_f64": m_cpu, "card_f32": m_f32,
                               "rel_card_vs_cpu": rel}
    if not rel <= SCIENCE_MISFIT_TOL:
        raise AssertionError(f"misfit at x_best: card {m_card!r} vs CPU {m_cpu!r} ({rel:.3e})")
    warm = invert_multirun(spec, curves, device="cuda", x0=x_best[None],
                           **{**kw, "maxiter": 2, "n_refine_steps": 2, "seed": 7})
    out["warm_start_misfit"] = float(warm.misfit)
    if not float(warm.misfit) <= m_card:
        raise AssertionError(f"warm start from x_best ended at {float(warm.misfit)!r} > {m_card!r}")

    # one PSO iteration and one refine step at this width, timed and profiled
    fn = I._as_data_misfit(f_card)
    gens = I._run_generators(np.arange(kw["n_runs"]), "cuda")
    lead, shape = (kw["n_runs"],), (kw["popsize"], spec.n_params)
    draw = lambda s: I._draw(gens, lead, s, torch.float64, "cuda")
    state = I.pso_init(fn, draw(shape), draw(shape))
    step = lambda st: I.pso_step(fn, st, draw((2,) + shape))[0]
    state = step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        state = step(state)
    torch.cuda.synchronize()
    out["s_per_pso_iteration"] = (time.perf_counter() - t0) / 3
    holder = {"state": state}
    prof = profile_call("one PSO iteration (3 runs x 50, 400-point grid, float64)",
                        lambda: holder.update(state=step(holder["state"])))
    out["pso_iteration_profile"] = {"wall_ms": prof["wall_ms"],
                                    "device_busy_share": prof["device_busy_ms"] / prof["wall_ms"],
                                    "kernels_and_copies": prof["device_ops"],
                                    "top": prof["top"][:8]}
    starts = I._pool_starts(holder["state"], kw["n_refine_starts"])
    z = torch.logit(torch.clamp(starts, 1e-4, 1 - 1e-4))
    ast = I.adam_init(z)
    z, ast, _ = I.refine_step(fn, z, ast)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        z, ast, _ = I.refine_step(fn, z, ast)
    torch.cuda.synchronize()
    out["s_per_refine_step"] = (time.perf_counter() - t0) / 3
    out["refine_starts"] = int(starts.shape[0])
    log(f"full-width search ({nvidia_smi}): {out}")
    return out, spec, curves, x_ref


def _science_fleet(spec, curves, x_ref, nvidia_smi: str) -> dict:
    """(d): a fleet of 8 noisy copies of (c)'s curves on one slot and on 4
    slots of the card, then the monitor against two epochs of 8 new noise
    draws each: one of the same model, one whose top layer is 20 % faster."""
    from das_diff_veh_tpu_torch.config import BootstrapConfig, DispersionConfig
    from das_diff_veh_tpu_torch.inversion import (Curve, LayeredModel, density_gardner_linear,
                                                  invert_fleet, vp_from_poisson)
    from das_diff_veh_tpu_torch.obs.flight import FlightRecorder
    from das_diff_veh_tpu_torch.obs.registry import MetricsRegistry
    from das_diff_veh_tpu_torch.parallel import make_mesh
    from das_diff_veh_tpu_torch.pipeline.timelapse import FleetVsMonitor

    rng = np.random.default_rng(11)
    sets = [[Curve(c.period, c.velocity + rng.normal(0.0, c.uncertainty), c.mode, c.weight,
                   c.uncertainty) for c in curves] for _ in range(SCIENCE_TARGETS)]
    out = {}
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    for name, mesh in (("one_slot", None), ("mesh4", make_mesh(4, device="cuda"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name] = invert_fleet(spec, sets, mesh=mesh, device="cuda", **SCIENCE_FLEET)
        out[f"{name}_wall_s"] = time.perf_counter() - t0
    out["device_memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    a, b = runs["one_slot"], runs["mesh4"]
    gaps = {f: float(np.nanmax(np.abs(np.asarray(x, float) - np.asarray(y, float))))
            for f, x, y in zip(a._fields, a, b)}
    out["mesh_equal"] = all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))
    out["mesh_max_gap"] = max(gaps.values())
    if not out["mesh_equal"]:
        log(f"fleet on 4 slots vs one slot: largest gap {gaps} - the refinement's gradient "
            f"sums reduce in another order at another batch size")
        if not out["mesh_max_gap"] <= 1e-12:
            raise AssertionError(f"the fleet on 4 slots differs from one slot: {gaps}")
    if not (np.all(a.vs_lo <= a.vs) and np.all(a.vs <= a.vs_hi)):
        raise AssertionError("a target's credible interval misses its point estimate")
    # the monitor's epochs: new noise draws (seeds 100 + t) of the same
    # model, and of the model with its top layer 20 % faster
    m = spec.to_model(x_ref)
    vs2 = m.vs.clone()
    vs2[0] = 1.2 * vs2[0]
    vp2 = vp_from_poisson(vs2, 0.4375)
    freqs, bcfg = DispersionConfig().freqs(), BootstrapConfig()
    reg, flight = MetricsRegistry(), FlightRecorder(capacity=1024)
    mon = FleetVsMonitor(a, registry=reg, flight=flight)
    shift_total = reg.get("das_fleet_vs_shift_total")
    for name, model in (("unshifted", m),
                        ("shifted", LayeredModel(m.thickness, vp2, vs2,
                                                 density_gardner_linear(vp2)))):
        epoch_sets = [_science_curves(model, freqs, bcfg, noise_seed=100 + t)
                      for t in range(SCIENCE_TARGETS)]
        t0 = time.perf_counter()
        epoch = invert_fleet(spec, epoch_sets, device="cuda", **SCIENCE_FLEET)
        before = sum(child.value for _, child in shift_total.children())
        n_recs = len([r for r in flight.records() if r["kind"] == "vs_shift"])
        events = mon.observe(epoch)
        out[name] = {
            "wall_s": time.perf_counter() - t0,
            "top_vs_km_s": epoch.vs[:, 0].tolist(), "misfit": epoch.misfit.tolist(),
            "events": len(events),
            "events_by_layer": np.bincount([e.layer for e in events],
                                           minlength=spec.n_layers).tolist(),
            "layer0_targets": len({e.target for e in events if e.layer == 0}),
            "shift_total_added": sum(child.value for _, child in shift_total.children())
            - before,
            "vs_shift_records_added": len([r for r in flight.records()
                                           if r["kind"] == "vs_shift"]) - n_recs}
    out.update({"baseline_vs_km_s": a.vs.tolist(), "baseline_misfit": a.misfit.tolist(),
                "baseline_interval_width_km_s": (a.vs_hi - a.vs_lo).tolist(),
                "true_vs_km_s": m.vs.tolist(),
                "epochs_total": reg.get("das_fleet_vs_epochs_total").value,
                "monitor_bars": SCIENCE_MONITOR})
    log(f"fleet of {SCIENCE_TARGETS} ({nvidia_smi}): {out}")
    sh, un = out["shifted"], out["unshifted"]
    if (sh["layer0_targets"] < SCIENCE_MONITOR["shifted_layer0_min"]
            or un["layer0_targets"] >= sh["layer0_targets"] or un["events"] >= sh["events"]
            or sh["shift_total_added"] != sh["events"]
            or sh["vs_shift_records_added"] != sh["events"]
            or un["shift_total_added"] != un["events"]):
        raise AssertionError(f"monitor: shifted {sh}, unshifted {un}")
    return out


def _science_sensitivity(spec, x_ref) -> dict:
    """phase_sensitivity of (c)'s model at 3 periods, card against CPU."""
    from das_diff_veh_tpu_torch.inversion import phase_sensitivity

    model = spec.to_model(x_ref)
    cpu = spec.to_model(x_ref.cpu())
    gaps = []
    for period in (1 / 4.0, 1 / 8.0, 1 / 15.0):
        k_card = phase_sensitivity(model, period).kernel
        k_cpu = phase_sensitivity(cpu, period).kernel
        gaps.append(float(np.abs(k_card - k_cpu).max()))
    log(f"phase_sensitivity at 4, 8, 15 Hz, card vs CPU float64: max abs {gaps}")
    if not max(gaps) <= SCIENCE_SENS_TOL:
        raise AssertionError(f"sensitivity kernels differ by {gaps}")
    return {"max_abs_err": gaps}


def phase_science(nvidia_smi: str) -> dict:
    """Phase 17: the science path from the gathers to a Vs profile."""
    t0 = time.perf_counter()
    reset_counts()
    WATCH.phase = "17 science: bootstrap"
    boot = _science_bootstrap(nvidia_smi)
    WATCH.phase = "17 science: truth scene"
    truth = _science_truth(nvidia_smi)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"phase 17 launches: {launches}")
    if launches != SCIENCE_LAUNCHES:
        raise AssertionError(f"phase 17 launched {launches}, expected {SCIENCE_LAUNCHES}")
    torch.cuda.empty_cache()
    WATCH.phase = "17 science: full-width search"
    search, spec, curves, x_ref = _science_search(nvidia_smi)
    torch.cuda.empty_cache()
    WATCH.phase = "17 science: fleet"
    fleet = _science_fleet(spec, curves, x_ref, nvidia_smi)
    sens = _science_sensitivity(spec, x_ref)
    torch.cuda.empty_cache()
    out = {"device": nvidia_smi, "launches": launches, "bootstrap": boot, "truth": truth,
           "search": search, "reduced": SCIENCE_REDUCED, "fleet": fleet, "sensitivity": sens,
           "phase_s": time.perf_counter() - t0}
    log(f"science phase ({nvidia_smi}) took {out['phase_s']:.1f} s")
    return out


def _science_line(sc: dict) -> dict:
    """The ``science`` JSON line: phase 17's checks, walls and costs."""
    b, t, se, f = sc["bootstrap"], sc["truth"], sc["search"], sc["fleet"]
    return {"device": sc["device"], "phase_s": sc["phase_s"], "launches": sc["launches"],
            "bootstrap_image_peak_rel_err": b["image_peak_rel_err"],
            "raw_picks": b["raw_picks"], "f32_picks": b["f32_picks"],
            "bootstrap_wall_s": b["bootstrap_wall_s"],
            "convergence_wall_s": b["convergence_wall_s"],
            "convergence_rel_err": b["convergence_rel_err"],
            "truth": {k: t[k] for k in ("vs_km_s", "thickness_km", "misfit",
                                         "closure_median_rel_err", "wall_s")},
            "search": {k: se[k] for k in ("misfit_at_x_best", "warm_start_misfit",
                                           "s_per_pso_iteration", "s_per_refine_step")}
            | {d: {k: se[d][k] for k in ("wall_s", "misfit", "device_memory_peak_bytes")}
               for d in ("f64", "f32")}
            | {"pso_iteration_busy_share": se["pso_iteration_profile"]["device_busy_share"],
               "pso_iteration_kernels": se["pso_iteration_profile"]["kernels_and_copies"]},
            "reduced": sc["reduced"],
            "fleet": {k: f[k] for k in ("one_slot_wall_s", "mesh4_wall_s", "mesh_equal",
                                         "mesh_max_gap", "device_memory_peak_bytes")}
            | {e: {k: f[e][k] for k in ("wall_s", "events", "events_by_layer",
                                         "layer0_targets", "shift_total_added")}
               for e in ("unshifted", "shifted")},
            "sensitivity_max_abs_err": max(sc["sensitivity"]["max_abs_err"])}


# Phase 18: serving on the card.  The imaging engine at the chunk scene's
# geometry with two buckets (the 2-minute file and its half), with the
# admission health screen on, staged and fused.  Requests: phase 14's 8
# scenes (seeds 2-9) in float32; a truncated tail (140 x 22500, padded to
# the full bucket); seed 3's scene one hour into the recording (rebased onto
# the warmed time grid, so it captures nothing); a poison request over HTTP
# (NaN in 80 of 140 channels at the small bucket's geometry: 422); a
# 4-segment session; then closed-loop latency at 1 and 4 clients.  Beside
# them: the dot factory in both tiers, two replica slots of the card sharing
# the fused program, and the mesh engine with the config-4 ring.
SERVE_BUCKETS = ((140, 30000), (140, 15000))
SERVE_TAIL_NT = 22500
SERVE_SHIFT_S = 3600.0
SERVE_POISON = dict(nt=1000, channels=80, burst=slice(100, 600))
SERVE_SESSION = 4
SERVE_CLIENTS = (1, 4)
SERVE_LOOP_REQUESTS = 20           # closed loop, per concurrency level
# a staged request launches B1 twice; the warm-up runs each bucket once
# (staged: 2 launches a bucket) or captures it (fused: the warm-up call and
# the capture, 4 launches a bucket); a fused replay is counted by its
# program's launches_per_replay
SERVE_STAGED_REQUEST = {**NO_LAUNCHES, "traj_gather": 2}
SERVE_REPLAY = {"traj_gather": 2, "traj_dot": 0}
# the mesh engine: 10000-channel requests take the 4-slot ring (640 B3 and
# 3200 B4 launches each, phase 16's reckoning), 2048-channel ones a replica:
# ceil(2048/64) = 32 launches of B3 and 32 * ceil(2048/512) = 128 of B4
SERVE_RING_BUCKETS = ((10000, 4096), (2048, 4096))
SERVE_RING_MIN_CHANNELS = 8192
SERVE_REPLICAS = 2
SERVE_SMALL = dict(nch=2048, nt=4096, seed=5)
SERVE_REPLICA_LAUNCHES = {**NO_LAUNCHES, "cross_spectra": 32, "lag_absmax": 128}


def _serve_scene(seed: int):
    """The chunk scene of ``seed`` as host float32 data and float64 axes.
    Top level, so that a spawned worker can run it."""
    sys.path.insert(0, str(REPO))
    from das_diff_veh_tpu_torch.io.synthetic import SceneConfig, synthesize_section

    sec, _ = synthesize_section(SceneConfig(**{**SCENE, "seed": seed}))
    return sec.data.numpy().astype(np.float32), sec.x.numpy(), sec.t.numpy()


def _serve_scenes(section) -> list:
    """Phase 14's 8 scenes (seeds 2-9; the first is the main path's), the
    other 7 synthesized in spawned workers."""
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor

    rest = BATCH_SEEDS[1:]
    with ProcessPoolExecutor(max_workers=min(len(rest), os.cpu_count() or 1),
                             mp_context=mp.get_context("spawn")) as pool:
        futs = [pool.submit(_serve_scene, s) for s in rest]
        first = (section.data.numpy().astype(np.float32), section.x.numpy(),
                 section.t.numpy())
        return [first] + [f.result() for f in futs]


def _post(url: str, payload) -> tuple:
    """``(status, body)`` of a JSON POST (``payload`` a dict or encoded bytes)."""
    import urllib.error
    import urllib.request

    raw = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url, raw, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _closed_loop(process, scenes, clients: int, n: int) -> dict:
    """``n`` requests from ``clients`` threads, each sending its next request
    when its last one is answered; client-side latencies, p50 / p99 and
    requests per second over the whole loop."""
    import threading

    lat = []
    lock = threading.Lock()

    def client(k: int) -> None:
        for j in range(k, n, clients):
            d, _, t = scenes[j % len(scenes)]
            t0 = time.perf_counter()
            process(d, t)
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if len(lat) != n:
        raise AssertionError(f"closed loop at {clients} clients answered {len(lat)} of {n}")
    return {"clients": clients, "requests": n, "wall_s": wall, "req_per_s": n / wall,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "latency_ms": lat}


def _serve_imaging(pipeline: str, scenes: list, nvidia_smi: str) -> dict:
    """The imaging engine on ``pipeline``: every served image equal to a
    direct ``process_chunk`` on the card, the tail, the shifted segment, the
    poison request, the session, the counters; then latency and spans."""
    from das_diff_veh_tpu_torch.config import HealthConfig, PipelineConfig, ServeConfig
    from das_diff_veh_tpu_torch.convert import section_from_numpy
    from das_diff_veh_tpu_torch.core.section import DasSection
    from das_diff_veh_tpu_torch.obs import MetricsRegistry
    from das_diff_veh_tpu_torch.pipeline import fused as F
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk
    from das_diff_veh_tpu_torch.pipeline.workflow import pull_count_and_image
    from das_diff_veh_tpu_torch.resilience.health import quick_screen
    from das_diff_veh_tpu_torch.serve import (ImagingComputeFactory, ServingEngine,
                                              pad_section, serve_in_thread)

    cfg = PipelineConfig().replace(chunk_pipeline=pipeline)
    x = scenes[0][1]
    F.clear_programs()                  # so that the warm-up captures each bucket
    fs = 250.0
    hcfg = HealthConfig(enabled=True)
    reg = MetricsRegistry()
    eng = ServingEngine(ImagingComputeFactory(cfg, x_is_channels=False, x_axis=x, fs=fs,
                                              device="cuda"),
                        ServeConfig(buckets=SERVE_BUCKETS, default_deadline_ms=600000.0,
                                    health=hcfg), registry=reg)
    caps0, progs0 = F.n_captures(), F.n_programs()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eng.start()
    warm_s = time.perf_counter() - t0
    warm_caps, warm_progs = F.n_captures() - caps0, F.n_programs() - progs0
    server, _ = serve_in_thread(eng)
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/process"

    def serve(d, t, **kw):
        return eng.process(DasSection(d, x, t), timeout=600, **kw)

    out = {"warmup_s": warm_s, "warmup_captures": warm_caps, "warmup_programs": warm_progs}
    try:
        files = [serve(d, t) for d, _, t in scenes]
        tail = serve(scenes[0][0][:, :SERVE_TAIL_NT], scenes[0][2][:SERVE_TAIL_NT])
        caps1 = F.n_captures()
        shifted = serve(scenes[1][0], scenes[1][2] + SERVE_SHIFT_S)
        shift_caps = F.n_captures() - caps1
        session = [serve(d, t, session="fiber") for d, _, t in scenes[:SERVE_SESSION]]
        n_served = len(files) + 2 + len(session)
        # the poison request over HTTP: a 422 with its structured body
        pdata = scenes[2][0][:, :SERVE_POISON["nt"]].astype(np.float64)
        pdata[:SERVE_POISON["channels"], SERVE_POISON["burst"]] = np.nan
        code, pbody = _post(url, {"data": [[None if np.isnan(v) else v for v in row]
                                           for row in pdata.tolist()],
                                  "x": x.tolist(),
                                  "t": (np.arange(SERVE_POISON["nt"]) / fs).tolist()})
        if code != 422 or set(pbody) != {"error", "nan_fraction", "dead_channels"} \
                or pbody["dead_channels"] < SERVE_POISON["channels"]:
            raise AssertionError(f"poison request: {code} {pbody}")
        http = None
        if pipeline == "fused":
            # one full-size request over HTTP with the image inlined
            d, _, t = scenes[0]
            t0 = time.perf_counter()
            raw = json.dumps({"data": d.tolist(), "x": x.tolist(), "t": t.tolist()}).encode()
            enc_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            code, body = _post(url + "?image=1", raw)
            rt_s = time.perf_counter() - t0
            t0 = time.perf_counter()            # the handler's own decode, again here
            np.asarray(json.loads(raw)["data"], dtype=np.float32)
            dec_s = time.perf_counter() - t0
            n_served += 1
            got = np.asarray(body["result"]["image"], dtype=np.float32) if code == 200 else None
            http = {"status": code, "payload_bytes": len(raw), "encode_ms": enc_s * 1e3,
                    "round_trip_ms": rt_s * 1e3, "decode_ms": dec_s * 1e3,
                    "image_equal": bool(got is not None and np.array_equal(got, files[0].image))}
            log(f"serve {pipeline}: one full-size request over HTTP ({len(raw)} B of JSON): "
                f"client encode {enc_s * 1e3:.1f} ms, round trip {rt_s * 1e3:.1f} ms, "
                f"decode (json + numpy) {dec_s * 1e3:.1f} ms, status {code}, image equal "
                f"{http['image_equal']}")
            if not (code == 200 and http["image_equal"]):
                raise AssertionError(f"the full-size HTTP request: {code}, {http}")
        torch.cuda.synchronize()
        counts = read_counts()
        snap = eng.metrics()
        steady = reg.get("das_serve_steady_state_compiles").value
        builds = {k: int(v.value) for (k,), v in reg.get("das_build_events_total").children()}

        # the same requests straight through process_chunk on the card
        def direct(d, t):
            res = process_chunk(section_from_numpy(d, x, t, device="cuda"), cfg, device="cuda")
            return pull_count_and_image(res.n_windows, res.disp_image)

        equal = []
        for (d, _, t), r in zip(scenes, files):
            n, img = direct(d, t)
            equal.append(n == r.n_windows and np.array_equal(img, r.image))
        padded = pad_section(DasSection(scenes[0][0][:, :SERVE_TAIL_NT], x,
                                        scenes[0][2][:SERVE_TAIL_NT]), SERVE_BUCKETS[0])
        n, img = direct(np.asarray(padded.data), np.arange(SERVE_BUCKETS[0][1]) * (1.0 / fs))
        tail_ok = (tail.padded and tail.bucket == SERVE_BUCKETS[0] and n == tail.n_windows
                   and np.array_equal(img, tail.image))
        shift_ok = (shifted.t0 == SERVE_SHIFT_S and shifted.n_windows == files[1].n_windows
                    and np.array_equal(shifted.image, files[1].image) and shift_caps == 0)
        state = eng.session_state("fiber")
        acc = None
        for r in session:
            if r.n_windows > 0:
                acc = r.image if acc is None else acc + r.image
        session_ok = (state["n_segments"] == SERVE_SESSION
                      and state["n_windows"] == sum(r.n_windows for r in session)
                      and np.array_equal(state["avg_image"], acc)
                      and all(np.array_equal(r.image, f.image)
                              for r, f in zip(session, files)))
        if pipeline == "staged":
            want = {k: v * (n_served + len(SERVE_BUCKETS))
                    for k, v in SERVE_STAGED_REQUEST.items()}
        else:
            want = {**NO_LAUNCHES, "traj_gather": 4 * len(SERVE_BUCKETS)}
        out.update(n_windows=[r.n_windows for r in files], equal_direct=equal, tail=tail_ok,
                   shifted=shift_ok, shift_captures=shift_caps, session=session_ok,
                   poison=pbody,
                   http=http, launches=counts, launches_reckoned=want,
                   cache_misses=snap["cache_misses"], steady_state_compiles=steady,
                   build_events=builds)
        log(f"serve {pipeline} ({nvidia_smi}): warm-up {warm_s:.2f} s ({warm_caps} captures, "
            f"{warm_progs} fused programs); {n_served} requests served, n_windows "
            f"{out['n_windows']}; equal to direct process_chunk {equal}; tail padded and equal "
            f"{tail_ok}; shifted segment equal, {shift_caps} captures: {shift_ok}; session "
            f"{session_ok}; poison 422 {pbody}; launches {counts} (reckoned {want}); "
            f"cache_misses {snap['cache_misses']}, steady-state compiles {steady}; build "
            f"events {builds}")
        if not (all(equal) and tail_ok and shift_ok and session_ok):
            raise AssertionError(f"serve {pipeline}: a served result differs: {out}")
        if counts != want:
            raise AssertionError(f"serve {pipeline}: launches {counts}, reckoned {want}")
        if snap["cache_misses"] != 0 or steady != 0:
            raise AssertionError(f"serve {pipeline}: {snap['cache_misses']} cache misses, "
                                 f"{steady} steady-state builds")
        if pipeline == "fused":
            progs = F.programs()[-warm_progs:] if warm_progs else []
            replay = [p.launches_per_replay for p in progs]
            if warm_caps != len(SERVE_BUCKETS) or replay != [SERVE_REPLAY] * len(SERVE_BUCKETS):
                raise AssertionError(f"fused warm-up: {warm_caps} captures, replays {replay}")
            out["launches_per_replay"] = replay

        # closed-loop latency, the spans, the card's busy share over a request
        screen_ms = []
        for d, _, _ in scenes[:3]:
            t0 = time.perf_counter()
            quick_screen(d, hcfg)
            screen_ms.append((time.perf_counter() - t0) * 1e3)
        loops = {c: _closed_loop(serve, scenes, c, SERVE_LOOP_REQUESTS) for c in SERVE_CLIENTS}
        stages = {k: {q: v[q] for q in ("p50", "mean")}
                  for k, v in eng.metrics()["stages_ms"].items()}
        prof = profile_call(f"one warm {pipeline} request",
                            lambda: serve(scenes[0][0], scenes[0][2]))
        # the profiler slows the host (its profiled wall is ~2x the loop's),
        # so the device time is also put against the unprofiled p50 request
        busy = prof["device_busy_ms"] / prof["wall_ms"]
        busy_p50 = prof["device_busy_ms"] / loops[1]["p50_ms"]
        snap = eng.metrics()
        steady = reg.get("das_serve_steady_state_compiles").value
        log(f"serve {pipeline} latency ({nvidia_smi}; closed loop, {SERVE_LOOP_REQUESTS} "
            f"requests a level): " + "; ".join(
                f"{c} client(s) {v['req_per_s']:.3f} req/s, p50 {v['p50_ms']:.1f} ms, p99 "
                f"{v['p99_ms']:.1f} ms" for c, v in loops.items())
            + f"; spans p50/mean ms {stages}; admission screen {np.median(screen_ms):.1f} ms "
            f"a request; card busy {100 * busy:.1f} % of a profiled warm request, its "
            f"device time {100 * busy_p50:.1f} % of the 1-client p50; cache_misses "
            f"{snap['cache_misses']}, steady-state compiles {steady}")
        if snap["cache_misses"] != 0 or steady != 0:
            raise AssertionError(f"serve {pipeline}: builds under load")
        out.update(loops={c: {k: v for k, v in r.items() if k != "latency_ms"}
                          for c, r in loops.items()},
                   latency_ms={c: r["latency_ms"] for c, r in loops.items()},
                   stages_ms=stages, admission_screen_ms=float(np.median(screen_ms)),
                   busy_share=busy, busy_share_of_p50=busy_p50, profiled_request=prof)
        return out
    finally:
        server.shutdown()
        server.server_close()
        eng.close()


def _serve_threads(scenes: list) -> dict:
    """The dispatcher thread's current device and stream are the warm-up's;
    replica slots of the card share the fused program (no new capture) and
    queue on its lock: a burst through 2 slots against 1, in turns."""
    from das_diff_veh_tpu_torch.config import MeshServeConfig, PipelineConfig, ServeConfig
    from das_diff_veh_tpu_torch.core.section import DasSection
    from das_diff_veh_tpu_torch.pipeline import fused as F
    from das_diff_veh_tpu_torch.serve import (ComputeFactory, ImagingComputeFactory,
                                              ServingEngine)
    from das_diff_veh_tpu_torch.serve.mesh import MeshServingEngine

    import threading

    class Probe(ComputeFactory):
        """A stub on the card recording each call's thread, current CUDA
        device and current stream."""

        config_key = "device-probe"
        device = torch.device("cuda", torch.cuda.current_device())
        seen = []

        def build(self, bucket):
            def fn(section, valid, state):
                self.seen.append((threading.current_thread().name,
                                  torch.cuda.current_device(),
                                  torch.cuda.current_stream().cuda_stream))
                return None, state
            return fn

    probe = Probe()
    eng = ServingEngine(probe, ServeConfig(buckets=((4, 8),))).start()
    try:
        eng.process(DasSection(np.ones((4, 8), np.float32), np.arange(4.0), np.arange(8.0)),
                    timeout=60)
    finally:
        eng.close()
    (warm_thread, *warm), (disp_thread, *disp) = probe.seen
    same = warm == disp and warm_thread != disp_thread
    x = scenes[0][1]
    cfg = PipelineConfig().replace(chunk_pipeline="fused")
    caps0 = F.n_captures()
    # the same burst of 8 requests (no admission screen) through 1 and 2
    # replica slots of the card, in turns
    engines = {n: MeshServingEngine(
        ImagingComputeFactory(cfg, x_is_channels=False, x_axis=x, device="cuda"),
        MeshServeConfig(serve=ServeConfig(buckets=(SERVE_BUCKETS[0],),
                                          default_deadline_ms=600000.0),
                        replicas=n), device="cuda:0").start() for n in (1, SERVE_REPLICAS)}
    walls = {n: [] for n in engines}
    try:
        for _ in range(2):
            for n, eng in engines.items():
                t0 = time.perf_counter()
                futs = [eng.submit(DasSection(d, x, t)) for d, _, t in scenes]
                res = [f.result(timeout=600) for f in futs]
                walls[n].append(time.perf_counter() - t0)
        devices = [str(r.device) for r in engines[SERVE_REPLICAS]._replicas]
        snap = engines[SERVE_REPLICAS].metrics()
        misses = [e.metrics()["cache_misses"] for e in engines.values()]
    finally:
        for eng in engines.values():
            eng.close()
    caps = F.n_captures() - caps0
    med = {n: float(np.median(v)) for n, v in walls.items()}
    per_rep = {k: v["requests"] for k, v in snap["replicas"].items()}
    log(f"serve threads: warm-up on {warm_thread!r} and dispatch on {disp_thread!r} see "
        f"(device, stream) {warm} / {disp}: same {same}; replica slots on {devices} share "
        f"the fused program ({caps} new captures); a burst of {len(scenes)} requests in turns "
        f"(s): {walls}, medians 1 slot {med[1]:.3f}, {SERVE_REPLICAS} slots "
        f"{med[SERVE_REPLICAS]:.3f} (requests per replica {per_rep}; the slots queue on the "
        f"program's lock)")
    if not same or caps != 0 or any(misses):
        raise AssertionError(f"serve threads: same {same}, captures {caps}, misses {misses}")
    return {"dispatcher_matches_warmup": same, "probe": probe.seen, "replica_devices": devices,
            "shared_program_captures": caps, "burst_wall_s": walls,
            "burst_wall_s_median": med, "requests_per_replica": per_rep,
            "n_windows": [r.n_windows for r in res]}


def _serve_dot(scenes: list) -> dict:
    """The dot factory (B2) in both tiers: 2 launches a request, the image
    equal to a direct ``process_chunk`` on the card."""
    from das_diff_veh_tpu_torch.config import ServeConfig
    from das_diff_veh_tpu_torch.convert import section_from_numpy
    from das_diff_veh_tpu_torch.core.section import DasSection
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk
    from das_diff_veh_tpu_torch.serve import ImagingComputeFactory, ServingEngine

    d, x, t = scenes[0]
    out = {}
    for precision in ("f32", "bf16"):
        cfg = _dot_cfg(precision)
        eng = ServingEngine(ImagingComputeFactory(cfg, x_is_channels=False, x_axis=x,
                                                  device="cuda"),
                            ServeConfig(buckets=(SERVE_BUCKETS[0],))).start()
        try:
            torch.cuda.synchronize()
            reset_counts()
            r = eng.process(DasSection(d, x, t), timeout=600)
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            eng.close()
        ref = process_chunk(section_from_numpy(d, x, t, device="cuda"), cfg, device="cuda")
        equal = r.n_windows == ref.n_windows and np.array_equal(r.image,
                                                                ref.disp_image.cpu().numpy())
        out[precision] = {"launches": counts, "equal_direct": equal, "n_windows": r.n_windows}
        if counts != DOT_LAUNCHES or not equal:
            raise AssertionError(f"serve dot {precision}: launches {counts}, equal {equal}")
    log(f"serve dot factory (B2): {out}")
    return out


def _serve_mesh(nvidia_smi: str) -> dict:
    """The mesh engine with the all-pairs factory: config-4 requests on the
    4-slot ring, 2048-channel ones on replicas, against the single-device
    engine and the direct call; walls and memory peaks in turns."""
    from das_diff_veh_tpu_torch.config import MeshServeConfig, ServeConfig
    from das_diff_veh_tpu_torch.core.section import DasSection
    from das_diff_veh_tpu_torch.ops.all_pairs import xcorr_all_pairs_peak
    from das_diff_veh_tpu_torch.parallel import make_mesh
    from das_diff_veh_tpu_torch.serve import ServingEngine
    from das_diff_veh_tpu_torch.serve.mesh import AllPairsComputeFactory, MeshServingEngine
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    wlen = ALLPAIRS["wlen"]
    big = make_ambient_record(ALLPAIRS["nch"], ALLPAIRS["nt"], seed=ALLPAIRS["seed"],
                              device="cpu").numpy()
    small = make_ambient_record(SERVE_SMALL["nch"], SERVE_SMALL["nt"],
                                seed=SERVE_SMALL["seed"], device="cpu").numpy()

    def sec(a):
        return DasSection(a, np.arange(a.shape[0], dtype=np.float64),
                          np.arange(a.shape[1], dtype=np.float64) / 1000.0)

    deadline = ServeConfig(default_deadline_ms=600000.0)
    single = ServingEngine(AllPairsComputeFactory(wlen, device="cuda"), dataclasses.replace(
        deadline, buckets=(SERVE_RING_BUCKETS[0],))).start()
    meng = MeshServingEngine(
        AllPairsComputeFactory(wlen, mesh=make_mesh(MESH_SLOTS, device="cuda"), device="cuda"),
        MeshServeConfig(serve=dataclasses.replace(deadline, buckets=SERVE_RING_BUCKETS),
                        replicas=SERVE_REPLICAS, ring_min_channels=SERVE_RING_MIN_CHANNELS),
        device="cuda")
    try:
        t0 = time.perf_counter()
        meng.start()
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        reset_counts()
        rings = [f.result(timeout=600) for f in [meng.submit(sec(big)) for _ in range(2)]]
        torch.cuda.synchronize()
        ring_counts = read_counts()
        reset_counts()
        reps = [f.result(timeout=600) for f in [meng.submit(sec(small)) for _ in range(2)]]
        torch.cuda.synchronize()
        rep_counts = read_counts()
        ref = single.process(sec(big), timeout=600)
        want_big = xcorr_all_pairs_peak(big, wlen).cpu().numpy()
        want_small = xcorr_all_pairs_peak(small, wlen).cpu().numpy()
        equal = {"ring_vs_single_engine": all(np.array_equal(r.peaks, ref.peaks) for r in rings),
                 "ring_vs_direct": all(np.array_equal(r.peaks, want_big) for r in rings),
                 "replicas_vs_direct": all(np.array_equal(r.peaks, want_small) for r in reps)}
        placements = [r.placement for r in rings + reps]
        # walls and memory peaks in turns: the direct call (the record copied
        # in, the peaks left on the card), the single-device engine and the
        # ring engine (the record in, the peaks out to the host)
        calls = {"direct": lambda: xcorr_all_pairs_peak(big, wlen),
                 "single_engine": lambda: single.process(sec(big), timeout=600),
                 "ring_engine": lambda: meng.process(sec(big), timeout=600)}
        walls = {k: [] for k in calls}
        peaks = {k: 0 for k in calls}
        for _ in range(2):
            for label, fn in calls.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[label].append((time.perf_counter() - t0) * 1e3)
                peaks[label] = max(peaks[label], torch.cuda.max_memory_allocated())
        snap, ssnap = meng.metrics(), single.metrics()
        steady = [e.registry.get("das_serve_steady_state_compiles").value
                  for e in (meng, single)]
    finally:
        meng.close()
        single.close()
    want_ring = {k: 2 * v for k, v in MESH_LAUNCHES.items()}
    want_rep = {k: 2 * v for k, v in SERVE_REPLICA_LAUNCHES.items()}
    log(f"serve mesh ({nvidia_smi}): warm-up {warm_s:.2f} s ({snap['warmup_builds']} builds); "
        f"2 ring requests launched {ring_counts} (reckoned {want_ring}), 2 replica requests "
        f"{rep_counts} (reckoned {want_rep}); placements {placements}, {snap['placements']}; "
        f"equal {equal}; walls ms in turns {walls}; device memory peaks {peaks} B; "
        f"cache_misses {snap['cache_misses']} / {ssnap['cache_misses']}, steady-state "
        f"compiles {steady}")
    if ring_counts != want_ring or rep_counts != want_rep:
        raise AssertionError(f"serve mesh launches {ring_counts} / {rep_counts}")
    if not all(equal.values()) or placements != ["ring"] * 2 + ["single"] * 2:
        raise AssertionError(f"serve mesh: equal {equal}, placements {placements}")
    if snap["cache_misses"] or ssnap["cache_misses"] or any(steady):
        raise AssertionError("serve mesh: builds after warm-up")
    return {"warmup_s": warm_s, "launches_ring": ring_counts, "launches_replicas": rep_counts,
            "placements": snap["placements"], "equal": equal, "wall_ms": walls,
            "wall_ms_median": {k: float(np.median(v)) for k, v in walls.items()},
            "device_memory_peak_bytes": peaks}


def phase_serve(section, nvidia_smi: str) -> dict:
    """Phase 18: the serving front on the card."""
    t0 = time.perf_counter()
    scenes = _serve_scenes(section)
    log(f"serve scenes: {len(scenes)} of {scenes[0][0].shape} float32 in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {"device": nvidia_smi}
    for pipeline in ("staged", "fused"):
        WATCH.phase = f"18 serve: imaging {pipeline}"
        out[pipeline] = _serve_imaging(pipeline, scenes, nvidia_smi)
    WATCH.phase = "18 serve: threads and shared card"
    out["threads"] = _serve_threads(scenes)
    WATCH.phase = "18 serve: dot"
    out["dot"] = _serve_dot(scenes)
    del scenes
    torch.cuda.empty_cache()
    WATCH.phase = "18 serve: mesh"
    out["mesh"] = _serve_mesh(nvidia_smi)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"serve phase ({nvidia_smi}) took {out['phase_s']:.1f} s")
    return out


def _serve_line(sv: dict) -> dict:
    """The ``serve`` JSON line: phase 18's checks, latencies and walls."""
    line = {"device": sv["device"], "phase_s": sv["phase_s"]}
    for p in ("staged", "fused"):
        r = sv[p]
        line[p] = {"equal_direct": all(r["equal_direct"]), "launches": r["launches"],
                   "cache_misses": r["cache_misses"],
                   "steady_state_compiles": r["steady_state_compiles"],
                   "busy_share": r["busy_share"], "busy_share_of_p50": r["busy_share_of_p50"],
                   "stages_ms": r["stages_ms"],
                   "admission_screen_ms": r["admission_screen_ms"],
                   **{f"clients_{c}": {k: r["loops"][c][k]
                                       for k in ("req_per_s", "p50_ms", "p99_ms")}
                      for c in SERVE_CLIENTS}}
    line["http_decode_ms"] = sv["fused"]["http"]["decode_ms"]
    line["shared_card"] = {k: sv["threads"][k] for k in (
        "dispatcher_matches_warmup", "shared_program_captures", "burst_wall_s_median")}
    line["dot"] = {k: v["launches"]["traj_dot"] for k, v in sv["dot"].items()}
    m = sv["mesh"]
    line["mesh"] = {k: m[k] for k in ("launches_ring", "launches_replicas", "equal",
                                      "wall_ms_median", "device_memory_peak_bytes")}
    return line


# Phase 19: the ops layers on the card.  (a) the figure set of the CLI's
# ``--figures`` at its defaults (16 windows, seed 0): its gathers launch B1
# twice; where matplotlib is absent the same port calls run without the
# plots.  (b) a profiler window over phase 14's folder, fused.  (c) the
# memory sampler around one config-4 call and around a serving engine's
# warm-up and 4 fused requests.  (d) the tuner: config 4 over the ring's
# window slab and lag-peak block, and the dot chunk scene over the chunk
# pipeline and the gather finish, each candidate timed between CUDA events
# after a warm call; then its winners through ``run_directory`` and a
# serving engine.
OPS_FIGURE_WINDOWS = 16
OPS_FIGURE_NAMES = ("waterfall.png", "waterfall_windows.png", "gather.png", "fv_map.png",
                    "fv_map_norm_part.png", "gather_psd_offset.png",
                    "gather_spectrum_offset.png")
OPS_FIGURE_LAUNCHES = {**NO_LAUNCHES, "traj_gather": 2}
OPS_PROFILE = dict(profile_start_chunk=3, profile_n_chunks=2)
OPS_SAMPLE_S = 0.01
OPS_SERVE_REQUESTS = 4
# the warm-up captures the bucket: B1 in the warm-up call and in the capture
OPS_SERVE_WARMUP_LAUNCHES = {**NO_LAUNCHES, "traj_gather": 4}
OPS_PHASE_BUDGET_S = 120.0
OPS_SWEEP_BUDGET_S = 60.0
OPS_TUNE_REPS = 2
OPS_ALLPAIRS_KNOBS = (("ring.win_block", (2, 4)), ("ring.lagmax_block", (256, 1024)))
OPS_CHUNK_KNOBS = (("chunk_pipeline", ("fused",)), ("gather.traj_gather_finish", ("dot",)))
# A knob that changes the order of a sum (the window slabs), cuFFT's C2R
# algorithm (the lag-peak block's batch shape) or the finish's algorithm
# (rfft or dot) keeps the result within its path's bar on the card: the
# all-pairs peaks' 1e-6, the float32 chunk's IMAGE_PEAK_REL_TOL.
OPS_ALLPAIRS_KNOB_TOL = 1e-6
OPS_CHUNK_KNOB_TOL = IMAGE_PEAK_REL_TOL


def _ops_figures() -> dict:
    """(a) The figure set on the card: the CLI's ``--figures`` where
    matplotlib is installed, else the figure set's port calls
    (``workloads.figure_set_arrays`` and what its two spectral plots
    compute); B1's 2 launches held to its plain version bit for bit on the
    inputs the figure set gave it; the stack and the image against a CPU
    float64 run."""
    import contextlib
    import importlib.util
    import io
    import os

    from das_diff_veh_tpu_torch.ops import traj_gather as tg
    from das_diff_veh_tpu_torch.ops.psd import welch_psd
    from das_diff_veh_tpu_torch.workloads import figure_set_arrays

    have_mpl = importlib.util.find_spec("matplotlib") is not None
    captured = []
    launch = tg.pack_windows_cuda

    def recording(*args):
        captured.append(args)
        return launch(*args)

    files = []
    out = {"matplotlib": have_mpl}
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="figures_") as out_dir:
        tg.pack_windows_cuda = recording
        try:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            if have_mpl:
                from das_diff_veh_tpu_torch.pipeline import cli

                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(["--figures", "--out_dir", out_dir])
                files = buf.getvalue().split()
                if rc != 0:
                    raise AssertionError(f"--figures exited {rc}")
                sizes = [os.path.getsize(f) for f in files]
            else:
                fs = figure_set_arrays(n_windows=OPS_FIGURE_WINDOWS, seed=0, device="cuda")
                nch_plot = min(fs.stack.shape[0], len(fs.offsets))
                welch_psd(fs.stack[:nch_plot], 1.0 / fs.geometry.dt, nperseg=256, nfft=1024)
                np.abs(np.fft.rfft(fs.stack[:nch_plot].cpu().numpy(), axis=-1))
                fs.image.cpu()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = read_counts()
        finally:
            tg.pack_windows_cuda = launch
    if have_mpl:
        names = tuple(os.path.basename(f) for f in files)
        log(f"figure set: --figures wrote {list(names)} ({sizes} bytes) in {wall_s:.3f} s")
        if names != OPS_FIGURE_NAMES or not all(sizes):
            raise AssertionError(f"--figures wrote {names}, expected {OPS_FIGURE_NAMES}")
        out["files"] = list(names)
    else:
        log("figure set: the plots were not drawn: matplotlib is absent on this machine; "
            f"the figure set's computation ran on the card in {wall_s:.3f} s")
    if counts != OPS_FIGURE_LAUNCHES:
        raise AssertionError(f"figure set launches {counts}, expected {OPS_FIGURE_LAUNCHES}")
    equal, err = [], 0.0
    for args in captured:
        k, p = tg.pack_windows_cuda(*args), tg.pack_windows_plain(*args)
        equal.append(bool(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])))
        err = max(err, float((k[0] - p[0]).abs().max()), float((k[1] - p[1]).abs().max()))
    card = figure_set_arrays(n_windows=OPS_FIGURE_WINDOWS, seed=0, device="cuda")
    t0 = time.perf_counter()
    cpu = figure_set_arrays(n_windows=OPS_FIGURE_WINDOWS, seed=0, dtype=np.float64,
                            device="cpu")
    cpu_s = time.perf_counter() - t0
    stack_err, img_err = peak_rel(card.stack, cpu.stack), peak_rel(card.image, cpu.image)
    log(f"figure set: launches {counts}; B1 vs plain on its {len(captured)} launches' inputs "
        f"equal {equal}; card vs CPU float64 ({cpu_s:.1f} s): stack peak-rel {stack_err:.3e}, "
        f"image peak-rel {img_err:.3e} (tol {IMAGE_PEAK_REL_TOL})")
    if len(equal) != 2 or not all(equal):
        raise AssertionError("figure set: B1 != its plain version on the figure set's inputs")
    if not (stack_err <= IMAGE_PEAK_REL_TOL and img_err <= IMAGE_PEAK_REL_TOL
            and bool(torch.isfinite(card.image).all())):
        raise AssertionError(f"figure set: card vs CPU float64 stack {stack_err:.3e}, "
                             f"image {img_err:.3e}")
    out.update({"launches": counts, "b1_equal_plain": equal, "max_abs_err": err,
                "stack_peak_rel": stack_err, "image_peak_rel": img_err, "wall_s": wall_s})
    return out


def _sum_counts(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in NO_LAUNCHES}


def _ops_dataset(root: str):
    from das_diff_veh_tpu_torch.io.readers import DirectoryDataset

    return DirectoryDataset(BATCH_DATE, root=root, ch1=None, ch2=None, smoothing=False,
                            rescale_after=None)


def _ops_profiler(root: str, serial_ref: np.ndarray) -> dict:
    """(b) Phase 14's folder through ``run_directory`` fused: a run that
    captures the chunk's graph, a run with a profiler window (chunks 4 and
    5) and one without: the window captured, its Chrome trace names B1 from
    the graph replays, the summed image equal to the run without it and to
    phase 14's serial loop; files/s of the last two (both replay only)."""
    import os

    from das_diff_veh_tpu_torch.config import HealthConfig, ObsConfig, PipelineConfig
    from das_diff_veh_tpu_torch.obs import ProfilerWindow, default_registry
    from das_diff_veh_tpu_torch.pipeline import fused as F
    from das_diff_veh_tpu_torch.pipeline import workflow as W
    from das_diff_veh_tpu_torch.runtime import RuntimeConfig

    cfg = PipelineConfig().replace(health=HealthConfig(enabled=True), chunk_pipeline="fused")
    n_files = len(BATCH_SEEDS)

    def run(obs):
        rt = RuntimeConfig(prefetch_depth=2, retry_backoff_s=0.0, obs=obs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = W.run_directory(_ops_dataset(root), cfg, x_is_channels=False, runtime=rt,
                              device="cuda")
        return res, n_files / (time.perf_counter() - t0)

    F.clear_programs()                  # the first run captures; the window sees replays
    reset_counts()
    plain, _ = run(ObsConfig())
    windows = []

    class Recorded(ProfilerWindow):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            windows.append(self)

    prof_dir = os.path.join(root, "profile")
    saved, W.ProfilerWindow = W.ProfilerWindow, Recorded
    try:
        got, win_fps = run(ObsConfig(profile_dir=prof_dir, **OPS_PROFILE))
    finally:
        W.ProfilerWindow = saved
    _, plain_fps = run(ObsConfig())     # files/s without the window, replays only too
    counts = read_counts()
    steps = default_registry().gauge("das_obs_profiled_steps").value
    captured = len(windows) == 1 and windows[0].captured
    traces = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
    names, graph_launches, trace_mb = set(), 0, 0.0
    if captured:
        path = windows[0].trace_path
        trace_mb = os.path.getsize(path) / 1e6
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
        graph_launches = sum(1 for e in events
                             if str(e.get("name", "")).startswith("cudaGraphLaunch"))
    b1_named = any(FUSED_KERNEL_NAMES["traj_gather"] in n for n in names)
    equal_plain = bool(np.array_equal(got.avg_image, plain.avg_image))
    equal_serial = bool(np.array_equal(plain.avg_image, serial_ref))
    log(f"profiler window: captured {captured}, das_obs_profiled_steps {steps}, traces "
        f"{traces} ({trace_mb:.1f} MB), {len(names)} kernel names, B1 named {b1_named}, "
        f"cudaGraphLaunch events {graph_launches}; image equal to the run without the "
        f"window {equal_plain}, to phase 14's serial loop {equal_serial}; files/s "
        f"{win_fps:.3f} with the window, {plain_fps:.3f} without (information only)")
    if not (captured and steps == OPS_PROFILE["profile_n_chunks"] and len(traces) == 1
            and b1_named and graph_launches > 0 and equal_plain and equal_serial):
        raise AssertionError("profiler window: a check failed (see the line above)")
    return {"launches": counts, "captured": captured, "profiled_steps": steps,
            "b1_named": b1_named,
            "graph_launches": graph_launches, "trace_mb": trace_mb,
            "equal_plain": equal_plain, "equal_serial": equal_serial,
            "files_per_s_window": win_fps, "files_per_s_plain": plain_fps}


def _sampled(sampler, reg, label: str) -> dict:
    """The sampler's largest ``das_device_bytes_in_use`` against
    ``das_device_peak_bytes`` and ``torch.cuda.max_memory_allocated()``."""
    sampled = sampler.max_in_use.get("cuda:0", 0.0)
    peak = reg.gauge("das_device_peak_bytes", labels=("device",)).labels(device="cuda:0").value
    mma = torch.cuda.max_memory_allocated()
    log(f"memory sampler ({label}): largest sampled bytes in use {sampled:.0f}, "
        f"das_device_peak_bytes {peak:.0f}, max_memory_allocated {mma}, thread alive "
        f"{sampler.alive}")
    if not (0 < sampled <= peak and peak == mma and not sampler.alive):
        raise AssertionError(f"memory sampler ({label}): sampled {sampled}, peak {peak}, "
                             f"max_memory_allocated {mma}, alive {sampler.alive}")
    return {"max_sampled_bytes": sampled, "peak_bytes": peak, "max_memory_allocated": mma}


def _ops_sampler(section) -> dict:
    """(c) ``HBMSampler`` at 10 ms around one config-4 call, and inside a
    serving engine from its start (warm-up: one capture) over 4 fused
    requests to its close."""
    from das_diff_veh_tpu_torch.config import ObsConfig, PipelineConfig, ServeConfig
    from das_diff_veh_tpu_torch.core.section import DasSection
    from das_diff_veh_tpu_torch.obs import HBMSampler, MetricsRegistry
    from das_diff_veh_tpu_torch.ops import all_pairs as ap
    from das_diff_veh_tpu_torch.pipeline import fused as F
    from das_diff_veh_tpu_torch.serve import ImagingComputeFactory, ServingEngine
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    out = {}
    rec = make_ambient_record(ALLPAIRS["nch"], ALLPAIRS["nt"], seed=ALLPAIRS["seed"])
    reg = MetricsRegistry()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sampler = HBMSampler(reg, interval_s=OPS_SAMPLE_S)
    reset_counts()
    peak = ap.xcorr_all_pairs_peak(rec, ALLPAIRS["wlen"])
    torch.cuda.synchronize()
    counts = read_counts()
    sampler.close()
    if counts != ALLPAIRS_LAUNCHES or not bool(torch.isfinite(peak).all()):
        raise AssertionError(f"memory sampler: config-4 launches {counts}")
    out["allpairs"] = {**_sampled(sampler, reg, "one config-4 call"), "launches": counts}
    del rec, peak
    torch.cuda.empty_cache()

    x = section.x.numpy()
    d32, t = section.data.numpy().astype(np.float32), section.t.numpy()
    F.clear_programs()                  # so that the warm-up captures the bucket
    reg = MetricsRegistry()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(
        ImagingComputeFactory(PipelineConfig().replace(chunk_pipeline="fused"),
                              x_is_channels=False, x_axis=x, fs=250.0, device="cuda"),
        ServeConfig(buckets=(SERVE_BUCKETS[0],), default_deadline_ms=600000.0,
                    obs=ObsConfig(hbm_sample_interval_s=OPS_SAMPLE_S)), registry=reg)
    reset_counts()
    try:
        eng.start()
        sampler = eng._hbm
        warm_counts = read_counts()
        results = [eng.process(DasSection(d32, x, t), timeout=600)
                   for _ in range(OPS_SERVE_REQUESTS)]
        torch.cuda.synchronize()
    finally:
        eng.close()
    finite = all(np.isfinite(r.image).all() and r.n_windows > 0 for r in results)
    if warm_counts != OPS_SERVE_WARMUP_LAUNCHES or read_counts() != warm_counts or not finite:
        raise AssertionError(f"memory sampler: engine launches {warm_counts} then "
                             f"{read_counts()}, images finite {finite}")
    out["serve"] = {**_sampled(sampler, reg, f"engine warm-up + {OPS_SERVE_REQUESTS} fused "
                                             "requests"), "launches": warm_counts,
                    "joined": eng._hbm is None and not sampler.alive}
    out["launches"] = _sum_counts(counts, warm_counts)
    return out


def _timer(run, label, outputs: dict, calls: list):
    """A tuner ``time_fn``: each new candidate is warmed once outside the
    clock (its output kept in ``outputs`` under ``label(cfg, ring)``), then
    each call times one run between CUDA events, synchronizing before it
    reads."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def time_fn(cfg, ring):
        calls.append(1)
        key = label(cfg, ring)
        if key not in outputs:
            outputs[key] = run(cfg, ring)
        torch.cuda.synchronize()
        start.record()
        run(cfg, ring)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3

    return time_fn


def _sweep(store, geometry: str, cfg, ring, knob_specs, run, label, compare, tol: float,
           bit_equal_knobs=()) -> dict:
    """``tune()`` over ``knob_specs`` with the card timer; every candidate's
    output against the default's (within ``tol``; bit for bit where the
    candidate changes only ``bit_equal_knobs``); then a second ``tune()``,
    which must hit the store without timing."""
    from das_diff_veh_tpu_torch.tune import KnobSpec, tune

    knobs = [KnobSpec(path, cands) for path, cands in knob_specs]
    outputs, calls = {}, []
    time_fn = _timer(run, label, outputs, calls)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    _, _, entry = tune(store, "cuda", geometry, cfg, knobs, time_fn, reps=OPS_TUNE_REPS,
                       ring=ring)
    sweep_s = time.perf_counter() - t0
    counts = read_counts()
    n_sweep = len(calls)
    _, _, hit = tune(store, "cuda", geometry, cfg, knobs, time_fn, reps=OPS_TUNE_REPS,
                     ring=ring)
    hit_calls = len(calls) - n_sweep
    trace = [(t["path"], t["value"], t["best_s"] * 1e3) for t in entry.meta["trace"]]
    log(f"tuner, {geometry}: {sweep_s:.1f} s, {n_sweep} timed calls, launches {counts}; "
        f"baseline {entry.meta['baseline_s'] * 1e3:.3f} ms; trace (knob, value, best ms) "
        f"{[(p, v, round(ms, 3)) for p, v, ms in trace]}; winners {entry.winners}, tuned "
        f"{entry.meta['tuned_s'] * 1e3:.3f} ms, speedup {entry.meta['speedup']:.3f}; second "
        f"tune(): winners {hit.winners}, time_fn calls {hit_calls}")
    default = label(cfg, ring)
    rows, ok = [], True
    for key, got in outputs.items():
        if key == default:
            continue
        r = {"candidate": key, **compare(got, outputs[default])}
        changed = {path for (path, _), v, d in zip(knob_specs, key, default) if v != d}
        r["bar"] = "bit" if changed <= set(bit_equal_knobs) else tol
        good = r["bit_equal"] if r["bar"] == "bit" else r["peak_rel"] <= tol
        ok = ok and good
        rows.append(r)
        log(f"  candidate {dict(zip([p for p, _ in knob_specs], key))} vs the default "
            f"{dict(zip([p for p, _ in knob_specs], default))}: peak-rel {r['peak_rel']:.3e}, "
            f"bit-equal {r['bit_equal']}, bar {r['bar']}")
    if hit_calls != 0 or hit.winners != entry.winners:
        raise AssertionError(f"tuner, {geometry}: the second tune() timed {hit_calls} calls")
    if not ok:
        raise AssertionError(f"tuner, {geometry}: a candidate is outside its bar")
    return {"sweep_s": sweep_s, "timed_calls": n_sweep, "launches": counts,
            "baseline_ms": entry.meta["baseline_s"] * 1e3,
            "tuned_ms": entry.meta["tuned_s"] * 1e3, "speedup": entry.meta["speedup"],
            "trace": trace, "winners": entry.winners,
            "candidates": [{**r, "candidate": list(r["candidate"])} for r in rows],
            "store_hit_calls": hit_calls}


def _ops_tuner(section, root: str) -> dict:
    """(d) The tuner on the card: config 4 over ``ring.win_block`` and
    ``ring.lagmax_block``; the dot chunk scene over ``chunk_pipeline`` and
    ``gather.traj_gather_finish``; then the chunk winners through
    ``run_directory`` over phase 14's folder (one ``hit`` consult, the
    image equal to a run with the winners set by hand) and a serving engine
    (one tuned warm-up, no miss, no build after warm-up)."""
    import os

    from das_diff_veh_tpu_torch.config import (GatherConfig, PipelineConfig, RingConfig,
                                               ServeConfig)
    from das_diff_veh_tpu_torch.core.section import DasSection
    from das_diff_veh_tpu_torch.obs import MetricsRegistry, default_registry
    from das_diff_veh_tpu_torch.ops import all_pairs as ap
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk
    from das_diff_veh_tpu_torch.pipeline.workflow import run_directory
    from das_diff_veh_tpu_torch.runtime import RuntimeConfig
    from das_diff_veh_tpu_torch.serve import ImagingComputeFactory, ServingEngine
    from das_diff_veh_tpu_torch.tune import TunerStore, apply_winners
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    store_path = os.path.join(root, "tuner_store.json")
    store = TunerStore(store_path)
    t0 = time.perf_counter()
    rec = make_ambient_record(ALLPAIRS["nch"], ALLPAIRS["nt"], seed=ALLPAIRS["seed"])

    def run_allpairs(cfg, ring):
        return ap.xcorr_all_pairs_peak(rec, ALLPAIRS["wlen"], win_block=ring.win_block,
                                       lagmax_block=ring.lagmax_block)

    def cmp_tensors(got, want):
        got, want = (got,) if torch.is_tensor(got) else got, \
            (want,) if torch.is_tensor(want) else want
        return {"peak_rel": max(peak_rel(g, w) for g, w in zip(got, want)),
                "bit_equal": all(bool(torch.equal(g, w)) for g, w in zip(got, want))}

    allpairs = _sweep(store, "config4", PipelineConfig(), RingConfig(), OPS_ALLPAIRS_KNOBS,
                      run_allpairs, lambda cfg, ring: (ring.win_block, ring.lagmax_block),
                      cmp_tensors, OPS_ALLPAIRS_KNOB_TOL)
    del rec
    torch.cuda.empty_cache()

    base = PipelineConfig().replace(gather=GatherConfig(wlen=DOT_WLEN_S))
    sec32 = section.to(dtype=torch.float32)

    def run_chunk(cfg, ring):
        res = process_chunk(sec32, cfg, method="xcorr", device="cuda")
        return res.disp_image, res.vsg_stack

    chunk = _sweep(store, "chunk_scene", base, None, OPS_CHUNK_KNOBS, run_chunk,
                   lambda cfg, ring: (cfg.chunk_pipeline, cfg.gather.traj_gather_finish),
                   cmp_tensors, OPS_CHUNK_KNOB_TOL, bit_equal_knobs=("chunk_pipeline",))
    sweeps_s = time.perf_counter() - t0
    log(f"tuner sweeps: {sweeps_s:.1f} s (budget {OPS_SWEEP_BUDGET_S} s)")
    if sweeps_s > OPS_SWEEP_BUDGET_S:
        raise AssertionError(f"tuner sweeps took {sweeps_s:.1f} s")

    # the chunk winners through run_directory over phase 14's files without
    # a planted fault (the dot chunk scene's configuration has no health
    # screen): one hit, the image of the winners set by hand
    clean = os.path.join(root, "clean")
    os.makedirs(os.path.join(clean, BATCH_DATE))
    for i in range(len(BATCH_SEEDS)):
        if i not in (BATCH_DEGRADED, BATCH_POISONED, BATCH_GARBAGE):
            os.link(os.path.join(root, BATCH_DATE, _batch_file(i)),
                    os.path.join(clean, BATCH_DATE, _batch_file(i)))
    consults = default_registry().counter("das_tuner_consults_total", labels=("status",))
    hits0 = consults.labels(status="hit").value
    rt = dict(prefetch_depth=2, retry_backoff_s=0.0)
    reset_counts()
    tuned = run_directory(_ops_dataset(clean), base, x_is_channels=False,
                          runtime=RuntimeConfig(**rt, tuner_store=store_path,
                                                tuner_geometry="chunk_scene"),
                          device="cuda")
    hits = consults.labels(status="hit").value
    by_hand, _ = apply_winners(base, chunk["winners"])
    manual = run_directory(_ops_dataset(clean), by_hand, x_is_channels=False,
                           runtime=RuntimeConfig(**rt), device="cuda")
    batch_equal = bool(tuned.avg_image is not None
                       and np.array_equal(tuned.avg_image, manual.avg_image))
    log(f"tuned run_directory: das_tuner_consults_total{{status=\"hit\"}} {hits} (was "
        f"{hits0}), image equal to the winners set by hand {batch_equal}, "
        f"{tuned.n_chunks} chunks, quarantined {len(tuned.quarantined)}")
    if not (hits0 == 0 and hits == 1 and batch_equal and not tuned.quarantined):
        raise AssertionError("tuned run_directory: a check failed (see the line above)")

    # the chunk winners through a serving engine
    x = section.x.numpy()
    d32, t = section.data.numpy().astype(np.float32), section.t.numpy()
    reg = MetricsRegistry()
    factory = ImagingComputeFactory(base, x_is_channels=False, x_axis=x, fs=250.0,
                                    tuner_store=store_path, tuner_geometry="chunk_scene",
                                    device="cuda")
    eng = ServingEngine(factory, ServeConfig(buckets=(SERVE_BUCKETS[0],),
                                             default_deadline_ms=600000.0), registry=reg)
    batch_counts = read_counts()
    reset_counts()
    try:
        eng.start()
        served = [eng.process(DasSection(d32, x, t), timeout=600) for _ in range(2)]
        m = eng.metrics()
        steady = reg.get("das_serve_steady_state_compiles").value
    finally:
        eng.close()
    engine_counts = read_counts()
    log(f"tuned engine: factory winners {factory.tuner_entry and factory.tuner_entry.winners}, "
        f"tuned_warmups {m['tuned_warmups']}, cache_misses {m['cache_misses']}, "
        f"das_serve_steady_state_compiles {steady}, {len(served)} requests")
    if not (factory.tuner_entry is not None and m["tuned_warmups"] == 1
            and m["cache_misses"] == 0 and steady == 0
            and all(r.n_windows > 0 for r in served)):
        raise AssertionError("tuned engine: a check failed (see the line above)")
    return {"launches": _sum_counts(allpairs["launches"], chunk["launches"], batch_counts,
                                    engine_counts),
            "allpairs": allpairs, "chunk": chunk, "sweeps_s": sweeps_s,
            "batch": {"hit": hits, "equal_by_hand": batch_equal},
            "engine": {"tuned_warmups": m["tuned_warmups"], "cache_misses": m["cache_misses"],
                       "steady_state_compiles": steady}}


def phase_ops(section, root: str, serial_ref: np.ndarray, nvidia_smi: str) -> dict:
    """Phase 19: the ops layers on the card (figure set, profiler window,
    memory sampler, tuner), with the launches it adds per kernel."""
    t0 = time.perf_counter()
    out = {"device": nvidia_smi}
    for part, fn in (("figures", _ops_figures),
                     ("profiler", lambda: _ops_profiler(root, serial_ref)),
                     ("sampler", lambda: _ops_sampler(section)),
                     ("tuner", lambda: _ops_tuner(section, root))):
        WATCH.phase = f"19 ops: {part}"
        out[part] = fn()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    out["launches"] = _sum_counts(*(out[p]["launches"] for p in
                                    ("figures", "profiler", "sampler", "tuner")))
    log(f"phase 19 launches: {out['launches']}")
    log(f"ops phase ({nvidia_smi}) took {out['phase_s']:.1f} s (budget {OPS_PHASE_BUDGET_S} s)")
    if out["phase_s"] > OPS_PHASE_BUDGET_S:
        raise AssertionError(f"phase 19 took {out['phase_s']:.1f} s")
    return out


def _ops_line(op: dict) -> dict:
    """The ``ops`` JSON line: phase 19's checks, sweeps and walls."""
    tu = op["tuner"]
    return {"device": op["device"], "phase_s": op["phase_s"], "launches": op["launches"],
            "figures": {k: op["figures"][k] for k in ("matplotlib", "launches",
                                                      "b1_equal_plain", "stack_peak_rel",
                                                      "image_peak_rel", "wall_s")},
            "profiler": {k: op["profiler"][k] for k in (
                "captured", "profiled_steps", "b1_named", "equal_plain", "equal_serial",
                "files_per_s_window", "files_per_s_plain")},
            "sampler": {k: {m: op["sampler"][k][m] for m in (
                "max_sampled_bytes", "peak_bytes", "max_memory_allocated")}
                for k in ("allpairs", "serve")},
            "tuner": {"sweeps_s": tu["sweeps_s"], **{k: {m: tu[k][m] for m in (
                "baseline_ms", "tuned_ms", "speedup", "winners", "store_hit_calls")}
                | {"candidates": [(c["candidate"], c["peak_rel"], c["bit_equal"])
                                  for c in tu[k]["candidates"]]}
                for k in ("allpairs", "chunk")}, "batch": tu["batch"],
                "engine": tu["engine"]}}


# Phase 20: the mesh across processes.  The parent has built every kernel
# (phase 2) and spawns MP_RANKS gloo ranks, one slot each on the first card
# (``make_mesh(4, device="cuda:0")`` under the group), which load the
# libraries without building.  (a) config 4 through
# ``sharded_all_pairs_peak`` in ring mode (double-buffered and serialized),
# replicated and in the bf16 tier, against the unsharded call and phase
# 16's single-process 4-slot ring, which rank 0 computes while the other
# ranks wait; walls of both rings in turns; (b) the chunk scene's 64-slot
# window batch through ``sharded_stack_pipeline`` against phase 16's 4-slot
# stack; (c) an 8-target fleet at phase 17's width (depth cut) against one
# slot; (d) one ``parallel.ring`` fault planted on rank 1 only.  With 2 or
# more cards, (a) and (b) again over NCCL, one rank per card.
MP_RANKS = 4
MP_GROUP_TIMEOUT_S = 120       # a collective waits at most this long
MP_JOIN_DEADLINE_S = 480       # every rank of a spawn has exited by then
MP_RING_CONFIGS = (("ring", {}), ("serialized", {"double_buffer": False}),
                   ("replicated", {"mode": "replicated"}), ("bf16", {"precision": "bf16"}))
# (c): phase 17's fleet (popsize 50, 8 refine starts, 400-point grid, 2 runs),
# maxiter and the refine steps cut from 20 to 8 to keep the phase near 120 s
MP_FLEET = dict(SCIENCE_FLEET, maxiter=8, n_refine_steps=8)
MP_REDUCED = {"fleet_maxiter": {"run": 8, "phase17": 20, "invert_fleet_default": 200},
              "fleet_n_refine_steps": {"run": 8, "phase17": 20, "invert_fleet_default": 80}}
# the fleet's refined members may sum in another order at another batch
# size (phase 17); every other field is held bit for bit
FLEET_MEMBER_GAP = 1e-12


def _ring_launches(nch: int, slots: int, mode: str = "ring") -> dict:
    """B3 and B4 launches of one rank driving one slot of a ``slots``-slot
    ring at the entry's defaults (src_chunk 64, lagmax_block 512)."""
    shard = -(-nch // slots)
    chunks = -(-shard // 64)
    if mode == "replicated":
        return {**NO_LAUNCHES, "cross_spectra": chunks,
                "lag_absmax": chunks * -(-slots * shard // 512)}
    return {**NO_LAUNCHES, "cross_spectra": slots * chunks,
            "lag_absmax": slots * chunks * -(-shard // 512)}


def _sync(devices) -> None:
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def _add_counts(total: dict, counts: dict, bf16: bool = False) -> None:
    """Add ``counts`` to ``total``; a bf16 run's B3 launches go to its own
    tier's row (B4 has one tier)."""
    for k, v in counts.items():
        k = "cross_spectra_bf16" if bf16 and k == "cross_spectra" else k
        total[k] = total.get(k, 0) + v


def _sent_bytes() -> float:
    """The bytes this rank has sent to other ranks (the registry counter)."""
    from das_diff_veh_tpu_torch.obs.registry import default_registry
    from das_diff_veh_tpu_torch.parallel.distributed import SENT_BYTES

    fam = default_registry().get(SENT_BYTES)
    return fam.value if fam is not None else 0.0


def _mp_ring(rank: int, mesh, local, launched: dict, barrier) -> tuple:
    """(a) on one rank: every mode against the references (rank 0), then
    both rings' walls in turns; returns ``(report, rank 0's references)``."""
    from das_diff_veh_tpu_torch.config import RingConfig
    from das_diff_veh_tpu_torch.ops.all_pairs import xcorr_all_pairs_peak
    from das_diff_veh_tpu_torch.parallel import sharded_all_pairs_peak
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    home = mesh.devices[mesh.local_slots[0]]
    wlen = ALLPAIRS["wlen"]
    rec = make_ambient_record(ALLPAIRS["nch"], ALLPAIRS["nt"], seed=ALLPAIRS["seed"],
                              device=home)
    refs = {}
    if rank == 0:
        refs = {"f32": xcorr_all_pairs_peak(rec, wlen, device=home),
                "bf16": xcorr_all_pairs_peak(rec, wlen, precision="bf16", device=home),
                "single_process_ring": sharded_all_pairs_peak(rec, wlen, local)}
    out = {"launches": {}, "sent_bytes": {}, "equal": {}}
    for name, kw in MP_RING_CONFIGS:
        cfg = RingConfig(**kw)
        _sync(mesh.devices[j] for j in mesh.local_slots)
        barrier()
        reset_counts()
        sent0 = _sent_bytes()
        got = sharded_all_pairs_peak(rec, wlen, mesh, ring=cfg)
        _sync([home])
        out["launches"][name] = read_counts()
        _add_counts(launched, out["launches"][name], bf16=cfg.precision == "bf16")
        out["sent_bytes"][name] = int(_sent_bytes() - sent0)
        if rank == 0:
            ok = (got.is_cuda and got.dtype == torch.float32 and bool(torch.isfinite(got).all())
                  and torch.equal(got, refs["bf16" if cfg.precision == "bf16" else "f32"]))
            if name == "ring":
                ok = ok and torch.equal(got, refs["single_process_ring"])
            out["equal"][name] = bool(ok)
        elif got is not None:
            raise AssertionError(f"rank {rank} got a result from the ring")
        del got
    # walls: phase 16's single-process ring on rank 0 (the other ranks wait),
    # then the ring across the ranks, 3 times in turns
    walls = {"single_process_ring": [], "multiprocess_ring": []}
    peak = 0
    for _ in range(3):
        barrier()
        if rank == 0:
            _sync(local.devices)
            t0 = time.perf_counter()
            sharded_all_pairs_peak(rec, wlen, local)
            _sync(local.devices)
            walls["single_process_ring"].append((time.perf_counter() - t0) * 1e3)
        barrier()
        _sync([home])
        torch.cuda.reset_peak_memory_stats(home)
        reset_counts()
        t0 = time.perf_counter()
        got = sharded_all_pairs_peak(rec, wlen, mesh)
        _sync([home])
        walls["multiprocess_ring"].append((time.perf_counter() - t0) * 1e3)
        _add_counts(launched, read_counts())
        peak = max(peak, torch.cuda.max_memory_allocated(home))
        del got
    out.update(wall_ms=walls, device_memory_peak_bytes=peak)
    return out, refs


def _mp_stack(rank: int, mesh, local, inputs: dict, launched: dict, barrier) -> dict:
    """(b) on one rank: the sharded stack against phase 16's 4-slot stack."""
    from das_diff_veh_tpu_torch.parallel import sharded_stack_pipeline

    batch, g, offs, kw = inputs["stack"]
    want = sharded_stack_pipeline(batch, g, offs, local, **kw) if rank == 0 else None
    home = mesh.devices[mesh.local_slots[0]]
    _sync([home])
    barrier()
    reset_counts()
    t0 = time.perf_counter()
    got = sharded_stack_pipeline(batch, g, offs, mesh, **kw)
    _sync([home])
    out = {"wall_ms": (time.perf_counter() - t0) * 1e3, "launches": read_counts()}
    _add_counts(launched, out["launches"])
    if rank == 0:
        out["equal"] = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    elif got is not None:
        raise AssertionError(f"rank {rank} got a result from the stack")
    return out


def _mp_fleet(rank: int, mesh, inputs: dict, barrier) -> dict:
    """(c) on one rank: the fleet across the ranks against one slot."""
    from das_diff_veh_tpu_torch.inversion import invert_fleet

    spec, sets = inputs["fleet"]
    out = {}
    if rank == 0:
        t0 = time.perf_counter()
        one = invert_fleet(spec, sets, device="cuda", **MP_FLEET)
        out["one_slot_wall_s"] = time.perf_counter() - t0
    barrier()
    t0 = time.perf_counter()
    got = invert_fleet(spec, sets, mesh=mesh, **MP_FLEET)
    out["multiprocess_wall_s"] = time.perf_counter() - t0
    if rank == 0:
        gaps = {f: float(np.nanmax(np.abs(np.asarray(a, float) - np.asarray(b, float))))
                for f, a, b in zip(got._fields, got, one)}
        out["gaps"] = gaps
        out["equal"] = all(g == 0.0 for f, g in gaps.items()
                           if f not in ("models_x", "misfits"))
        out["members_max_gap"] = max(gaps["models_x"], gaps["misfits"])
    elif got is not None:
        raise AssertionError(f"rank {rank} got a result from the fleet")
    return out


def _mp_ladder(rank: int, mesh, refs: dict, launched: dict) -> dict:
    """(d) on one rank: one ``parallel.ring`` fault planted on rank 1 only
    through ``resilient_all_pairs_peak``; every rank must demote."""
    from das_diff_veh_tpu_torch.resilience import degrade, faults
    from das_diff_veh_tpu_torch.resilience.faults import FaultPlan, FaultSpec
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    home = mesh.devices[mesh.local_slots[0]]
    rec = make_ambient_record(ALLPAIRS["nch"], ALLPAIRS["nt"], seed=ALLPAIRS["seed"],
                              device=home)
    WATCH.phase = f"20 multiproc: all-pairs ladder, rank {rank}"
    degrade.set_ladder(degrade.DegradationLadder(flight=WATCH))
    plan = FaultPlan(specs=(FaultSpec("parallel.ring", "error"),) if rank == 1 else ())
    reset_counts()
    with faults.injected(plan) as inj:
        fell = degrade.resilient_all_pairs_peak(rec, ALLPAIRS["wlen"], mesh)
        fired = inj.n_injected
    _sync([home])
    _add_counts(launched, read_counts())
    out = {"fired": fired, "demoted": degrade.demoted(degrade.PARALLEL_RING),
           "demotions": WATCH.seen}
    if rank == 0:
        out["equal"] = bool(torch.equal(fell, refs["f32"]))
    degrade.reset()
    return out


def _mp_rank(rank: int, world: int, backend: str, full: bool, out_dir: str) -> None:
    """One rank of phase 20, in a spawned process (its stdout is the
    parent's): join the group, run the parts and leave its report in
    ``out_dir``."""
    import os

    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)       # the ranks share the host's cores
    sys.path.insert(0, str(REPO))
    from das_diff_veh_tpu_torch import kernels
    from das_diff_veh_tpu_torch.parallel import Mesh, initialize_cluster, make_mesh

    kernels.build_all()            # the parent built them: this only loads
    build_s = sum(kernels.build_seconds.values())
    log(f"phase 20 {backend} rank {rank}/{world}: build_seconds {build_s}")
    initialize_cluster(f"file://{out_dir}/store", world, rank, backend=backend,
                       timeout_s=MP_GROUP_TIMEOUT_S)
    import torch.distributed as dist

    try:
        inputs = torch.load(Path(out_dir).parent / "inputs.pt", weights_only=False)
        if backend == "gloo":
            mesh = make_mesh(world, device="cuda:0")
            local = Mesh((mesh.devices[0],) * world)        # phase 16's 4 slots of the card
            host = None
        else:
            mesh = make_mesh(world)                           # one card a rank
            local = Mesh(tuple(torch.device("cuda", i) for i in range(world)))
            # the ranks wait for rank 0's references on the host: an NCCL
            # barrier would spin a kernel on the cards rank 0 is timing
            host = dist.new_group(backend="gloo")

        def barrier():
            dist.barrier(group=host)

        launched = dict(NO_LAUNCHES, cross_spectra_bf16=0)
        out = {"rank": rank, "build_seconds": build_s, "slot_device": str(
            mesh.devices[mesh.local_slots[0]]), "ranks": mesh.ranks}
        out["ring"], refs = _mp_ring(rank, mesh, local, launched, barrier)
        out["stack"] = _mp_stack(rank, mesh, local, inputs, launched, barrier)
        if full:
            out["fleet"] = _mp_fleet(rank, mesh, inputs, barrier)
            out["ladder"] = _mp_ladder(rank, mesh, refs, launched)
        out["launched"] = launched
        out["loaded"] = sorted(m for m in ("jax", "das_diff_veh_tpu") if m in sys.modules)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _mp_spawn(world: int, backend: str, full: bool, root: Path) -> tuple:
    """Spawn ``world`` ranks of phase 20 and wait for them by the deadline
    (stragglers are killed); every rank's report, and the spawn's wall."""
    import multiprocessing

    out_dir = root / backend
    out_dir.mkdir()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mp_rank, args=(r, world, backend, full, str(out_dir)))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + MP_JOIN_DEADLINE_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    wall = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    if late or codes != [0] * world:
        raise AssertionError(f"phase 20 {backend}: ranks {late} missed the "
                             f"{MP_JOIN_DEADLINE_S} s deadline; exit codes {codes}")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)], wall


def _mp_inputs(section, root: Path) -> None:
    """What every rank passes alike, written once: the chunk scene's window
    batch with its gather geometry (b), and phase 17's fleet curve sets (c)."""
    from das_diff_veh_tpu_torch.config import BootstrapConfig, DispersionConfig, PipelineConfig
    from das_diff_veh_tpu_torch.inversion import Curve, speed_model_spec
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    cfg = PipelineConfig()
    batch = process_chunk(section.to("cuda", torch.float32), cfg, device="cuda").batch
    batch = dataclasses.replace(batch, **{f.name: getattr(batch, f.name).cpu()
                                          for f in dataclasses.fields(batch)})
    g, offs, _ = _gather_geometry(section, cfg)
    kw = dict(gather_cfg=cfg.gather, disp_cfg=cfg.dispersion,
              disp_start_x=cfg.imaging.disp_start_x, disp_end_x=cfg.imaging.disp_end_x,
              dx=cfg.interrogator.dx)
    parity = json.loads((REPO / "INVERSION_PARITY.json").read_text())["700_mid_speed"]
    spec = speed_model_spec()
    model = spec.to_model(torch.tensor(parity["x_best"], dtype=torch.float64, device="cuda"))
    curves = _science_curves(model, DispersionConfig().freqs(), BootstrapConfig())
    rng = np.random.default_rng(11)            # phase 17's noise draws
    sets = [[Curve(c.period, c.velocity + rng.normal(0.0, c.uncertainty), c.mode, c.weight,
                   c.uncertainty) for c in curves] for _ in range(SCIENCE_TARGETS)]
    torch.save({"stack": (batch, g, offs, kw), "fleet": (spec, sets)}, root / "inputs.pt")


def _mp_check(label: str, reports: list, slots: int, full: bool) -> dict:
    """Hold one spawn's reports to phase 20's contract; its summary."""
    nch = ALLPAIRS["nch"]
    r0 = reports[0]
    summary = {"ranks": len(reports), "slot_devices": [r["slot_device"] for r in reports],
               "build_seconds": [r["build_seconds"] for r in reports],
               "loaded": [r["loaded"] for r in reports],
               "ring_equal": r0["ring"]["equal"], "stack_equal": r0["stack"]["equal"],
               "ring_launches_per_rank": [r["ring"]["launches"] for r in reports],
               "stack_launches_per_rank": [r["stack"]["launches"]["traj_gather"]
                                           for r in reports],
               "sent_bytes_per_call": {name: sum(r["ring"]["sent_bytes"][name] for r in reports)
                                       for name, _ in MP_RING_CONFIGS},
               "wall_ms": r0["ring"]["wall_ms"],
               "wall_ms_median": {k: float(np.median(v))
                                  for k, v in r0["ring"]["wall_ms"].items()},
               "device_memory_peak_bytes": [r["ring"]["device_memory_peak_bytes"]
                                            for r in reports],
               "stack_wall_ms": r0["stack"]["wall_ms"],
               "launched": {k: sum(r["launched"][k] for r in reports)
                            for k in reports[0]["launched"]}}
    want = {name: _ring_launches(nch, slots, kw.get("mode", "ring")) for name, kw in
            MP_RING_CONFIGS}
    bad = []
    if any(b != 0 for b in summary["build_seconds"]):
        bad.append("a rank built a kernel")
    if any(summary["loaded"]):
        bad.append("a rank loaded JAX")
    if not all(summary["ring_equal"].values()) or not summary["stack_equal"]:
        bad.append("a result differs")
    if any(r["ring"]["launches"] != want for r in reports):
        bad.append(f"ring launches, reckoned {want}")
    if any(n != 2 for n in summary["stack_launches_per_rank"]):
        bad.append("B1 is not 2 a rank in the stack")
    if full:
        fl = r0["fleet"]
        summary["fleet"] = {"one_slot_wall_s": fl["one_slot_wall_s"],
                            "multiprocess_wall_s": [r["fleet"]["multiprocess_wall_s"]
                                                    for r in reports],
                            "equal": fl["equal"], "members_max_gap": fl["members_max_gap"]}
        if not (fl["equal"] and fl["members_max_gap"] <= FLEET_MEMBER_GAP):
            bad.append(f"the fleet differs from one slot: {fl['gaps']}")
        lad = [r["ladder"] for r in reports]
        summary["ladder"] = {"fired": [x["fired"] for x in lad],
                             "demoted": [x["demoted"] for x in lad],
                             "equal": lad[0]["equal"],
                             "errors": [[d["error"] for d in x["demotions"]] for x in lad]}
        if not (summary["ladder"]["fired"] == [int(r == 1) for r in range(len(lad))]
                and all(summary["ladder"]["demoted"]) and lad[0]["equal"]
                and all(len(x["demotions"]) == 1 for x in lad)):
            bad.append(f"the planted fault did not demote every rank: {summary['ladder']}")
    log(f"phase 20 {label}: {summary}")
    if bad:
        raise AssertionError(f"phase 20 {label}: {bad}")
    return summary


def phase_multiproc(section, nvidia_smi: str) -> dict:
    """Phase 20: the mesh across processes, gloo ranks sharing the card and,
    with 2 or more cards, NCCL ranks one a card."""
    t0 = time.perf_counter()
    (REPO / "build").mkdir(exist_ok=True)
    out = {"device": nvidia_smi, "reduced": MP_REDUCED}
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="multiproc_") as tmp:
        root = Path(tmp)
        _mp_inputs(section, root)
        torch.cuda.empty_cache()
        WATCH.phase = "20 multiproc: gloo"
        reports, wall = _mp_spawn(MP_RANKS, "gloo", True, root)
        out["gloo"] = _mp_check(f"gloo, {MP_RANKS} ranks on one card", reports, MP_RANKS, True)
        out["gloo"]["spawn_wall_s"] = wall
        for r in reports:              # every rank's demotion was planted in (d)
            for d in r["ladder"]["demotions"]:
                WATCH.seen.append(dict(d, planted=True))
        if cards >= 2:
            WATCH.phase = "20 multiproc: nccl"
            reports, wall = _mp_spawn(cards, "nccl", False, root)
            out["nccl"] = _mp_check(f"nccl, {cards} ranks one a card", reports, cards, False)
            out["nccl"]["spawn_wall_s"] = wall
        else:
            out["nccl"] = ("not run: this machine has one card, and NCCL refuses two ranks "
                           "on one card (each NCCL rank needs a card of its own)")
            log(f"phase 20: the NCCL run was {out['nccl']}")
    out["phase_s"] = time.perf_counter() - t0
    log(f"multiproc phase ({nvidia_smi}) took {out['phase_s']:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm chunk of each kind and one warm "
                         "all-pairs call with torch.profiler")
    args = ap.parse_args()
    t_script = time.perf_counter()
    sys.path.insert(0, str(REPO))
    results = {}
    try:
        WATCH.phase = "1 device"
        results["device"] = phase_device()
        import das_diff_veh_tpu_torch  # noqa: F401  (fails outside the repository)
        from das_diff_veh_tpu_torch.resilience import degrade

        # the process ladder reports every demotion to WATCH (the workflow's
        # hook feeds it on the card); phases 16 and 20 plant the only ones
        # allowed
        degrade.set_ladder(degrade.DegradationLadder(flight=WATCH))
        smi = results["device"]["nvidia_smi"]
        WATCH.phase = "2 build"
        results["build"] = phase_build()
        WATCH.phase = "3 kernel vs plain"
        results["kernel_vs_plain"] = phase_kernel_vs_plain()
        section = _main_path_inputs()
        WATCH.phase = "4-6 main path"
        main_path = phase_main_path(section)
        results["times"] = phase_times(main_path)
        if args.profile:
            results["profile"] = phase_profile(main_path)
        cpu_image = main_path["cpu_image"]
        results["main_path"] = {k: v for k, v in main_path.items()
                                if k not in ("captured", "sec32", "cfg", "cpu_image")}
        del main_path
        WATCH.phase = "7-9 all-pairs"
        results["allpairs_kernels_vs_plain"] = phase_allpairs_kernels_vs_plain()
        allpairs = phase_allpairs_path(profile=args.profile)
        results["lag_domain"] = phase_lag_domain()
        allpairs_kernels = phase_allpairs_times(allpairs)
        results["allpairs"] = {k: v for k, v in allpairs.items() if k != "captured"}
        del allpairs
        torch.cuda.empty_cache()
        results["long_record"] = phase_long_record()
        torch.cuda.empty_cache()
        results["day_stack"] = phase_day_stack()
        WATCH.phase = "10-13 dot and surface_wave"
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
        (REPO / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="batch_smoke_") as root:
            WATCH.phase = "14 batch"
            results["batch"] = phase_batch(section, smi, root)
            serial_images = results["batch"].pop("serial_images")
            WATCH.phase = "15 fused"
            results["fused"] = phase_fused(section, smi)
            torch.cuda.empty_cache()
            results["mesh"], shard_kernel = phase_mesh(section, cpu_image, root, serial_images,
                                                       smi)
            # B3 again at the ring's receiver-shard shape
            results["times"]["kernels"].append(shard_kernel)
            torch.cuda.empty_cache()
            results["science"] = phase_science(smi)
            torch.cuda.empty_cache()
            results["serve"] = phase_serve(section, smi)
            torch.cuda.empty_cache()
            # phase 14's serial staged loop, summed in file order
            serial_ref = None
            for img in serial_images.values():
                serial_ref = img if serial_ref is None else serial_ref + img
            results["ops"] = phase_ops(section, root, serial_ref, smi)
        torch.cuda.empty_cache()
        results["multiproc"] = phase_multiproc(section, smi)
        # the launches phases 19 and 20 add, beside each kernel's earlier ones
        # (phase 19's counters do not tell the tiers apart; phase 20's are
        # summed over its ranks and its runs across processes, by tier)
        mp = results["multiproc"]
        for k in results["times"]["kernels"]:
            key = {"traj_gather_pack": "traj_gather", "traj_dot_correlate": "traj_dot",
                   "cross_spectra": "cross_spectra", "lag_absmax": "lag_absmax"}.get(k["name"])
            k["launches_phase19"] = results["ops"]["launches"][key] if key else 0
            key = "cross_spectra_bf16" if k["name"] == "cross_spectra_bf16" else key
            k["launches_phase20"] = (sum(mp[b]["launched"][key] for b in ("gloo", "nccl")
                                         if isinstance(mp[b], dict)) if key else 0)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr, flush=True)
        return 1
    return _finish(args, results, t_script)


def _finish(args, results: dict, t_script: float) -> int:
    """Check the run's demotions, write ``--out`` and print the JSON lines,
    the card's name and power limit and the last line."""
    stray = [d for d in WATCH.seen if not d["planted"]]
    log(f"demotions over the run: {len(WATCH.seen)}, planted by phases 16 and 20: "
        f"{sum(d['planted'] for d in WATCH.seen)}, not planted: {stray}")
    if stray:
        print(f"chip_smoke: FAILED: demotions that no phase planted: {stray}", file=sys.stderr,
              flush=True)
        return 1
    results["demotions"] = WATCH.seen
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
    me = results["mesh"]
    log(json.dumps({"mesh": {
        "device": me["device"], "slots": me["ring"]["slots"],
        "ring_launches_d4": me["ring"]["launches_d4"], "ring_equal": me["ring"]["equal"],
        "ring_wall_ms_median": me["ring"]["wall_ms_median"],
        "ring_device_memory_peak_bytes": me["ring"]["device_memory_peak_bytes"],
        "stack_d4_image_peak_rel": me["stack"][f"d{MESH_SLOTS}"]["image_peak_rel"],
        "demotions": [(d["phase"], d["component"]) for d in results["demotions"]],
        "phase_s": me["phase_s"]}}))
    log(json.dumps({"science": _science_line(results["science"])}))
    log(json.dumps({"serve": _serve_line(results["serve"])}))
    log(json.dumps({"ops": _ops_line(results["ops"])}))
    log(json.dumps({"multiproc": results["multiproc"]}))
    log(f"script wall {time.perf_counter() - t_script:.1f} s")
    log(dev["nvidia_smi"])
    log(json.dumps({"kernels": results["times"]["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
