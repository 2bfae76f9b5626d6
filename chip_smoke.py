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
6. with ``--profile``: device time by kernel over one warm chunk.

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
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)

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
        tg.launches = 0
        t0 = time.perf_counter()
        res = process_chunk(sec32, cfg, method="xcorr", device="cuda")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = tg.launches
    finally:
        tg.pack_windows_cuda = launch
    log(f"main path: first chunk {first_s:.3f} s, traj_gather launches {launches}, "
        f"n_windows {res.n_windows}")
    img = res.disp_image
    if launches != 2:
        raise AssertionError(f"expected 2 traj_gather launches per chunk, got {launches}")
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


def phase_profile(main: dict) -> dict:
    """Device time by operator over one warm chunk (``--profile``): the
    device's busy share of the chunk's wall time and the largest consumers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        process_chunk(main["sec32"], main["cfg"], method="xcorr", device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies): an operator's row repeats the
    # device time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    n_kernels = sum(r[2] for r in rows)
    log(f"profile: wall {wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %), {n_kernels} kernels and copies")
    for key, ms, count in rows[:15]:
        log(f"  {ms:10.4f} ms  x{count:<6d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_ops": n_kernels,
            "top": [{"op": k, "device_ms": m, "count": c} for k, m, c in rows[:40]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm chunk with torch.profiler")
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
    log(dev["nvidia_smi"])
    log(json.dumps({"kernels": results["times"]["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
