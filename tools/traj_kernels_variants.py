#!/usr/bin/env python3
"""Build variants of kernels B1 (``csrc/traj_gather.cu``) and B2
(``csrc/traj_dot.cu``) and time them in turns on one card, on the inputs the
chunk path gives them.

    python3 tools/traj_kernels_variants.py [--gather NAME=PATH ...]
        [--dot NAME=PATH ...] [--rounds N] [--out results.json]

The committed sources are always built (as ``committed``); each ``--gather``
or ``--dot`` compiles another copy of that kernel, for instance an earlier
design kept outside the package (``git show <commit>:<path>``).  A copy must
keep the committed C interface (``traj_gather_pack``,
``traj_dot_correlate``).

The inputs are those of the chunk scene of ``chip_smoke.py``: the default
chunk's two B1 launches (64 slots x 7 and x 18 rows, ``nwin`` 2, ``wlen``
500) and the 1 s-window dot chunk's two B2 launches (``nwin`` 6, ``wlen``
250), captured from ``process_chunk`` on the card.  Every build is first
checked against the plain version on them (B1 and B2 f32 ``torch.equal``;
B2 bf16 within 1e-5 peak-relative), then each kernel is timed per chunk
(both launches) with CUDA-graph replays, the builds in turns (the order
reversed every other round) so that they share the card's clocks.  Needs a
CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

OUT_DIR = REPO / "build" / "variants"
SCENE = dict(nch=140, duration=120.0, n_vehicles=6, seed=2, speed_range=(12.0, 18.0))
BF16_TOL = 1e-5


def build(name: str, source: Path):
    from das_diff_veh_tpu_torch import kernels

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib = OUT_DIR / f"lib{name}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(source)]
    return name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def loaded(lib: Path, kind: str):
    """The kernel's C entry with the wrapper's argument types."""
    dll = ctypes.CDLL(str(lib))
    if kind == "gather":
        fn = dll.traj_gather_pack
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    else:
        fn = dll.traj_dot_correlate
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call_gather(fn, rec, scal, pivot, nwin, wlen, offset):
    nb, nch, nt = rec.shape
    nk = scal.shape[1]
    out_ch = torch.empty((nb, nk, nwin, wlen), device=rec.device)
    out_pv = torch.empty_like(out_ch)
    rc = fn(rec.data_ptr(), scal.data_ptr(), out_ch.data_ptr(), out_pv.data_ptr(), nb * nk, nk,
            nch, nt, pivot, nwin, wlen, offset, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"traj_gather_pack failed with CUDA error {rc}")
    return out_ch, out_pv


def call_dot(fn, rec, scal, pivot, nwin, wlen, offset, swap, precision):
    nb, nch, nt = rec.shape
    nk = scal.shape[1]
    out = torch.empty((nb, nk, wlen), device=rec.device)
    rc = fn(rec.data_ptr(), scal.data_ptr(), out.data_ptr(), nb * nk, nk, nch, nt, pivot, nwin,
            wlen, offset, int(swap), int(precision == "bf16"),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"traj_dot_correlate failed with CUDA error {rc}")
    return out


def capture_inputs():
    """The B1 launches of the default chunk and the B2 launches of the dot
    chunk, as the wrappers received them."""
    from das_diff_veh_tpu_torch.config import PipelineConfig
    from das_diff_veh_tpu_torch.io.synthetic import SceneConfig, synthesize_section
    from das_diff_veh_tpu_torch.ops import traj_gather as tg
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    sec = synthesize_section(SceneConfig(**SCENE))[0].to(dtype=torch.float32)
    cfg = PipelineConfig()
    dot_cfg = cfg.replace(gather=dataclasses.replace(cfg.gather, wlen=1.0,
                                                     traj_gather_finish="dot"))
    gather, dot = [], []
    launch_g, launch_d = tg.pack_windows_cuda, tg.correlate_dot_cuda
    tg.pack_windows_cuda = lambda *a: gather.append(a) or launch_g(*a)
    tg.correlate_dot_cuda = lambda *a: dot.append(a) or launch_d(*a)
    try:
        process_chunk(sec, cfg, method="xcorr", device="cuda")
        process_chunk(sec, dot_cfg, method="xcorr", device="cuda")
    finally:
        tg.pack_windows_cuda, tg.correlate_dot_cuda = launch_g, launch_d
    if len(gather) != 2 or len(dot) != 2:
        raise AssertionError(f"expected 2 launches of each kernel, got {len(gather)}, {len(dot)}")
    return gather, dot


def graph_ms(fn, inner: int = 50, replays: int = 10) -> float:
    """Device time per call: ``inner`` calls in one CUDA graph, median of
    ``replays`` timed replays over ``inner`` (chip_smoke.py's device_ms)."""
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
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times)) / inner


def peak_rel(a, ref) -> float:
    a, ref = a.double(), ref.double()
    return float((a - ref).abs().max() / ref.abs().max().clamp(min=1e-300))


def check(kind: str, fn, gather, dot) -> dict:
    """Each build against the plain versions on the path's inputs."""
    from das_diff_veh_tpu_torch.ops import traj_gather as tg

    out = {}
    if kind == "gather":
        for rec, scal, pivot, nwin, wlen, offset in gather:
            k = call_gather(fn, rec, scal, pivot, nwin, wlen, offset)
            p = tg.pack_windows_plain(rec, scal, pivot, nwin, wlen, offset)
            if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
                raise AssertionError("B1 build != plain version")
        return {"equal": True}
    for tier in ("f32", "bf16"):
        gap = 0.0
        for rec, scal, pivot, nwin, wlen, offset, swap, _ in dot:
            k = call_dot(fn, rec, scal, pivot, nwin, wlen, offset, swap, tier)
            p = tg.correlate_dot_plain(rec, scal, pivot, nwin, wlen, offset, swap, tier)
            if tier == "f32" and not torch.equal(k, p):
                raise AssertionError("B2 f32 build != plain version")
            gap = max(gap, peak_rel(k, p))
        if not gap <= BF16_TOL:
            raise AssertionError(f"B2 {tier} build: gap {gap:.3e} to the plain version")
        out[tier] = gap
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gather", action="append", default=[], help="NAME=PATH of a B1 copy")
    ap.add_argument("--dot", action="append", default=[], help="NAME=PATH of a B2 copy")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    csrc = REPO / "das_diff_veh_tpu_torch" / "csrc"
    srcs = {"gather": {"committed": csrc / "traj_gather.cu"},
            "dot": {"committed": csrc / "traj_dot.cu"}}
    for kind in ("gather", "dot"):
        for spec in getattr(args, kind):
            name, path = spec.split("=", 1)
            srcs[kind][name] = Path(path)
    jobs = [(kind, *build(f"{kind}_{name}", path))
            for kind in srcs for name, path in srcs[kind].items()]
    fns = {"gather": {}, "dot": {}}
    for kind, name, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode()}")
        print(f"built {name}:\n{log.decode().strip()}", flush=True)
        fns[kind][name.split("_", 1)[1]] = loaded(lib, kind)
    gather, dot = capture_inputs()
    results = {"device": torch.cuda.get_device_name(0), "gather": {}, "dot": {}}
    for kind in fns:
        for name, fn in fns[kind].items():
            results[kind][name] = {"check": check(kind, fn, gather, dot)}
            print(f"{kind} {name}: checks {results[kind][name]['check']}", flush=True)
    calls = []          # (kind, key, callable): per chunk, then each launch alone
    for name, fn in fns["gather"].items():
        calls.append(("gather", name, lambda fn=fn: [call_gather(fn, *a) for a in gather]))
        calls += [("gather", f"{name}/launch{i}", lambda fn=fn, a=a: call_gather(fn, *a))
                  for i, a in enumerate(gather)]
    for name, fn in fns["dot"].items():
        for tier in ("f32", "bf16"):
            calls.append(("dot", f"{name}/{tier}", lambda fn=fn, tier=tier: [
                call_dot(fn, *a[:7], tier) for a in dot]))
            calls += [("dot", f"{name}/{tier}/launch{i}",
                       lambda fn=fn, tier=tier, a=a: call_dot(fn, *a[:7], tier))
                      for i, a in enumerate(dot)]
    times = {(kind, key): [] for kind, key, _ in calls}
    for r in range(args.rounds):
        for kind, key, fn in (calls if r % 2 == 0 else calls[::-1]):
            times[(kind, key)].append(graph_ms(fn))
    for (kind, key), ts in times.items():
        results[kind].setdefault(key, {})["ms"] = ts
        what = "per launch" if "/launch" in key else "per chunk"
        print(f"{kind} {key}: {what} {float(np.median(ts)):.5f} ms (rounds {ts})", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
