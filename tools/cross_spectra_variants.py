#!/usr/bin/env python3
"""Build variants of kernel B3 (``csrc/cross_spectra.cu``) and time them in
turns on one card at the shapes of the all-pairs path.

    python3 tools/cross_spectra_variants.py [--variant NAME=FLAGS ...]
        [--source NAME=PATH ...] [--rounds N] [--out results.json]

Each ``--variant`` compiles the committed source with extra ``nvcc`` flags
(``-DCS_ALIGN=0``, ``-DCS_TIMING``); each ``--source``
compiles another copy of the kernel, for instance an earlier design kept
outside the package (a source without ``cross_spectra_plan`` is called with
the f32-only argument list of that design).  Every build is checked against
the plain version (``torch.equal``) at edge shapes and on the config-4 inputs
in both tiers, then timed:

- config 4: one launch of 64 source rows against 10000 receivers (7 windows,
  513 frequencies), the inputs of the path's first launch, in both tiers;
- the long record of ``bench.py``'s long-record entry: 64 of 2048 channels x
  61440 samples (119 windows, slabs of 32), f32.

``--variant noalign=-DCS_ALIGN=0`` keeps every segment on the 32-frequency
grid (the layout before the segments were shifted onto the output's sector
grid); a build with ``-DCS_TIMING`` also reports each block's time span
(main blocks and tail-only blocks apart) on the config-4 launch; ``--shapes``
adds config 4 at 512 frequencies (rows on the sector grid) and at the 513th
alone.

Times are CUDA-event medians over groups of back-to-back launches, the
variants in turns (the order reversed every other round), so that they share
the card's clocks.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside the tensor cores (data sheet)
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense (data sheet)
OUT_DIR = REPO / "build" / "variants"
# (m, nall, nwin, nf, win_block or None) of the edge checks
EDGES = ((1, 37, 7, 513, 3), (63, 1001, 7, 513, None), (64, 10000 - 7, 7, 513, None),
         (64, 5, 7, 33, 2), (9, 50, 50, 33, None), (5, 300, 119, 1, None),
         (128, 700, 7, 65, None), (17, 40, 3, 31, 1))


def build(name: str, source: Path, flags: list) -> tuple:
    from das_diff_veh_tpu_torch import kernels

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib = OUT_DIR / f"lib{name}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o", str(lib),
           str(source)]
    return name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


class Launcher:
    """ctypes front of one built variant, with the wrapper's argument list."""

    def __init__(self, lib: Path):
        self.dll = ctypes.CDLL(str(lib))
        self.fn = self.dll.cross_spectra
        self.fn.restype = ctypes.c_int
        self.has_bf16 = hasattr(self.dll, "cross_spectra_plan")
        self.has_times = hasattr(self.dll, "cross_spectra_block_times")
        tail = [ctypes.c_float] + ([ctypes.c_int] if self.has_bf16 else []) + [ctypes.c_void_p]
        self.fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + tail

    def __call__(self, src, rcv, nwin, win_block):
        from das_diff_veh_tpu_torch.ops import cross_spectra as cs

        bf16 = cs.is_bf16_pairs(src)
        m, nf, nall = src.shape[0], src.shape[2], rcv.shape[0]
        out = torch.empty((m, nall, nf), dtype=torch.complex64, device=src.device)
        args = [src.data_ptr(), rcv.data_ptr(), out.data_ptr(), m, nall, nwin, nf,
                win_block, cs._inv(nwin)]
        if self.has_bf16:
            args.append(int(bf16))
        elif bf16:
            raise ValueError("this build has no bf16 tier")
        rc = self.fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out


def event_ms(fn, reps: int, groups: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per = []
    for _ in range(groups):
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        per.append(start.elapsed_time(stop) / reps)
    return float(np.median(per))


def bound_ms(m, nall, nwin, nf, precision):
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs

    t_b = cs.bytes_moved(m, nall, nwin, nf, precision) / HBM_BYTES_PER_S * 1e3
    rate = BF16_OPS_PER_S if precision == "bf16" else FP32_OPS_PER_S
    t_o = cs.flops(m, nall, nwin, nf) / rate * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: the committed source with extra nvcc flags")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH: another copy of the kernel")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="write the results to this JSON file")
    ap.add_argument("--shapes", action="store_true",
                    help="also time config 4 at nf 512 and at nf 1 alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from das_diff_veh_tpu_torch.ops import all_pairs as ap_
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    csrc = REPO / "das_diff_veh_tpu_torch" / "csrc" / "cross_spectra.cu"
    jobs = [build(n, csrc, f.split()) for n, f in
            (v.split("=", 1) for v in (args.variant or ["base="]))]
    jobs += [build(n, Path(p), []) for n, p in (s.split("=", 1) for s in args.source)]
    libs = {}
    for name, lib, proc in jobs:
        out, _ = proc.communicate()
        regs = [ln.strip() for ln in out.decode().splitlines() if "registers" in ln or "spill" in ln]
        print(f"build {name}: rc {proc.returncode}\n  " + "\n  ".join(regs), flush=True)
        if proc.returncode != 0:
            print(out.decode(), flush=True)
            return 1
        libs[name] = Launcher(lib)
    results = {"nvidia_smi": smi, "variants": {n: {} for n in libs}}

    gen = torch.Generator(device="cuda").manual_seed(23)
    for m, nall, nwin, nf, wb in EDGES:
        wb = ap_._resolve_win_block(nwin, wb)
        rcv = torch.randn((nall, nwin, nf), generator=gen, device="cuda", dtype=torch.complex64)
        src = torch.randn((m, nwin, nf), generator=gen, device="cuda", dtype=torch.complex64)
        for tier, (s, r) in (("f32", (src, rcv)),
                             ("bf16", (cs.to_bf16_pairs(src), cs.to_bf16_pairs(rcv)))):
            want = cs.cross_spectra_plain(s, r, nwin, wb)
            for name, fn in libs.items():
                if tier == "bf16" and not fn.has_bf16:
                    continue
                ok = bool(torch.equal(fn(s, r, nwin, wb), want))
                print(f"edge m={m} nall={nall} nwin={nwin} nf={nf} wb={wb} {tier} {name}: "
                      f"equal={ok}", flush=True)
                if not ok:
                    return 1

    t0 = time.perf_counter()
    rec = make_ambient_record(10000, 4096, seed=3)
    wf = ap_._window_spectra(rec, 1024, 0.5)
    src, rcv = wf[:64].contiguous(), wf
    cases = {"config4_f32": (src, rcv, 7, 7),
             "config4_bf16": (cs.to_bf16_pairs(src), cs.to_bf16_pairs(rcv), 7, 7)}
    del rec
    long_rec = make_ambient_record(2048, 61440, seed=3)
    lwf = ap_._window_spectra(long_rec, 1024, 0.5)
    del long_rec
    lwb = ap_._resolve_win_block(lwf.shape[1], None)
    cases["long_record_f32"] = (lwf[:64].contiguous(), lwf, lwf.shape[1], lwb)
    if args.shapes:                      # config 4 without the 513th frequency, and it alone
        cases["config4_nf512_f32"] = (wf[:64, :, :512].contiguous(),
                                      wf[:, :, :512].contiguous(), 7, 7)
        cases["config4_nf1_f32"] = (wf[:64, :, 512:].contiguous(), wf[:, :, 512:].contiguous(),
                                    7, 7)
    print(f"inputs in {time.perf_counter() - t0:.1f} s: long record nwin {lwf.shape[1]}, "
          f"win_block {lwb}", flush=True)
    for case, (s, r, nwin, wb) in cases.items():
        want = cs.cross_spectra_plain(s, r, nwin, wb)
        for name, fn in libs.items():
            if case.endswith("bf16") and not fn.has_bf16:
                continue
            got = fn(s, r, nwin, wb)
            ok = bool(torch.equal(got, want))
            print(f"{case} {name}: equal={ok}", flush=True)
            if not ok:
                return 1
            del got
        del want
        torch.cuda.empty_cache()
    order = list(libs)
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            fn = libs[name]
            for case, (s, r, nwin, wb) in cases.items():
                if case.endswith("bf16") and not fn.has_bf16:
                    continue
                ms = event_ms(lambda: fn(s, r, nwin, wb), reps=5)
                results["variants"][name].setdefault(case, []).append(ms)
                print(f"round {rnd} {name} {case}: {ms:.4f} ms", flush=True)
    for name, fn in libs.items():
        if not fn.has_times:
            continue
        s, r, nwin, wb = cases["config4_f32"]
        plan = [ctypes.c_int() for _ in range(3)]
        fn.dll.cross_spectra_plan(64, r.shape[0], nwin, r.shape[2], *map(ctypes.byref, plan))
        n_main, n_tail = plan[0].value, plan[1].value
        fn(s, r, nwin, wb)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (2 * (n_main + n_tail)))()
        fn.dll.cross_spectra_block_times(buf, n_main + n_tail)
        t = np.array(buf, dtype=np.float64).reshape(-1, 2)
        t0 = t[:, 0].min()
        for label, rows in (("main", t[:n_main]), ("tail", t[n_main:])):
            if len(rows):
                span, start = (rows[:, 1] - rows[:, 0]) / 1e6, (rows[:, 0] - t0) / 1e6
                print(f"{name} config4_f32 {label} blocks ({len(rows)}): span ms min "
                      f"{span.min():.4f} median {np.median(span):.4f} max {span.max():.4f}; "
                      f"start ms max {start.max():.4f}", flush=True)
                results["variants"][name][f"block_span_ms_{label}"] = span.tolist()
    for case, (s, r, nwin, wb) in cases.items():
        m, nall, nf = s.shape[0], r.shape[0], s.shape[2]
        tier = "bf16" if case.endswith("bf16") else "f32"
        b, by = bound_ms(m, nall, nwin, nf, tier)
        results.setdefault("bounds", {})[case] = {"bound_ms": b, "bound_by": by}
        line = ", ".join(f"{n} {min(v[case]):.4f}" for n, v in results["variants"].items()
                         if case in v)
        print(f"{case} (m={m} nall={nall} nwin={nwin} nf={nf} win_block={wb}): best of "
              f"rounds: {line} ms; bound {b:.4f} ms ({by})", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
