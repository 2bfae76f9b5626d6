#!/usr/bin/env python3
"""Where kernel B2 (``csrc/traj_dot.cu``) spends a launch, block by block, on
one card.

    python3 tools/traj_dot_probe.py [--out results.json]

Builds an instrumented copy of the committed source under ``build/probe/``
(the source itself is not changed): each block records its SM (``%smid``),
``%globaltimer`` at its start, after the first group's staging, after the
first group's compute and at its end, and its ``clock64`` ticks.  The copy
runs on the dot chunk's two launches (the inputs ``chip_smoke.py`` times,
captured from ``process_chunk`` as ``tools/traj_kernels_variants.py`` does)
in both tiers, after warm-up calls, and the script prints per launch: the
span, the start skew (blocks that waited for a free SM), blocks per SM, the
median block's phases (SMs are shared, so a phase includes waiting for
other blocks' warps), when each SM finished, and the SM clock (ticks over
time).  It also prints the instruction mix of the f32 tier's innermost loop
from ``cuobjdump -sass`` of the copy.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

OUT_DIR = REPO / "build" / "probe"
SOURCE = REPO / "das_diff_veh_tpu_torch" / "csrc" / "traj_dot.cu"
MAX_BLOCKS = 65536
# (anchor in the committed source, text that replaces it)
EDITS = (
    ("namespace {\n", "__device__ unsigned long long g_probe[%d * 6];\n"
     "__device__ __forceinline__ unsigned long long probe_time() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %%0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\nnamespace {\n" % MAX_BLOCKS),
    ("  const int b = bk / nk;\n",
     "  const int b = bk / nk;\n"
     "  unsigned long long t0 = probe_time(), t1 = 0, t2 = 0;\n"
     "  const long long c0 = clock64();\n"),
    ("    stage<kBf16>(slots, l, src, rcv, w0, gc, wlen, offset);\n    __syncthreads();\n",
     "    stage<kBf16>(slots, l, src, rcv, w0, gc, wlen, offset);\n    __syncthreads();\n"
     "    if (!t1) t1 = probe_time();\n"),
    ("    __syncthreads();\n    for (int lag = tid; lag < wlen; lag += nthr) {   // ascending w",
     "    __syncthreads();\n    if (!t2) t2 = probe_time();\n"
     "    for (int lag = tid; lag < wlen; lag += nthr) {   // ascending w"),
    ("    dst[at] = __fdiv_rn(tot[lag], denom);\n  }\n}\n",
     "    dst[at] = __fdiv_rn(tot[lag], denom);\n  }\n  __syncthreads();\n"
     "  if (tid == 0 && blockIdx.x < %d) {\n"
     "    unsigned smid;\n"
     "    asm volatile(\"mov.u32 %%0, %%smid;\" : \"=r\"(smid));\n"
     "    unsigned long long* p = g_probe + 6 * blockIdx.x;\n"
     "    p[0] = smid; p[1] = t0; p[2] = t1; p[3] = t2; p[4] = probe_time();\n"
     "    p[5] = clock64() - c0;\n  }\n}\n" % MAX_BLOCKS),
)
READER = """
extern "C" int traj_dot_probe_read(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_probe, sizeof(unsigned long long) * 6 * n);
}
"""


def instrumented() -> Path:
    src = SOURCE.read_text()
    for anchor, text in EDITS:
        if src.count(anchor) < 1:
            raise RuntimeError(f"anchor not found in {SOURCE.name}: {anchor!r}")
        src = src.replace(anchor, text, 1)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / "traj_dot_probe.cu"
    path.write_text(src + READER)
    return path


def build(path: Path) -> Path:
    from das_diff_veh_tpu_torch import kernels

    lib = OUT_DIR / "libtraj_dot_probe.so"
    out = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(path)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    return lib


def loop_mix(lib: Path) -> dict:
    """Instruction mix of the f32 kernel's innermost loop: the smallest
    body of a backward branch that holds FMUL and no barrier."""
    try:
        sass = subprocess.run(["cuobjdump", "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as err:
        return {"error": str(err)}
    func = next((f for f in re.split(r"\n\s*Function : ", sass)
                 if "traj_dot_kernelILb0" in f.split("\n")[0]), "")
    rows = [re.match(r"\s*/\*([0-9a-f]{4,5})\*/\s*(.*?)\s*;", line) for line in func.split("\n")]
    rows = [(int(m.group(1), 16), m.group(2)) for m in rows if m]
    best = None
    for at, text in rows:
        target = re.search(r"BRA\s.*?0x([0-9a-f]+)", text)
        if target and int(target.group(1), 16) < at:
            body = [t for a, t in rows if int(target.group(1), 16) <= a <= at]
            ops = Counter(t.split()[1 if t.startswith("@") else 0].split(".")[0] for t in body)
            if ops["FMUL"] and (best is None or len(body) < best[0]) and not ops["BAR"]:
                best = (len(body), dict(ops))
    return {"instructions": best[0], "mix": best[1]} if best else {"error": "no loop found"}


def summary(p: np.ndarray) -> dict:
    sm, t0, t1, t2, t3, ticks = p.T
    base = t0.min()
    per_sm = np.bincount(sm, minlength=int(sm.max()) + 1)
    ends = np.array([(t3[sm == s].max() - base) / 1e3 for s in np.unique(sm)])
    out = {"blocks": int(len(sm)), "span_us": float((t3.max() - base) / 1e3),
           "start_skew_us": float((t0.max() - base) / 1e3),
           "blocks_per_sm": [int(per_sm[per_sm > 0].min()), int(per_sm.max())],
           "sm_end_us": [float(ends.min()), float(np.median(ends)), float(ends.max())],
           "block_us_median": float(np.median(t3 - t0) / 1e3),
           "clock_ghz": float(np.median(ticks / (t3 - t0)))}
    worked = t1 > 0
    if worked.any():
        out["phases_us_median"] = {
            "scalars_and_staging": float(np.median((t1 - t0)[worked]) / 1e3),
            "compute": float(np.median((t2 - t1)[worked]) / 1e3),
            "window_sum_and_output": float(np.median((t3 - t2)[worked]) / 1e3)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import traj_kernels_variants as variants

    lib = build(instrumented())
    fn = variants.loaded(lib, "dot")
    read = ctypes.CDLL(str(lib)).traj_dot_probe_read
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _, dot = variants.capture_inputs()
    results = {"device": torch.cuda.get_device_name(0), "loop": loop_mix(lib)}
    print(f"f32 innermost loop: {results['loop']}", flush=True)
    for tier in ("f32", "bf16"):
        for i, a in enumerate(dot):
            for _ in range(3):
                variants.call_dot(fn, *a[:7], tier)
            torch.cuda.synchronize()
            n = min(a[1].shape[0] * a[1].shape[1], MAX_BLOCKS)
            buf = np.zeros(6 * n, dtype=np.uint64)
            if read(buf.ctypes.data, n):
                raise RuntimeError("reading the probe buffer failed")
            res = summary(buf.reshape(n, 6).astype(np.int64))
            results[f"{tier}/launch{i}"] = res
            print(f"{tier} launch{i}: {json.dumps(res)}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
