"""One run of one cell: set-up, the measured window, the check, the line.

The result is the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number that
decided ``correct`` beside its limit.  The same numbers end standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from harness.spec import Spec, load_spec, metric_reader, system_adapter
from harness.trace import DeviceProfile

FORBIDDEN = ("jax", "jaxlib", "flax", "das_diff_veh_tpu")
PROGRAM = "das_diff_veh_tpu_torch"


@dataclass
class Check:
    """One number compared: ``value`` must not exceed ``limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Window:
    """What a system adapter's window returns."""

    end_to_end: dict                    # metric name -> value
    attempted: int
    failed: int
    readings: object = None             # harness.trace.Readings
    outputs: dict = field(default_factory=dict)   # for the check


@dataclass
class Context:
    root: Path
    spec: Spec
    seed: int
    seconds: float
    trace: bool
    device: object = None
    state: dict = field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.spec.config

    @property
    def traffic(self) -> dict:
        return self.spec.traffic

    def note(self, msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``das_diff_veh_tpu_torch`` is not ``das_diff_veh_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def per_layer_metrics(spec: Spec, readings) -> dict:
    out = {}
    for m in spec.per_layer():
        value = metric_reader(m["name"])(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list, breakdown: dict | None = None) -> str:
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return json.dumps(line)


def main(argv, root: Path, t_start: float) -> int:
    args = parse(argv)
    try:
        spec = load_spec(root, args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 2
    import torch

    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    if not (Path(root) / PROGRAM).is_dir():
        print(f"[bench] the program {PROGRAM} is not in {root}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    rc, line = run_cell(Path(root), spec, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), t_start)
    if line is not None:
        print(line, flush=True)
    return rc


def run_cell(root: Path, spec: Spec, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> tuple:
    """Set up, measure, check: ``(exit code, result line or None)``.  The
    look for a card is the caller's; ``device`` may be the CPU in tests,
    which then report no device numbers."""
    import torch

    chips = int(spec.cell["chips"])
    on_card = device.type == "cuda"
    system = system_adapter(spec.config["system"])
    ctx = Context(root=Path(root), spec=spec, seed=seed, seconds=seconds, trace=trace,
                  device=device)
    system.setup(ctx)
    if trace:
        DeviceProfile.warm()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    ctx.note(f"set-up {setup_s:.3f} s")

    win = system.window(ctx)
    if on_card:
        torch.cuda.synchronize()
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, "cpu"
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": chips,
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if ctx.trace:
        dev = win.readings.device
        if dev is None or dev.busy_s <= 0:
            print("[bench] the traced run saw no device activity", file=sys.stderr)
            return 5, None
        device_info["busy_s"] = dev.busy_s
        device_info["window_s"] = dev.window_s
        breakdown = {"device_ops": dev.top_ops(10), "idle_gaps": dev.gaps[:10]}
        metrics = per_layer_metrics(spec, win.readings)
    else:
        values = dict(win.end_to_end, setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in spec.end_to_end()}

    system.release(ctx)
    checks = system.check(ctx, win)
    found = loaded_forbidden()
    if found:
        print(f"[bench] loaded modules that must not be: {found}", file=sys.stderr)
        return 4, None
    correct = win.failed == 0 and all(c.ok for c in checks)
    for c in checks:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(f"correct {correct}: {win.attempted} attempted, {win.failed} failed",
          file=sys.stderr, flush=True)
    return 0, result_line(correct, win.attempted, win.failed, metrics, device_info, checks,
                          breakdown)
