"""Loading a cell's specification by name."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Spec:
    """One cell: its ``BENCHMARK.json`` entry, configuration and traffic."""

    cell: dict
    config: dict
    traffic: dict
    benchmark: dict

    @property
    def name(self) -> str:
        return self.cell["name"]

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports (``setup_s`` among them)."""
        return [m for m in self.benchmark["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list that move an end-to-end metric it reports."""
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.benchmark["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path, workload: str, bench_dir: Path = BENCH_DIR) -> Spec:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its config and
    traffic files from ``bench_dir``.  Raises ``KeyError`` for an unknown cell."""
    bench = load_json(Path(root) / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json (cells: {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(Path(root) / configs[cell["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    return Spec(cell=cell, config=config, traffic=traffic, benchmark=bench)


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module called ``name`` (file names may
    hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    return load_module(bench_dir / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_")).read


def system_adapter(system: str, bench_dir: Path = BENCH_DIR):
    """The module ``harness/systems/<system>.py``."""
    return load_module(bench_dir / "harness" / "systems" / f"{system}.py",
                       "bench_system_" + system)
