"""CPU tests of the benchmark harness.

    python -m pytest benchmark/tests -q

They run the harness on the CPU at small sizes (the program's kernels run
their plain versions there); the tests that need the card carry the
``cuda`` marker and skip without one.
"""

import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))

from harness.main import Check, result_line, run_cell  # noqa: E402
from harness.spec import load_spec, metric_reader, system_adapter  # noqa: E402
from harness.trace import DeviceSummary, Readings  # noqa: E402


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_new_pieces_are_found_by_name(tmp_path):
    """A new cell, configuration, traffic mix and per-layer metric are
    files of their own; the harness takes them with no file edited but
    BENCHMARK.json, to which the cell is appended."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "vehicle_700m.json").read_text())
    cfg.update(name="vehicle_600m", pivot_m=600.0)
    (tmp_path / "benchmark" / "configs" / "vehicle_600m.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark" / "traffic" / "day_folder_deep.json").write_text(
        json.dumps({"driver": "directory", "files_per_day": 720, "pool": 8,
                    "chunks_per_s": 6.5, "prefetch_depth": 4, "warm_chunks": 2}))
    (tmp_path / "benchmark" / "metrics" / "chunks_seen.py").write_text(
        "def read(r):\n    return r.units or None\n")
    bench["configs"].append({"name": "vehicle_600m", "source": "test", "reduced": [],
                             "file": "benchmark/configs/vehicle_600m.json", "why": "test"})
    bench["workloads"].append({"name": "imaging_600m", "config": "vehicle_600m",
                               "traffic": "day_folder_deep", "chips": 1, "why": "test"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "chunks_per_s")["workloads"].append("imaging_600m")
    bench["per_layer"].append({"name": "chunks_seen", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "chunks_per_s", "workloads": ["imaging_600m"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = load_spec(tmp_path, "imaging_600m", bench_dir=tmp_path / "benchmark")
    assert spec.config["pivot_m"] == 600.0 and spec.traffic["prefetch_depth"] == 4
    assert [m["name"] for m in spec.end_to_end()] == ["chunks_per_s", "setup_s"]
    assert [m["name"] for m in spec.per_layer()] == ["chunks_seen"]
    read = metric_reader("chunks_seen", bench_dir=tmp_path / "benchmark")
    assert read(Readings(units=3)) == 3
    assert system_adapter("imaging", bench_dir=tmp_path / "benchmark").setup


def test_every_cell_resolves_and_every_metric_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        spec = load_spec(ROOT, cell["name"])
        names = [m["name"] for m in spec.end_to_end()]
        assert "setup_s" in names and len(names) >= 2
        assert spec.per_layer()
        system_adapter(spec.config["system"])
    for m in bench["per_layer"]:
        assert callable(metric_reader(m["name"]))


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_carries_only_the_contract_keys(trace):
    line = json.loads(result_line(
        True, 3, 0, {"chunks_per_s": {"value": 6.5, "unit": "chunks/s"}},
        {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1},
        [Check("image_rel_gap", 1e-7, 1e-5)],
        {"device_ops": [], "idle_gaps": []} if trace else None))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == want + (["breakdown"] if trace else []) + ["checks"]
    assert line["checks"] == {"image_rel_gap": {"value": 1e-7, "limit": 1e-5}}


def test_batch_readers():
    dev = DeviceSummary(busy_s=1.0, window_s=4.0, kernel_s={"k": 1.0}, gaps=[])
    spans = [{"name": n, "ts": 0.0, "dur": d * 1e3, "tid": 1, "args": {}}
             for n, d in [("read", 40.0), ("preprocess", 70.0), ("device_put", 10.0),
                          ("input_wait", 90.0), ("compute", 45.0)] for _ in range(4)]
    r = Readings(spans=spans, device=dev, units=4, profiled_units=4)
    assert metric_reader("device_idle_pct.batch")(r) == pytest.approx(75.0)
    assert metric_reader("loader_ms_per_chunk")(r) == pytest.approx(120.0)
    assert metric_reader("input_wait_ms_per_chunk")(r) == pytest.approx(90.0)
    assert metric_reader("compute_ms_per_chunk.batch")(r) == pytest.approx(45.0)
    assert metric_reader("device_idle_pct.batch")(Readings()) is None


@pytest.mark.parametrize("elapsed,done,want", [(0.0, 0, 333), (10.0, 70, 288),
                                               (50.0, 300, 7), (52.0, 330, 1)])
def test_one_directory_call_fills_the_window(elapsed, done, want):
    """The first call is sized from the traffic file's rate to fill the
    window; a later one, from the rate seen, to fill what is left."""
    from harness.systems import imaging

    tr = {"chunks_per_s": 6.5, "files_per_day": 720}
    assert imaging._call_size(tr, 51.0, elapsed, done) == want


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "das_diff_veh_tpu"}
    for path in BENCH.rglob("*.py"):
        assert not (_imports(path) & bad), path
    for path in (BENCH / "reference").rglob("*.py"):
        assert "das_diff_veh_tpu_torch" not in _imports(path), path
        assert "harness" not in _imports(path), path


def test_a_run_loads_no_jax():
    """Every module a run of each cell loads, the program's among them,
    leaves ``jax`` and ``das_diff_veh_tpu`` out of ``sys.modules``."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from harness.main import loaded_forbidden\n"
        "from harness.spec import system_adapter, metric_reader\n"
        "import json\n"
        "b = json.load(open(%r))\n"
        "[metric_reader(m['name']) for m in b['per_layer']]\n"
        "system_adapter('imaging')\n"
        "import reference.imaging.chain\n"
        "import das_diff_veh_tpu_torch.pipeline.workflow, das_diff_veh_tpu_torch.serve\n"
        "import das_diff_veh_tpu_torch.serve.imaging\n"
        "print(json.dumps(loaded_forbidden()))\n"
        % (str(BENCH), str(ROOT), str(ROOT / "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_imaging_reference_agrees_with_the_port_on_the_cpu():
    from das_diff_veh_tpu_torch import config as C
    from das_diff_veh_tpu_torch.core.section import DasSection
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk
    from harness.synth import vehicle_chunk
    from reference.imaging import chain
    from reference.imaging import config as RC

    cfg = json.loads((BENCH / "configs" / "vehicle_700m.json").read_text())
    ad = system_adapter("imaging")
    data = vehicle_chunk(cfg, 7, 0, "cpu")
    x = 400.0 + np.arange(140)
    t = np.arange(30000) / 250.0
    ref_img, ref_n = chain.image_chunk(data, x, t, ad.pipeline_config(cfg, RC), True, "cpu")
    pcfg = ad.pipeline_config(cfg, C).replace(chunk_pipeline="staged")
    got = process_chunk(DasSection(torch.from_numpy(data), torch.from_numpy(x),
                                   torch.from_numpy(t)), pcfg, x_is_channels=True,
                        device="cpu")
    assert got.n_windows == ref_n and ref_n > 0
    np.testing.assert_allclose(got.disp_image.numpy(), ref_img, rtol=0, atol=1e-9)


def _small(cell: str, **over):
    spec = load_spec(ROOT, cell)
    # scipy 1.17 computes savgol(21, 15) wrongly (PERF.md), so no pre-smooth;
    # on the CPU the batch path computes in the files' float64, against a
    # float64 reference
    spec.config.update(savgol=False, limits={"count_mismatches": 0, "image_rel_gap": 1e-3})
    spec.traffic.update(over)
    return spec


def _run(spec, seconds=1.0, seed=2**33 + 9):
    rc, line = run_cell(ROOT, spec, seed, seconds, False, torch.device("cpu"),
                        time.perf_counter())
    assert rc == 0
    return json.loads(line)


IMAGING_SMALL = {"files_per_day": 4, "pool": 2, "chunks_per_s": 0.1, "warm_chunks": 1}
IMAGING_SEED = 7         # its pool's chunk 0 isolates vehicles without the pre-smooth


def _altered_image(monkeypatch):
    from das_diff_veh_tpu_torch.pipeline import workflow

    real = workflow.pull_count_and_image

    def altered(n, image):
        n, img = real(n, image)
        return n, img * np.float32(1.01)

    monkeypatch.setattr(workflow, "pull_count_and_image", altered)


def _half_the_stack(monkeypatch):
    from das_diff_veh_tpu_torch.models import vsg

    real = vsg.stack_gathers

    def half(gathers, valid):
        keep = valid & (torch.cumsum(valid.long(), 0) <= (valid.sum() + 1) // 2)
        return real(gathers, keep)

    monkeypatch.setattr(vsg, "stack_gathers", half)


@pytest.mark.parametrize("fault", [None, _altered_image, _half_the_stack],
                         ids=["sound", "answer_altered", "half_the_windows"])
def test_imaging_batch_on_the_cpu(monkeypatch, fault):
    from das_diff_veh_tpu_torch.pipeline import fused

    fused.clear_programs()
    if fault is not None:
        fault(monkeypatch)
    line = _run(_small("imaging_batch", **IMAGING_SMALL), seed=IMAGING_SEED)
    fused.clear_programs()
    assert line["checks"]["images_compared_short"]["value"] == 0.0
    assert line["correct"] is (fault is None)


@pytest.mark.parametrize("fault", [None, _altered_image, _half_the_stack],
                         ids=["sound", "answer_altered", "half_the_windows"])
def test_imaging_serve_on_the_cpu(monkeypatch, fault):
    from das_diff_veh_tpu_torch.pipeline import fused

    fused.clear_programs()
    if fault is not None:
        fault(monkeypatch)
    spec = _small("imaging_serve_overload", rate_per_s=3.0, pool=2)
    line = _run(spec, seconds=2.0, seed=IMAGING_SEED)
    fused.clear_programs()
    assert set(line["metrics"]) == {"requests_per_s", "setup_s"}
    assert line["failed"] == 0 and line["attempted"] == 6
    assert line["checks"]["images_compared_short"]["value"] == 0.0
    assert line["correct"] is (fault is None)
