"""CPU tests of the ambient day-stack cell (``allpairs_record``): the cell
resolves, its readers read, its adapter runs at a small size on the CPU and
is ``correct``, and three planted faults fail its check: a record dropped
from the stack, the band shifted by one receiver, and the bf16 control.

    python -m pytest benchmark/tests/test_bench_ambient.py -q
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))

from harness import band_lag_add_counts as LC  # noqa: E402
from harness import cross_spectra_counts as CC  # noqa: E402
from harness.main import Context, Window, run_cell  # noqa: E402
from harness.spec import load_spec, metric_reader, system_adapter  # noqa: E402
from harness.trace import DeviceSummary, Readings  # noqa: E402

CELL = "allpairs_record"
METRICS = ("stage_ms_per_record.allpairs", "compute_ms_per_record.allpairs",
           "input_wait_ms_per_chunk", "cross_device_ms_per_record.allpairs",
           "finish_device_ms_per_record.allpairs", "device_idle_pct.allpairs",
           "cross_spectra_band_roofline", "band_lag_add_roofline")
SMALL = {"channels": 93, "record_s": 3.0, "wlen": 256, "band_hz": [20.0, 300.0],
         "max_offset": 20, "max_lag": 50, "src_chunk": 16, "wave_band_hz": [20.0, 200.0]}
SEED = 2**33 + 9


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _small():
    spec = load_spec(ROOT, CELL)
    spec.config.update(SMALL)
    spec.traffic.update(records_per_s=20.0)
    return spec


def test_the_cell_resolves_with_its_metrics():
    spec = load_spec(ROOT, CELL)
    assert spec.config["system"] == "ambient" and spec.config["reduced"] == []
    assert [m["name"] for m in spec.end_to_end()] == ["chunks_per_s", "setup_s"]
    assert sorted(m["name"] for m in spec.per_layer()) == sorted(METRICS)
    for name in METRICS:
        assert callable(metric_reader(name))
    assert system_adapter("ambient").control_outputs
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in bench["workloads"] if c["name"] == CELL)
    assert cell["chips"] == 1 and len(cell["why"]) <= 200


def test_the_readers():
    dev = DeviceSummary(busy_s=0.9, window_s=1.0, gaps=[],
                        kernel_s={"void cross_spectra_kernel<float2, true, true>(...)": 0.6,
                                  "void band_lag_add_kernel<256, float2 const>(...)": 0.15,
                                  "regular_fft": 0.2})
    spans = [{"name": n, "ts": 0.0, "dur": d * 1e3, "tid": 2, "args": {}}
             for n, d in [("ambient_stage", 150.0), ("ambient_stage", 170.0),
                          ("compute", 190.0), ("compute", 194.0), ("input_wait", 1.5)]]
    r = Readings(spans=spans, device=dev, units=10, profiled_units=3,
                 config=load_spec(ROOT, CELL).config)
    r.device_spans = [{"name": n, "ts": 0.0, "dur": d * 1e3, "tid": 1, "args": {"record": k}}
                      for k, n, d in [(0, "ambient_finish", 1.0), (0, "ambient_finish", 2.0),
                                      (1, "ambient_finish", 5.0), (1, "ambient_cross", 9.0)]]
    read = {n: metric_reader(n) for n in METRICS}
    assert read["stage_ms_per_record.allpairs"](r) == pytest.approx(160.0)
    assert read["compute_ms_per_record.allpairs"](r) == pytest.approx(192.0)
    assert read["input_wait_ms_per_chunk"](r) == pytest.approx(0.75)
    assert read["cross_device_ms_per_record.allpairs"](r) == pytest.approx(200.0)
    assert read["finish_device_ms_per_record.allpairs"](r) == pytest.approx(4.0)
    assert read["device_idle_pct.allpairs"](r) == pytest.approx(10.0)
    bound = CC.record_bound_s(r.config)
    assert read["cross_spectra_band_roofline"](r) == pytest.approx(100.0 * bound / 0.2)
    bound = LC.record_bound_s(r.config)
    assert read["band_lag_add_roofline"](r) == pytest.approx(100.0 * bound / 0.05)
    r.device = DeviceSummary(busy_s=0.9, window_s=1.0, gaps=[], kernel_s={"regular_fft": 0.2})
    assert read["band_lag_add_roofline"](r) is None     # the irfft finish: no B5
    for name in METRICS:        # a run without the day stack reads nothing
        assert read[name](Readings()) is None


def test_b3_counts_of_the_dash_record():
    """137 launches a record, the last of 17 sources; B3 is counted over the
    whitening band's 196 bins and the 38,464 pairs within 300 m of a full
    launch (of its 64 x 664 rows); a full launch is bound by its bytes
    (73.85 MB, 0.022 ms, against 0.012 ms of operations), and the record's
    bound is about 3 ms."""
    cfg = load_spec(ROOT, CELL).config
    assert CC.band_bins(cfg) == (9, 204)
    nwin, nb = CC.record_shape(cfg)
    assert (nwin, nb) == (13, 196)
    shapes = CC.launches(8721, 64, 300)
    assert len(shapes) == 137 and shapes[5] == (64, 664, 38464)
    assert shapes[0] == (64, 364, sum(range(301, 365)))
    assert shapes[-1] == (17, 317, sum(range(301, 318)))
    assert sum(p for _, _, p in shapes) == 8721 * 601 - 300 * 301   # the ends' missing pairs
    assert CC.bytes_moved(664, 38464, nwin, nb) == 73_846_528
    assert CC.bound_s(664, 38464, nwin, nb) == pytest.approx(2.2044e-5, rel=1e-3)
    assert CC.flops(38464, nwin, nb) / CC.PEAK_FLOPS == pytest.approx(1.170e-5, rel=2e-3)
    assert 0.0025 < CC.record_bound_s(cfg) < 0.0035


def test_an_unwhitened_configuration_counts_every_bin():
    cfg = dict(load_spec(ROOT, CELL).config, whiten=False)
    assert CC.band_bins(cfg) == (0, 2048)
    assert CC.record_shape(cfg) == (13, 4096 // 2 + 1)


def test_b5_counts_of_the_dash_record():
    """A full launch moves the 38,464 pairs' 196 bins and their 2001-lag
    stack rows read and written: 676.0 MB, 0.2018 ms, against 4.88 GFLOP
    (0.073 ms); the record's 5,151,021 pairs are bound at about 27 ms."""
    cfg = load_spec(ROOT, CELL).config
    assert LC.bytes_moved(38464, 196, 1000) == 676_043_264
    assert LC.bound_s(38464, 196, 4096, 1000) == pytest.approx(2.018e-4, rel=1e-2)
    assert LC.flops(38464, 4096, 1000) == pytest.approx(4.880e9, rel=1e-3)
    assert LC.record_bound_s(cfg) == pytest.approx(
        5_151_021 * (8 * 196 + 8 * 2001) / LC.PEAK_BYTES_PER_S)
    assert 0.026 < LC.record_bound_s(cfg) < 0.028


def test_check_sources_hold_the_chunk_edges():
    ad = system_adapter("ambient")
    cfg = load_spec(ROOT, CELL).config
    s = ad.check_sources(cfg, 16, SEED)
    assert len(s) == len(set(s)) == 16 and {0, 63, 64, 8704, 8720} <= set(s)
    assert s == ad.check_sources(cfg, 16, SEED) != ad.check_sources(cfg, 16, SEED + 1)


def _run(monkeypatch=None, fault=None):
    if fault is not None:
        fault(monkeypatch)
    rc, line = run_cell(ROOT, _small(), SEED, 1.0, False, torch.device("cpu"),
                        time.perf_counter())
    assert rc == 0
    return json.loads(line)


def _drop_a_record(monkeypatch):
    """The program counts every record but leaves the third out of the sum."""
    from das_diff_veh_tpu_torch.pipeline import ambient

    real, calls = ambient.add_banded, []

    def dropped(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            return
        return real(*a, **kw)

    monkeypatch.setattr(ambient, "add_banded", dropped)


def _shift_the_band(monkeypatch):
    """Every source's receivers taken one row off."""
    from das_diff_veh_tpu_torch.ops import all_pairs

    real = all_pairs._banded_finish

    def shifted(cross, *a, **kw):
        return real(torch.roll(cross, 1, dims=1), *a, **kw)

    monkeypatch.setattr(all_pairs, "_banded_finish", shifted)


@pytest.mark.parametrize("fault", [None, _drop_a_record, _shift_the_band],
                         ids=["sound", "record_dropped", "band_shifted"])
def test_the_cell_on_the_cpu(monkeypatch, fault):
    line = _run(monkeypatch, fault)
    assert set(line["metrics"]) == {"chunks_per_s", "setup_s"}
    assert line["failed"] == 0 and line["attempted"] >= 3
    assert line["checks"]["records_mismatch"]["value"] == 0.0
    assert line["checks"]["sources_compared_short"]["value"] == 0.0
    assert line["correct"] is (fault is None)
    if fault is not None:
        assert line["checks"]["ncf_rel_gap"]["value"] > 1e-3


def test_the_bf16_control_fails_on_the_cpu():
    spec = _small()
    system = system_adapter("ambient")
    ctx = Context(root=ROOT, spec=spec, seed=SEED, seconds=1.0, trace=False,
                  device=torch.device("cpu"))
    system.setup(ctx)
    system.release(ctx)
    checks = {c.name: c for c in system.check(ctx, Window({}, 0, 0,
                                                         outputs=system.control_outputs(ctx)))}
    assert checks["records_mismatch"].ok and not checks["ncf_rel_gap"].ok


def test_a_run_of_the_cell_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from harness.main import loaded_forbidden\n"
        "from harness.spec import system_adapter, metric_reader\n"
        "import json\n"
        "[metric_reader(m) for m in %r]\n"
        "system_adapter('ambient')\n"
        "import reference.ambient.ncf, harness.noise_records\n"
        "import das_diff_veh_tpu_torch.pipeline.ambient\n"
        "print(json.dumps(loaded_forbidden()))\n"
        % (str(BENCH), str(ROOT), list(METRICS)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
