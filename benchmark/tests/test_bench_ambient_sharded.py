"""CPU tests of the day stack split over cards (``allpairs_500m_4chip``):
the cell resolves on four chips through its own adapter, its three readers
read known values, the adapter runs at a small size over four CPU shards and
is ``correct`` with every shard's edge rows among the checked sources, a
stack that drops a shard's last row fails the check, and a program whose
``DayStack`` takes no ``devices`` fails at once.

    python -m pytest benchmark/tests/test_bench_ambient_sharded.py -q
"""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))

from harness.main import Context, Window, run_cell  # noqa: E402
from harness.spec import load_spec, metric_reader, system_adapter  # noqa: E402
from harness.trace import Readings  # noqa: E402

CELL = "allpairs_500m_4chip"
METRICS = ("scatter_device_ms_per_record.allpairs4", "card_skew_pct.allpairs4",
           "peer_mb_per_record.allpairs4")
# 7 chunks of 16 sources over 4 CPU shards: uneven blocks, the last chunk ragged
SMALL = {"channels": 101, "record_s": 3.0, "wlen": 256, "band_hz": [20.0, 300.0],
         "max_offset": 20, "max_lag": 50, "src_chunk": 16, "wave_band_hz": [20.0, 200.0]}
SEED = 2**33 + 11


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


def test_the_cell_resolves_on_four_chips_with_its_metrics():
    spec = load_spec(ROOT, CELL)
    assert spec.cell["chips"] == 4 == spec.config["cards"]
    assert spec.config["system"] == "ambient_sharded" and spec.config["reduced"] == []
    assert (spec.config["max_offset"], spec.config["max_lag"]) == (500, 2000)
    assert [m["name"] for m in spec.end_to_end()] == ["chunks_per_s", "setup_s"]
    assert sorted(m["name"] for m in spec.per_layer()) == sorted(METRICS)
    for name in METRICS:
        assert callable(metric_reader(name))
    base = load_spec(ROOT, "allpairs_record").config
    differ = {k for k in set(base) | set(spec.config) if base.get(k) != spec.config.get(k)}
    assert differ == {"name", "system", "deployment", "max_offset", "max_lag", "cards",
                      "assumed"}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in bench["workloads"] if c["name"] == CELL)
    assert len(cell["why"]) <= 200 and spec.traffic == load_spec(ROOT, "allpairs_record").traffic


def _span(name, dur_ms, **args):
    return {"name": name, "ts": 0.0, "dur": dur_ms * 1e3, "tid": 1, "args": args}


def test_the_readers():
    r = Readings(spans=[_span("ambient_scatter", 0.5, record=0, bytes=150_000_000),
                        _span("ambient_scatter", 0.5, record=1, bytes=250_000_000),
                        _span("compute", 90.0, record=0)])
    r.device_spans = [_span("ambient_scatter", 0.4, record=0, card=1),
                      _span("ambient_scatter", 0.6, record=0, card=2),
                      _span("ambient_scatter", 1.0, record=1, card=1),
                      # record 0: cards at 90, 110, 100, 100 ms; record 1: 100, 100
                      _span("ambient_cross", 50.0, record=0, card=0),
                      _span("ambient_finish", 40.0, record=0, card=0),
                      _span("ambient_cross", 70.0, record=0, card=1),
                      _span("ambient_finish", 40.0, record=0, card=1),
                      _span("ambient_cross", 100.0, record=0, card=2),
                      _span("ambient_finish", 100.0, record=0, card=3),
                      _span("ambient_cross", 100.0, record=1, card=0),
                      _span("ambient_finish", 100.0, record=1, card=1),
                      _span("ambient_spectra", 500.0, record=1)]
    read = {n: metric_reader(n) for n in METRICS}
    assert read["scatter_device_ms_per_record.allpairs4"](r) == pytest.approx(1.0)
    assert read["card_skew_pct.allpairs4"](r) == pytest.approx((10.0 + 0.0) / 2)
    assert read["peer_mb_per_record.allpairs4"](r) == pytest.approx(200.0)
    # one card: blocks without another card's to compare with read nothing
    r.device_spans = [_span("ambient_cross", 5.0, record=0, card=0)]
    assert read["card_skew_pct.allpairs4"](r) is None
    for name in METRICS:        # a run of a stack on one card, or none, reads nothing
        assert read[name](Readings()) is None


def _run(monkeypatch=None, fault=None):
    if fault is not None:
        fault(monkeypatch)
    rc, line = run_cell(ROOT, _small(), SEED, 1.0, False, torch.device("cpu"),
                        time.perf_counter())
    assert rc == 0
    return json.loads(line)


def _drop_a_shard_last_row(monkeypatch):
    """Each record leaves the second shard's last row out of the sum: the
    row is put back as it was before the record's chunks."""
    from das_diff_veh_tpu_torch.pipeline import ambient

    real = ambient.add_banded

    def dropped(wf, shards, *a, **kw):
        row = shards[1].out[-1]
        keep = row.clone()
        real(wf, shards, *a, **kw)
        row.copy_(keep)

    monkeypatch.setattr(ambient, "add_banded", dropped)


@pytest.mark.parametrize("fault", [None, _drop_a_shard_last_row],
                         ids=["sound", "shard_last_row_dropped"])
def test_the_cell_on_the_cpu_over_four_shards(monkeypatch, fault, capfd):
    line = _run(monkeypatch, fault)
    assert set(line["metrics"]) == {"chunks_per_s", "setup_s"}
    assert line["failed"] == 0 and line["attempted"] >= 3
    assert line["checks"]["records_mismatch"]["value"] == 0.0
    assert line["checks"]["sources_compared_short"]["value"] == 0.0
    assert line["correct"] is (fault is None)
    if fault is not None:
        assert line["checks"]["ncf_rel_gap"]["value"] > 1e-3
    err = capfd.readouterr().err
    assert "stack over 4 cards" in err and "checked sources" in err


def test_the_puts_are_read_from_the_staged_counter():
    """``staged`` carries a running total that each ``stack_records`` call
    begins anew; the adapter keeps each put's bytes and hands every counter
    on."""
    from harness.trace import MemTracer

    seen = []
    tracer = MemTracer(record_spans=False, on_counter=lambda name, values: seen.append(name))
    puts = system_adapter("ambient_sharded").count_puts(tracer)
    for total in (10, 20, 30, 10, 20):
        tracer.counter("staged", bytes=total, slabs=1)
    tracer.counter("ambient_records", total=1)
    assert puts == [10] * 5 and seen == ["staged"] * 5 + ["ambient_records"]


def test_every_shard_edge_row_is_among_the_checked_sources():
    from das_diff_veh_tpu_torch.pipeline.ambient import DayStack

    ad = system_adapter("ambient_sharded")
    spec = _small()
    ctx = Context(root=ROOT, spec=spec, seed=SEED, seconds=1.0, trace=False,
                  device=torch.device("cpu"))
    ad.setup(ctx)
    stack = ctx.state["stack"]
    assert isinstance(stack, DayStack) and len(stack.shards) == 4
    chunks = [len(p.schedule) for p in stack._parts]
    assert sum(chunks) == 7 and len(set(chunks)) > 1         # uneven blocks
    assert [s.first for s in stack.shards][1:] == [s.last + 1 for s in stack.shards][:-1]
    assert stack.shards[0].first == 0 and stack.shards[-1].last == SMALL["channels"] - 1
    win = ad.window(ctx)
    sources = win.outputs["sources"]
    assert set(ad.shard_edges(stack)) <= set(sources)
    assert len(sources) == len(set(sources)) and len(win.outputs["ncf"]) == len(sources)
    ad.release(ctx)
    checks = {c.name: c for c in ad.check(ctx, win)}
    assert all(c.ok for c in checks.values()), checks


def test_the_cards_must_be_the_cells_chips():
    ad = system_adapter("ambient_sharded")
    spec = _small()
    spec.config["cards"] = 2
    ctx = Context(root=ROOT, spec=spec, seed=SEED, seconds=1.0, trace=False,
                  device=torch.device("cpu"))
    with pytest.raises(ValueError, match="2 cards"):
        ad.setup(ctx)


def test_a_stack_that_takes_no_devices_fails_at_once(monkeypatch):
    """The program before the split: ``DayStack(nch, cfg, device)`` alone.
    Set-up fails at the stack, before any record is made."""
    from das_diff_veh_tpu_torch.pipeline import ambient

    class OneCardStack:
        def __init__(self, nch, cfg=None, device=None):
            raise AssertionError("not reached: devices is refused first")

    made = []
    monkeypatch.setattr(ambient, "DayStack", OneCardStack)
    ad = system_adapter("ambient_sharded")
    monkeypatch.setattr(ad, "ambient_record", lambda *a: made.append(a))
    ctx = Context(root=ROOT, spec=_small(), seed=SEED, seconds=1.0, trace=False,
                  device=torch.device("cpu"))
    t0 = time.perf_counter()
    with pytest.raises(TypeError, match="devices"):
        ad.setup(ctx)
    assert made == [] and time.perf_counter() - t0 < 5.0


def test_the_bf16_control_fails_on_the_cpu():
    spec = _small()
    system = system_adapter("ambient_sharded")
    ctx = Context(root=ROOT, spec=spec, seed=SEED, seconds=1.0, trace=False,
                  device=torch.device("cpu"))
    system.setup(ctx)
    system.release(ctx)
    checks = {c.name: c for c in system.check(ctx, Window({}, 0, 0,
                                                         outputs=system.control_outputs(ctx)))}
    assert checks["records_mismatch"].ok and not checks["ncf_rel_gap"].ok
