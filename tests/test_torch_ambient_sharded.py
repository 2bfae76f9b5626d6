"""The ambient-noise day stack split over several devices
(``pipeline.ambient.DayStack(..., devices=...)``) on the CPU: four CPU
shards stand for the cards.

A small array: 300 channels x 3000 samples at 1 kHz, 256-sample windows,
receivers within 40 channels, lags within 60 samples, source chunks of 16
(19 chunks, the last of 12 rows), dealt to four shards in uneven blocks.
Each shard computes from the spectra rows it was sent, so the split stack
must equal the one-device stack bit for bit; against the plain reference
(``benchmark/reference/ambient/ncf.py``) it is held at 1e-5 of each
gather's peak, as the one-device stack is.
"""

import gc
import importlib.util
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from das_diff_veh_tpu_torch.config import AmbientConfig
from das_diff_veh_tpu_torch.obs import default_registry
from das_diff_veh_tpu_torch.ops import all_pairs, noise
from das_diff_veh_tpu_torch.ops.all_pairs import BandShard, add_banded, band_schedule
from das_diff_veh_tpu_torch.pipeline import ambient
from das_diff_veh_tpu_torch.runtime import RuntimeConfig
from das_diff_veh_tpu_torch.runtime.tracing import NullTracer

REF_PATH = Path(__file__).resolve().parent.parent / "benchmark" / "reference" / "ambient" / "ncf.py"
NCH, NT, FS, WLEN, OFF, LAG, CHUNK = 300, 3000, 1000.0, 256, 40, 60, 16
CFG = AmbientConfig(fs=FS, wlen=WLEN, band_hz=(20.0, 300.0), max_offset=OFF, max_lag=LAG,
                    src_chunk=CHUNK)
FOUR = ["cpu"] * 4
GAP = 1e-5


def _reference():
    spec = importlib.util.spec_from_file_location("ambient_reference_ncf", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _records(n, seed=5):
    """Seeded noise with a plane wave crossing the array, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(NT) / FS
    x = np.arange(NCH, dtype=np.float64)
    out = []
    for _ in range(n):
        rec = rng.standard_normal((NCH, NT))
        f0, v = rng.uniform(30.0, 80.0), rng.choice([-1.0, 1.0]) * rng.uniform(250.0, 600.0)
        rec += 1.5 * np.sin(2 * np.pi * f0 * (t[None, :] - x[:, None] / v))
        out.append(rec.astype(np.float32))
    return out


class _Recorder(NullTracer):
    """Keeps span names with their arguments, and counters."""

    def __init__(self):
        self.spans, self.counters = [], []

    def span(self, name, cat="runtime", **args):
        self.spans.append((name, args))
        return super().span(name, cat, **args)

    def counter(self, name, **values):
        self.counters.append((name, values))


@pytest.fixture(scope="module")
def three():
    """Three records through the one-device stack and the four-shard stack."""
    recs = _records(3)
    one = ambient.stack_records(recs, CFG, device="cpu").stack
    four = ambient.stack_records(recs, stack=ambient.DayStack(NCH, CFG, devices=FOUR)).stack
    return recs, one, four


def test_the_split_stack_is_the_one_device_stack_bit_for_bit(three):
    recs, one, four = three
    got = four.flush()
    np.testing.assert_array_equal(got, one.flush())
    ref = _reference()
    want = ref.stacked_gathers(recs, [1, 1, 1], np.arange(NCH), fs=FS, wlen=WLEN,
                               overlap_ratio=CFG.overlap_ratio, band_hz=CFG.band_hz,
                               max_offset=OFF, max_lag=LAG, eps=noise.WHITEN_EPS)
    peak = np.abs(want).reshape(NCH, -1).max(axis=1)
    gap = (np.abs(got - want).reshape(NCH, -1).max(axis=1) / peak).max()
    assert gap <= GAP
    assert four.records == one.records == 3 and four.windows == one.windows


def test_the_shards_are_uneven_blocks_of_whole_chunks(three):
    _, _, four = three
    chunks = [len(p.schedule) for p in four._parts]
    assert sum(chunks) == len(band_schedule(NCH, CHUNK, OFF)) == 19 and len(set(chunks)) > 1
    rows = [(s.first, s.last) for s in four.shards]
    assert rows[0][0] == 0 and rows[-1][1] == NCH - 1
    for (_, last), (first, _) in zip(rows, rows[1:]):
        assert first == last + 1 and first % CHUNK == 0
    assert [str(s.card) for s in four.shards] == FOUR
    assert [tuple(s.shape) for s in four.sums] == [(b - a + 1, 2 * OFF + 1, 2 * LAG + 1)
                                                   for a, b in rows]
    with pytest.raises(AttributeError, match="sums"):
        four.sum


def test_flush_of_rows_across_shards_comes_back_in_the_order_asked(three, monkeypatch):
    _, one, four = three
    edges = [r for s in four.shards for r in (s.first, s.last)]
    rows = [NCH - 1, 0, *reversed(edges), 150, 151, 7, 150]
    monkeypatch.setattr(ambient, "FLUSH_SLAB", 3)
    np.testing.assert_array_equal(four.flush(rows), one.flush(rows))
    assert four.flush([]).shape == (0, 2 * OFF + 1, 2 * LAG + 1)
    with pytest.raises(IndexError, match="0..299"):
        four.flush([NCH])


def test_the_deal_balances_the_work():
    """Contiguous, non-empty blocks whose largest is the least it can be;
    at the PoroTomo DASH widths at 500 m (137 chunks) the four blocks are
    35, 33, 33 and 36 chunks, within 0.6 % of an even share of the work."""
    assert ambient.deal_chunks([5, 1, 1, 1, 1, 5], 3) == [range(0, 1), range(1, 5),
                                                        range(5, 6)]
    assert ambient.deal_chunks([3, 1, 1, 1, 2], 2) == [range(0, 2), range(2, 5)]
    assert ambient.deal_chunks([3, 3, 3], 1) == [range(0, 3)]
    with pytest.raises(ValueError, match="cannot be dealt"):
        ambient.deal_chunks([1, 1], 3)
    sched = band_schedule(8721, 64, 500)
    work = ambient.chunk_work(8721, sched, 500)
    blocks = ambient.deal_chunks(work, 4)
    assert [len(b) for b in blocks] == [35, 33, 33, 36]
    sums = [sum(work[b.start:b.stop]) for b in blocks]
    assert max(sums) / (sum(work) / 4) - 1 < 0.006
    # a full chunk: 64 x 1064 band rows for B3 and 64 x 1001 in-array pairs
    assert work[68] == 64 * 1064 + 64 * 1001


def test_band_schedule_of_a_block_of_chunks():
    whole = band_schedule(NCH, CHUNK, OFF)
    assert band_schedule(NCH, CHUNK, OFF, chunks=range(5, 9)) == whole[5:9]
    assert band_schedule(NCH, CHUNK, OFF, chunks=range(17, 19))[-1] == whole[-1]


def test_a_chunk_from_a_shards_rows_is_the_chunk_of_the_whole():
    """``add_banded`` over a shard of one chunk, from the spectra rows the
    shard reads into its stack rows, gives the bits of the whole stack's
    chunk; the shard's chunks take views of one cross-spectra buffer."""
    stack = ambient.DayStack(NCH, CFG, device="cpu")
    wf = stack.spectra(torch.from_numpy(_records(1, seed=9)[0]))
    whole = torch.zeros((NCH, 2 * OFF + 1, 2 * LAG + 1))
    add_banded(wf, whole, WLEN, OFF, LAG, CHUNK, band=stack.finish_band)
    chunk = band_schedule(NCH, CHUNK, OFF)[7]
    s0, s1, r0, r1 = chunk
    part = torch.zeros((s1 - s0, 2 * OFF + 1, 2 * LAG + 1))
    shard = BandShard(part, [chunk], out_row0=s0, row0=r0)
    shard.spectra = wf[r0:r1].clone()
    add_banded(wf, [shard], WLEN, OFF, LAG, CHUNK, band=stack.finish_band)
    assert torch.equal(part, whole[s0:s1])
    two = BandShard(whole, band_schedule(NCH, CHUNK, OFF)[-2:], out_row0=0)
    views = two.cross(wf.shape[2])
    assert [tuple(v.shape) for v in views] == [(16, 68, 129), (12, 52, 129)]
    assert all(v.is_contiguous() and v.data_ptr() == views[0].data_ptr() for v in views)
    assert two.cross(wf.shape[2]) is views and two.cross(7)[0].shape == (16, 68, 7)


def test_a_failure_on_one_shard_tears_the_whole_stack(monkeypatch):
    recs = _records(2, seed=13)
    stack = ambient.DayStack(NCH, CFG, devices=FOUR)
    stack.add(torch.from_numpy(recs[0]))
    third = stack.shards[2]
    real = all_pairs._banded_finish

    def fails(cross, out, s0, *a, **kw):
        if third.first <= s0 <= third.last:
            raise RuntimeError("the third card failed")
        real(cross, out, s0, *a, **kw)

    monkeypatch.setattr(all_pairs, "_banded_finish", fails)
    with pytest.raises(RuntimeError, match="third card"):
        stack.add(torch.from_numpy(recs[1]))
    assert stack.torn and stack.records == 1
    with pytest.raises(RuntimeError, match="part way"):
        stack.flush([0])
    with pytest.raises(RuntimeError, match="part way"):
        stack.add(torch.from_numpy(recs[1]))
    monkeypatch.setattr(all_pairs, "_banded_finish", real)
    stack.clear()
    assert not stack.torn and all(float(s.abs().max()) == 0.0 for s in stack.sums)
    stack.add(torch.from_numpy(recs[1]))
    np.testing.assert_array_equal(
        stack.flush(), ambient.stack_records(recs[1:], CFG, device="cpu").stack.flush())


def _sent_rows(stack):
    """Spectra rows each other shard reads: its sources and the receivers
    within ``max_offset`` of them, clipped to the array."""
    return [min(s.last + 1 + OFF, NCH) - max(s.first - OFF, 0) for s in stack.shards[1:]]


def test_each_record_sends_the_band_rows_once_and_counts_them():
    reg = default_registry()
    peer = reg.counter("das_ambient_peer_bytes_total")
    b0 = peer.value
    tracer = _Recorder()
    run = ambient.stack_records(_records(3, seed=17), tracer=tracer,
                                stack=ambient.DayStack(NCH, CFG, devices=FOUR),
                                runtime=RuntimeConfig(prefetch_depth=0))
    lo, hi = run.stack.band
    nwin = (NT - WLEN) // (WLEN // 2) + 1
    want = sum(_sent_rows(run.stack)) * nwin * (hi - lo + 1) * 8
    scatter = [a for n, a in tracer.spans if n == "ambient_scatter"]
    assert scatter == [{"record": k, "bytes": want} for k in range(3)]
    assert run.stack.peer_bytes_per_record == want
    assert peer.value - b0 == 3 * want
    names = [n for n, _ in tracer.spans]
    order = [n for n in names if n.startswith("ambient_") and n != "ambient_stage"]
    assert order == ["ambient_spectra", "ambient_scatter", "ambient_cross",
                     "ambient_finish"] * 3
    assert [v["total"] for n, v in tracer.counters if n == "ambient_records"] == [1, 2, 3]


def test_one_shard_sends_nothing():
    reg = default_registry()
    peer = reg.counter("das_ambient_peer_bytes_total")
    b0 = peer.value
    tracer = _Recorder()
    run = ambient.stack_records(_records(2, seed=19), CFG, tracer=tracer, device="cpu")
    assert len(run.stack.shards) == 1 and run.stack.peer_bytes_per_record == 0
    assert "ambient_scatter" not in [n for n, _ in tracer.spans]
    assert peer.value == b0
    assert run.stack.shards[0] == (torch.device("cpu"), 0, NCH - 1)
    assert run.stack.sum is run.stack.sums[0]


@pytest.mark.parametrize("devices", [None, FOUR], ids=["one", "four"])
def test_a_stack_let_go_frees_its_rows_at_once(devices):
    """No reference cycle holds a stack's rows once the stack is let go, so
    that its memory goes back without a garbage collection: a card's 42 GB
    stack must be gone before the next one is made."""
    stack = ambient.DayStack(NCH, CFG, device="cpu", devices=devices)
    stack.add(torch.from_numpy(_records(1, seed=23)[0]))
    rows = [weakref.ref(s) for s in stack.sums]
    gc.disable()
    try:
        del stack
        assert all(r() is None for r in rows)
    finally:
        gc.enable()


def test_what_the_split_stack_refuses():
    with pytest.raises(ValueError, match="not the first"):
        ambient.DayStack(NCH, CFG, device="cpu:1", devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="cannot be dealt"):
        ambient.DayStack(40, CFG, devices=FOUR)          # 3 chunks, 4 shards
    stack = ambient.DayStack(NCH, CFG, devices=FOUR)
    with pytest.raises(ValueError, match="float32 on cpu"):
        stack.add(torch.zeros((NCH, NT), dtype=torch.float64))
