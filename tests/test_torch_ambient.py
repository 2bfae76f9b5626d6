"""The ambient-noise day stack (``pipeline.ambient``, ``ops.noise``, the
banded entry of ``ops.all_pairs``) on the CPU, against the plain reference
``benchmark/reference/ambient/ncf.py`` (loaded by path, the file the
benchmark's check runs) and against the port's full lag-domain entry.

A small array: 93 channels x 3000 samples at 1 kHz, 256-sample windows (22
a record), receivers within 20 channels, lags within 50 samples, source
chunks of 16 (the last has 13 rows), so that the first, the ragged last and
the chunks whose bands are clipped at either end of the array all occur.

Tolerance against the reference: 1e-5 of each source gather's peak.  Both
sides compute in float32 and differ only in the order of their sums: the
window mean (B3's slabs or the einsum's contraction), the FFT library's
batching, and the stack's running sum over records against the
reference's mean of per-record gathers; ~1e-7 is read.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from das_diff_veh_tpu_torch.config import AmbientConfig
from das_diff_veh_tpu_torch.io.segy import write_segy
from das_diff_veh_tpu_torch.obs import default_registry
from das_diff_veh_tpu_torch.ops import noise
from das_diff_veh_tpu_torch.ops.all_pairs import add_banded, band_schedule, xcorr_all_pairs
from das_diff_veh_tpu_torch.pipeline import ambient
from das_diff_veh_tpu_torch.runtime import RuntimeConfig
from das_diff_veh_tpu_torch.runtime.tracing import NullTracer

REF_PATH = Path(__file__).resolve().parent.parent / "benchmark" / "reference" / "ambient" / "ncf.py"
NCH, NT, FS, WLEN, OFF, LAG, CHUNK = 93, 3000, 1000.0, 256, 20, 50, 16
BAND = (20.0, 300.0)
CFG = AmbientConfig(fs=FS, wlen=WLEN, band_hz=BAND, max_offset=OFF, max_lag=LAG,
                    src_chunk=CHUNK)
GAP = 1e-5


def _reference():
    spec = importlib.util.spec_from_file_location("ambient_reference_ncf", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
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


def _ref_kwargs(cfg=CFG):
    return dict(fs=cfg.fs, wlen=cfg.wlen, overlap_ratio=cfg.overlap_ratio, band_hz=cfg.band_hz,
                max_offset=cfg.max_offset, max_lag=cfg.max_lag, one_bit=cfg.one_bit,
                whiten=cfg.whiten, eps=noise.WHITEN_EPS)


def _worst_gap(got, want):
    """Largest |got - want| over each source gather's peak, worst source."""
    peak = np.abs(want).reshape(len(want), -1).max(axis=1)
    return float((np.abs(got - want).reshape(len(want), -1).max(axis=1) / peak).max())


class _Recorder(NullTracer):
    """Keeps span names with their arguments, and counters."""

    def __init__(self):
        self.spans, self.counters = [], []

    def now_us(self):
        return 0.0

    def span(self, name, cat="runtime", **args):
        self.spans.append((name, args))
        return super().span(name, cat, **args)

    def counter(self, name, **values):
        self.counters.append((name, values))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["einsum", "b3_plain"])
def test_day_stack_matches_the_reference(use_kernel):
    """The day stack (B3's plain version on the CPU), and the banded product
    with the einsum in B3's place on the stack's own spectra."""
    recs = _records(3)
    if use_kernel:
        run = ambient.stack_records(recs, CFG, device="cpu")
        assert run.records == run.stack.records == 3 and not run.quarantined
        got = run.stack.flush()
    else:
        stack = ambient.DayStack(NCH, CFG, device="cpu")
        for rec in recs:
            add_banded(stack.spectra(torch.from_numpy(rec)), stack.sum, WLEN, OFF, LAG, CHUNK,
                       use_kernel=False)
        got = (stack.sum / 3).numpy()
    want = REF.stacked_gathers(recs, [1, 1, 1], np.arange(NCH), **_ref_kwargs())
    assert got.shape == (NCH, 2 * OFF + 1, 2 * LAG + 1)
    assert _worst_gap(got, want) <= GAP
    # every chunk's rows, the ragged last among them, and both array ends
    for rows in ([0, 15, 16, 17], [80, 85, NCH - 1], list(range(NCH))):
        assert _worst_gap(got[rows], want[rows]) <= GAP


def test_pairs_past_the_array_ends_stay_zero():
    got = ambient.stack_records(_records(1), CFG, device="cpu").stack.flush()
    for s in (0, 5, NCH - 7, NCH - 1):
        for j in range(2 * OFF + 1):
            inside = 0 <= s + j - OFF < NCH
            assert bool(np.any(got[s, j] != 0)) is inside, (s, j)


def test_one_record_band_equals_the_full_lag_domain_entry():
    """With one-bit and whitening off, a record's banded gathers are the
    pairs of ``xcorr_all_pairs(..., lag_keep=max_lag)`` inside the band, bit
    for bit: the same B3 sums per pair and a power-of-two window, whose
    1/wlen is exact wherever it is applied."""
    rec = _records(1, seed=8)[0]
    cfg = CFG.replace(one_bit=False, whiten=False)
    stack = ambient.DayStack(NCH, cfg, device="cpu")
    stack.add(torch.from_numpy(rec))
    got = stack.flush()
    full = xcorr_all_pairs(rec, WLEN, lag_keep=LAG, src_chunk=CHUNK, use_kernel=True,
                           device="cpu").numpy()
    want = np.zeros_like(got)
    for s in range(NCH):
        r0, r1 = max(s - OFF, 0), min(s + OFF + 1, NCH)
        want[s, r0 - (s - OFF):r1 - (s - OFF)] = full[s, r0:r1]
    np.testing.assert_array_equal(got, want)


def test_stacking_a_then_b_is_the_mean_of_their_single_stacks():
    a, b = _records(2, seed=11)
    both = ambient.stack_records([a, b], CFG, device="cpu").stack
    one_a = ambient.stack_records([a], CFG, device="cpu").stack.flush()
    one_b = ambient.stack_records([b], CFG, device="cpu").stack.flush()
    assert both.records == 2 and both.windows == 2 * ((NT - WLEN) // (WLEN // 2) + 1)
    np.testing.assert_array_equal(both.flush(), (one_a + one_b) / np.float32(2))
    # a later call adds into the same stack
    again = ambient.stack_records([a], stack=both, device="cpu")
    assert again.stack is both and both.records == 3
    np.testing.assert_allclose(both.flush(), (2 * one_a + one_b) / 3, rtol=0,
                               atol=GAP * np.abs(one_a).max())


def test_segy_directory_runs_through_the_runtime(tmp_path, monkeypatch):
    recs = _records(3, seed=13)
    for k, rec in enumerate(recs):
        write_segy(str(tmp_path / f"day_{k:02d}.sgy"), rec, 1.0 / FS)
    calls = []
    real = ambient.run_pipelined

    def spy(tasks, *a, **kw):
        calls.append(len(tasks))
        return real(tasks, *a, **kw)

    monkeypatch.setattr(ambient, "run_pipelined", spy)
    tracer = _Recorder()
    run = ambient.stack_directory(str(tmp_path), CFG, tracer=tracer, device="cpu")
    assert calls == [3] and run.records == 3
    names = [n for n, _ in tracer.spans]
    assert names.count("read") == 3 and names.count("compute") == 3
    assert names.count("input_wait") == 4
    arrays = ambient.stack_records(recs, CFG, device="cpu").stack.flush()
    np.testing.assert_array_equal(run.stack.flush(), arrays)


def test_a_record_that_fails_to_load_is_quarantined(tmp_path):
    good = _records(2, seed=17)
    write_segy(str(tmp_path / "a.sgy"), good[0], 1.0 / FS)
    write_segy(str(tmp_path / "b.sgy"), good[1][:, :2000], 1.0 / 500.0)   # 500 Hz
    write_segy(str(tmp_path / "c.sgy"), good[1], 1.0 / FS)
    run = ambient.stack_directory(str(tmp_path), CFG, device="cpu",
                                  runtime=RuntimeConfig(retry_backoff_s=0.0))
    assert run.records == 2 and [q.key for q in run.quarantined] == ["b.sgy"]
    assert "500.0 Hz" in run.quarantined[0].error
    want = ambient.stack_records(good, CFG, device="cpu").stack.flush()
    np.testing.assert_array_equal(run.stack.flush(), want)


def test_spans_and_counters_come_once_a_record():
    reg = default_registry()
    n0 = reg.counter("das_ambient_records_total").value
    p0 = reg.counter("das_ambient_pairs_total").value
    tracer = _Recorder()
    run = ambient.stack_records(_records(3, seed=19), CFG, tracer=tracer, device="cpu",
                                runtime=RuntimeConfig(prefetch_depth=0))
    run.stack.flush([0, 1], tracer=tracer)
    names = [n for n, _ in tracer.spans]
    for name in ("ambient_stage", "ambient_spectra", "ambient_cross", "ambient_finish"):
        assert [a["record"] for n, a in tracer.spans if n == name] == [0, 1, 2]
    assert names.count("ambient_flush") == 1
    assert [v["total"] for n, v in tracer.counters if n == "ambient_records"] == [1, 2, 3]
    schedule = band_schedule(NCH, CHUNK, OFF)
    pairs = sum((s1 - s0) * (r1 - r0) for s0, s1, r0, r1 in schedule)
    assert run.stack.pairs_per_record == pairs
    assert reg.counter("das_ambient_records_total").value - n0 == 3
    assert reg.counter("das_ambient_pairs_total").value - p0 == 3 * pairs


def test_the_dash_array_schedule():
    """The PoroTomo DASH day stack: 137 chunks of 64 sources, the last of
    17, bands clipped at rows 0 and 8720, 5.68 M pairs a record against the
    stack's 8721 x 601 = 5.24 M."""
    cfg = AmbientConfig()
    sched = band_schedule(8721, cfg.src_chunk, cfg.max_offset)
    assert len(sched) == 137 and sched[-1][:2] == (8704, 8721)
    assert sched[0][2:] == (0, 364) and sched[-1][2:] == (8404, 8721)
    assert max(r1 - r0 for *_, r0, r1 in sched) == 664
    pairs = sum((s1 - s0) * (r1 - r0) for s0, s1, r0, r1 in sched)
    assert 5.67e6 < pairs < 5.69e6 and 8721 * 601 == 5241321
    assert noise.band_bins(cfg.fs, cfg.wlen, cfg.band_hz) == (9, 204)


def test_one_bit_and_whitening():
    x = torch.tensor([[-2.5, 0.0, 1e-30, 3.0]])
    assert noise.one_bit(x).tolist() == [[-1.0, 0.0, 1.0, 1.0]]
    spec = torch.fft.rfft(torch.randn(3, 4, 64, generator=torch.Generator().manual_seed(1)))
    spec[1, 2] = 0                                   # a dead window stays zero
    want_phase = torch.angle(spec[..., 3:9])
    out = noise.whiten_band(spec.clone(), 3, 8)
    assert torch.all(out[..., :3] == 0) and torch.all(out[..., 9:] == 0)
    live = out[..., 3:9].abs()
    torch.testing.assert_close(live[0], torch.ones_like(live[0]))
    assert torch.all(out[1, 2] == 0)
    torch.testing.assert_close(torch.angle(out[0, :, 3:9]), want_phase[0])
    with pytest.raises(ValueError, match="no bin"):
        noise.band_bins(1000.0, 256, (1.0, 2.0))


def test_flush_by_rows_and_slabs_and_clear(monkeypatch):
    stack = ambient.stack_records(_records(2, seed=23), CFG, device="cpu").stack
    whole = stack.flush()
    rows = [92, 0, 40, 41, 7]
    monkeypatch.setattr(ambient, "FLUSH_SLAB", 2)
    np.testing.assert_array_equal(stack.flush(rows), whole[rows])
    stack.clear()
    assert stack.records == 0 and float(stack.sum.abs().max()) == 0.0
    with pytest.raises(ValueError, match="no record"):
        stack.flush()


def test_what_the_stack_refuses():
    stack = ambient.DayStack(NCH, CFG, device="cpu")
    with pytest.raises(ValueError, match=r"\(93, nt\)"):
        stack.add(torch.zeros((NCH + 1, NT)))
    with pytest.raises(ValueError, match="float32"):
        stack.add(torch.zeros((NCH, NT), dtype=torch.float64))
    stack.add(torch.zeros((NCH, NT)))
    with pytest.raises(ValueError, match="3000 samples"):
        stack.add(torch.zeros((NCH, NT - 1)))
    with pytest.raises(ValueError, match="max_lag"):
        ambient.DayStack(NCH, CFG.replace(max_lag=WLEN // 2), device="cpu")
    with pytest.raises(ValueError, match="cfg differs"):
        ambient.stack_records([], CFG.replace(max_lag=10), stack=stack)
    assert float(stack.flush().max()) == 0.0        # zeros in, zeros out
    stack.torn = True                               # a record failed part way in
    with pytest.raises(RuntimeError, match="part way"):
        stack.flush()
    with pytest.raises(RuntimeError, match="part way"):
        stack.add(torch.zeros((NCH, NT)))
