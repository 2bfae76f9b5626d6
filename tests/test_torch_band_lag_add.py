"""The day stack's band-pruned finish (``ops.band_lag_add``) on the CPU: its
plain version against the irfft finish of ``ops.all_pairs._banded_finish``,
the choice of ``Q`` and ``P``, the pairs past the array's ends, its
engagement under ``DayStack`` and its counter, and what the wrapper refuses.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``).

Tolerance against the irfft finish: 1e-6 of each source gather's peak.
Both sides compute in float32 from the same bins; they differ in the FFT's
factorisation and its twiddles' rounding (~2e-7 is read).
"""

import numpy as np
import pytest
import torch

from das_diff_veh_tpu_torch.config import AmbientConfig
from das_diff_veh_tpu_torch.obs import default_registry
from das_diff_veh_tpu_torch.ops import band_lag_add as bla
from das_diff_veh_tpu_torch.ops.all_pairs import _banded_finish, add_banded, band_schedule
from das_diff_veh_tpu_torch.pipeline import ambient

GAP = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cross(m, nb, wlen, lo, hi, seed):
    """Seeded complex64 cross-spectra, zero outside bins lo..hi (bins 0 and
    wlen/2 keep an imaginary part, which c2r drops)."""
    g = torch.Generator().manual_seed(seed)
    nf = wlen // 2 + 1
    c = torch.complex(torch.randn(m, nb, nf, generator=g), torch.randn(m, nb, nf, generator=g))
    c[..., :lo] = 0
    c[..., hi + 1:] = 0
    return c


def _worst_gap(got, want):
    m = want.shape[0]
    peak = want.abs().reshape(m, -1).amax(1)
    return float(((got - want).abs().reshape(m, -1).amax(1) / peak).max())


# (wlen, lo, hi, max_offset, max_lag, sources, lead): the DASH day stack's
# band, bands from bin 0 and to bin wlen/2, bands below Q_MIN and of bin
# wlen/2 alone,
# chunks clipped at the array's start (lead > 0) and short of its end
FINISHES = {
    "dash": (4096, 9, 204, 6, 1000, 5, 0),
    "dash_clipped_start": (4096, 9, 204, 6, 1000, 5, 4),
    "from_bin_0": (256, 0, 76, 20, 50, 16, 0),
    "to_nyquist": (256, 6, 128, 20, 127, 16, 0),
    "whole_window": (256, 0, 128, 5, 100, 4, 3),
    "below_q_min": (256, 0, 5, 20, 100, 16, 20),
    "nyquist_only": (256, 128, 128, 5, 60, 4, 0),
    "smallest_window": (64, 0, 32, 3, 31, 5, 0),
    "wide_band": (1024, 100, 512, 4, 300, 3, 2),
}


@pytest.mark.parametrize("case", sorted(FINISHES))
def test_plain_version_equals_the_irfft_finish(case):
    wlen, lo, hi, off, lag, m, lead = FINISHES[case]
    nb = m + 2 * off - lead - (1 if case == "wide_band" else 0)   # one band short at the end
    cross = _cross(m, nb, wlen, lo, hi, seed=len(case))
    s0 = 500
    r0 = s0 - off + lead
    want = torch.zeros(m, 2 * off + 1, 2 * lag + 1)
    got = torch.zeros_like(want)
    assert _banded_finish(cross, want, s0, r0, wlen, off, lag, m) is False
    assert _banded_finish(cross, got, s0, r0, wlen, off, lag, m, band=(lo, hi)) is True
    inside = bla.in_array(m, nb, 2 * off + 1, lead)
    assert _worst_gap(got[inside], want[inside]) <= GAP
    assert torch.all(got[~inside] == 0) and torch.all(want[~inside] == 0)


@pytest.mark.parametrize("wlen,lo,hi,q,p", [
    (4096, 9, 204, 256, 16), (4096, 9, 255, 256, 16), (4096, 9, 256, 512, 8),
    (4096, 0, 2048, 2048, 2), (4096, 2048, 2048, 16, 256), (256, 6, 76, 128, 2),
    (256, 0, 5, 16, 16), (256, 0, 15, 16, 16), (256, 0, 16, 32, 8), (64, 0, 32, 32, 2),
    (8192, 1, 3000, 4096, 2)])
def test_q_and_p(wlen, lo, hi, q, p):
    assert bla.band_plan(wlen, lo, hi) == (q, p)
    assert int(np.prod(bla.radices(q))) == q and all(r in (2, 4, 8, 16) for r in bla.radices(q))
    assert bla.radices(q)[1:] == [16] * (len(bla.radices(q)) - 1)


@pytest.mark.parametrize("wlen,lo,hi", [(4096, 9, 4000), (4096, 300, 200), (100, 1, 10),
                                        (32, 0, 8), (16384, 1, 10)])
def test_bands_and_windows_it_refuses(wlen, lo, hi):
    with pytest.raises(ValueError):
        bla.band_plan(wlen, lo, hi)


def test_twiddles_are_rounded_once_from_float64():
    wlen, q = 4096, 256
    tab = bla.twiddle_table(wlen, q).numpy()
    p = wlen // q
    k, r = np.meshgrid(np.arange(q), np.arange(p))
    want = np.exp(2j * np.pi * ((k * r) % wlen) / wlen).astype(np.complex64).ravel()
    np.testing.assert_array_equal(tab[:wlen], want)
    c = np.exp(2j * np.pi * ((-q * np.arange(p)) % wlen) / wlen)       # w^{-Qp}
    np.testing.assert_array_equal(tab[wlen:wlen + p], c.astype(np.complex64))
    assert len(tab) == wlen + p + 16 * 16       # one radix-16 stage after the first
    assert bla.twiddle_table(wlen, q) is bla.twiddle_table(wlen, q)


def test_receivers_past_the_array_ends_stay_untouched():
    """A chunk clipped at both ends: every slot whose receiver lies outside
    the array keeps its value exactly, whatever the bins next to it hold."""
    wlen, lo, hi, off, lag, m = 256, 6, 76, 20, 50, 16
    lead, nb = 20, 16 + 20 - 7          # 20 rows clipped before, 7 after
    cross = _cross(m, nb, wlen, lo, hi, seed=3)
    out = torch.randn(m, 2 * off + 1, 2 * lag + 1, generator=torch.Generator().manual_seed(4))
    before = out.clone()
    bla.band_lag_add_plain(cross, out, lead, lo, hi, wlen, lag)
    inside = bla.in_array(m, nb, 2 * off + 1, lead)
    assert torch.equal(out[~inside], before[~inside])
    assert bool(torch.all((out[inside] != before[inside]).any(dim=-1)))
    assert bla.pairs(m, nb, 2 * off + 1, lead) == int(inside.sum())


def _records(n, nch=40, nt=2000, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((nch, nt)).astype(np.float32) for _ in range(n)]


CFG = AmbientConfig(fs=1000.0, wlen=256, band_hz=(20.0, 300.0), max_offset=8, max_lag=40,
                    src_chunk=16)


@pytest.mark.parametrize("whiten", [True, False], ids=["whitened", "unwhitened"])
def test_a_whitened_stack_takes_the_band_finish_and_counts_it(whiten, monkeypatch):
    reg = default_registry()
    n0 = reg.counter("das_ambient_records_total").value
    b0 = reg.counter("das_ambient_band_finish_records_total").value
    calls = []
    real = bla.band_lag_add_plain
    monkeypatch.setattr(bla, "band_lag_add_plain", lambda *a: calls.append(1) or real(*a))
    run = ambient.stack_records(_records(2), CFG.replace(whiten=whiten), device="cpu")
    chunks = len(run.stack.schedule)
    assert run.records == 2 and reg.counter("das_ambient_records_total").value - n0 == 2
    assert reg.counter("das_ambient_band_finish_records_total").value - b0 == (2 if whiten else 0)
    assert len(calls) == (2 * chunks if whiten else 0)
    assert bla.launches == 0                   # no kernel on the CPU


def test_a_whitened_stack_equals_its_irfft_finish():
    """The whole day stack with the band finish against the same stack with
    the band withheld from the finish (the irfft path), 1e-6 of each
    gather's peak; the pairs past the array's ends zero in both."""
    recs = _records(2, seed=9)
    got = ambient.stack_records(recs, CFG, device="cpu").stack
    want = ambient.DayStack(40, CFG, device="cpu")
    for rec in recs:
        wf = want.spectra(torch.from_numpy(rec))
        assert add_banded(wf, want.sum, CFG.wlen, CFG.max_offset, CFG.max_lag,
                          CFG.src_chunk) is False
    assert _worst_gap(got.sum, want.sum) <= GAP
    assert torch.equal(got.sum == 0, want.sum == 0)


def _refused(**kw):
    wlen, lo, hi, lag, m, nb = 256, 6, 76, 50, 4, 12
    args = dict(cross=_cross(m, nb, wlen, lo, hi, seed=5), out=torch.zeros(m, 9, 2 * lag + 1),
                lead=0, lo=lo, hi=hi, wlen=wlen, max_lag=lag)
    args.update(kw)
    return args


@pytest.mark.parametrize("bad,match", [
    (dict(cross=_cross(4, 12, 256, 6, 76, 5).to(torch.complex128)), "complex64"),
    (dict(out=torch.zeros(4, 9, 101, dtype=torch.float64)), "float32"),
    (dict(out=torch.zeros(4, 9, 99)), "max_lag"),
    (dict(out=torch.zeros(5, 9, 101)), "sources"),
    (dict(cross=_cross(4, 12, 256, 6, 76, 5)[..., :100]), "contiguous"),
    (dict(cross=_cross(4, 12, 512, 6, 76, 5)), "bins"),
    (dict(out=torch.zeros(4, 101, 9).transpose(1, 2)), "contiguous"),
    (dict(hi=200), "band bins"),
    (dict(wlen=250), "power of two"),
], ids=["cross_dtype", "out_dtype", "lags", "sources", "cross_strided", "nf", "out_strided",
        "band", "wlen"])
def test_the_wrapper_refuses(bad, match):
    with pytest.raises(ValueError, match=match):
        bla.band_lag_add(**_refused(**bad))


def test_the_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        bla.band_lag_add_cuda(**_refused())


def test_bytes_and_operations_of_a_dash_record():
    """The DASH record's 137 launches: 5,151,021 in-array pairs, ~90.5 GB
    (27 ms at 3.35 TB/s), and fewer operations than bytes allow."""
    cfg = AmbientConfig()
    width = 2 * cfg.max_offset + 1
    launches = [(s1 - s0, r1 - r0, r0 - (s0 - cfg.max_offset))
                for s0, s1, r0, r1 in band_schedule(8721, cfg.src_chunk, cfg.max_offset)]
    assert len(launches) == 137
    assert sum(bla.pairs(m, nb, width, lead) for m, nb, lead in launches) == 5151021
    nbytes = sum(bla.bytes_moved(m, nb, width, lead, 9, 204, 1000) for m, nb, lead in launches)
    assert 90.4e9 < nbytes < 90.6e9
    ops = sum(bla.flops(m, nb, width, lead, 9, 204, 4096, 1000) for m, nb, lead in launches)
    assert ops / 67e12 < nbytes / 3.35e12
