"""The all-pairs path (``das_diff_veh_tpu_torch.ops.all_pairs``) and its two
kernels' plain versions against ``das_diff_veh_tpu.ops.pallas_xcorr`` on the
CPU, the Pallas kernels in interpret mode.  The CUDA kernels are held against
the plain versions on the card in tests/test_torch_cuda.py.

Tolerances.  The port and the JAX package round the same float32 operations
in the same order, but XLA contracts the kernel's products into FMAs where
PyTorch's CPU ops round each one, and the two packages' FFT libraries round
differently: ~1e-7 peak-relative was measured, so 1e-6 is held.  The lag-axis
max is a selection and is held bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das_diff_veh_tpu import workloads as jwl
from das_diff_veh_tpu.ops import pallas_xcorr as jpx
from das_diff_veh_tpu_torch import workloads as pwl
from das_diff_veh_tpu_torch.ops import all_pairs as pap
from das_diff_veh_tpu_torch.ops import cross_spectra as pcs
from das_diff_veh_tpu_torch.ops import lag_absmax as pla
from das_diff_veh_tpu_torch.ops.precision import bf16_round_complex

F32_PEAK_REL = 1e-6
RING_BF16_BUDGET = 1e-2                         # tests/test_precision.py's ring budget
NCH, NT, WLEN, SRC_CHUNK = 22, 700, 64, 4      # 20 windows; 22 rows = 5 chunks + 2


def _peak_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _record(seed, nch=NCH, nt=NT):
    return np.random.default_rng(seed).standard_normal((nch, nt)).astype(np.float32)


def test_make_ambient_record_is_byte_identical():
    want = np.asarray(jwl.make_ambient_record(6, 300, seed=3))
    got = pwl.make_ambient_record(6, 300, seed=3, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("win_block", [None, 8])
def test_cross_spectra_plain_matches_jax_kernel_interpret(win_block):
    """B3's plain version against ``_pallas_cross_spectra`` in interpret mode
    on the same spectra, the JAX planes un-padded before comparing; 17
    windows, so ``win_block=8`` leaves a ragged slab of one."""
    wf = np.asarray(jpx._window_spectra(jnp.asarray(_record(1, 20, 600)), WLEN, 0.5))
    m, (n, nwin, nf) = 5, wf.shape
    wb = jpx._resolve_win_block(nwin, win_block)
    assert wb == pap._resolve_win_block(nwin, win_block)
    sr, si = jpx._planar_padded(jnp.asarray(wf[:m]))
    ar, ai = jpx._planar_padded(jnp.asarray(wf))
    cr, ci = jpx._pallas_cross_spectra(sr, si, ar, ai, win_block=wb, interpret=True)
    want = (np.asarray(cr) + 1j * np.asarray(ci))[:m, :n, :nf]
    got = pcs.cross_spectra_plain(torch.from_numpy(wf[:m].copy()), torch.from_numpy(wf.copy()),
                                  nwin, wb)
    assert got.dtype == torch.complex64 and got.shape == (m, n, nf)
    assert _peak_rel(got.numpy(), want) <= F32_PEAK_REL


@pytest.mark.parametrize("nlag", [64, 203])
def test_lag_absmax_plain_matches_jax_kernel_interpret(nlag):
    """B4's plain version against ``_pallas_lag_absmax`` in interpret mode,
    bit for bit, with a NaN row (it propagates) and an all-zero row."""
    lag = np.random.default_rng(2).standard_normal((37, nlag)).astype(np.float32)
    lag[3, nlag // 2] = np.nan
    lag[5] = 0.0
    want = np.asarray(jpx._pallas_lag_absmax(jnp.asarray(lag), interpret=True))
    got = pla.lag_absmax(torch.from_numpy(lag))
    assert np.isnan(want[3]) and want[5] == 0.0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("win_block", [None, 8])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("entry", ["peak", "lag"])
def test_entries_match_jax(entry, use_kernel, win_block):
    """Both entries on both routes against the JAX entries with the same
    flags: ``use_kernel=True`` on the CPU (the kernels' plain versions)
    against ``use_pallas=True, interpret=True``, ``use_kernel=False`` against
    ``use_pallas=False``; ``win_block=8`` streams 20 windows in 3 slabs."""
    data = _record(3)
    kw = dict(src_chunk=SRC_CHUNK, win_block=win_block)
    if entry == "peak":
        want = jpx.xcorr_all_pairs_peak(jnp.asarray(data), WLEN, use_pallas=use_kernel,
                                        interpret=True, **kw)
        got = pap.xcorr_all_pairs_peak(torch.from_numpy(data), WLEN, use_kernel=use_kernel,
                                       device="cpu", **kw)
    else:
        want = jpx.xcorr_all_pairs(jnp.asarray(data), WLEN, use_pallas=use_kernel,
                                   interpret=True, **kw)
        got = pap.xcorr_all_pairs(torch.from_numpy(data), WLEN, use_kernel=use_kernel,
                                  device="cpu", **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _peak_rel(got.numpy(), want) <= F32_PEAK_REL


@pytest.mark.parametrize("lagmax_block", [None, 4, 5, 100])
def test_fused_finish_matches_unfused_bitwise(lagmax_block):
    """The fused peak finish (blockwise irfft + lag-axis max, last block
    sliced) equals the unfused ``max |irfft|`` bit for bit: automatic,
    ragged, even-ish and >= nall receiver blocks."""
    data = torch.from_numpy(_record(4))
    kw = dict(src_chunk=SRC_CHUNK, use_kernel=True, device="cpu")
    unfused = pap.xcorr_all_pairs_peak(data, WLEN, lagmax_block=0, **kw)
    fused = pap.xcorr_all_pairs_peak(data, WLEN, lagmax_block=lagmax_block, **kw)
    assert torch.equal(fused, unfused)


def test_lag_trim_matches_center_slice():
    data = torch.from_numpy(_record(6, 8, 300))
    wlen, keep = 80, 11
    full = pap.xcorr_all_pairs(data, wlen, use_kernel=False, device="cpu")
    trimmed = pap.xcorr_all_pairs(data, wlen, lag_keep=keep, use_kernel=False, device="cpu")
    mid = wlen // 2
    assert torch.equal(trimmed, full[..., mid - keep:mid + keep + 1])


@pytest.mark.parametrize("call", ["peak_win_block", "lag_win_block", "spectra_win_block",
                                  "peak_lagmax_block"])
def test_negative_blocks_rejected(call):
    data = torch.from_numpy(_record(7, 6, 300))
    wf = pap._window_spectra(data, 64, 0.5)
    calls = {
        "peak_win_block": lambda: pap.xcorr_all_pairs_peak(data, 64, use_kernel=False,
                                                           win_block=-3, device="cpu"),
        "lag_win_block": lambda: pap.xcorr_all_pairs(data, 64, use_kernel=False,
                                                     win_block=-1, device="cpu"),
        "spectra_win_block": lambda: pap.peak_from_spectra(wf, wf, 64, 4, False,
                                                           win_block=-1, device="cpu"),
        "peak_lagmax_block": lambda: pap.xcorr_all_pairs_peak(data, 64, use_kernel=True,
                                                              lagmax_block=-1, device="cpu"),
    }
    with pytest.raises(ValueError, match=call.split("_", 1)[1]):
        calls[call]()


def test_complex128_spectra_keep_complex128_and_match_jax():
    """x64 spectra through the einsum path stay complex128 (the accumulator
    takes the inputs' dtype) and match the JAX package at 1e-12."""
    wf = np.asarray(jpx._window_spectra(jnp.asarray(_record(8, 6, 640)), 64, 0.5)
                    ).astype(np.complex128)
    cross = pap._einsum_cross_spectra(torch.from_numpy(wf[:4]), torch.from_numpy(wf), 5)
    assert cross.dtype == torch.complex128
    want = np.asarray(jpx.peak_from_spectra(jnp.asarray(wf), jnp.asarray(wf), 64, 4, False,
                                            win_block=5))
    got = pap.peak_from_spectra(torch.from_numpy(wf), torch.from_numpy(wf), 64, 4, False,
                                win_block=5, device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("win_block", [None, 8])
def test_cross_spectra_plain_bf16_matches_jax_kernel_interpret(win_block):
    """B3's bf16 tier: the plain version on bf16 pairs against
    ``_pallas_cross_spectra`` in interpret mode on ``_planar_padded(...,
    "bf16")`` planes of the same spectra.  Both widen the same bfloat16
    values to float32 exactly, so only the f32 tier's FMA difference is left."""
    wf = np.asarray(jpx._window_spectra(jnp.asarray(_record(1, 20, 600)), WLEN, 0.5))
    m, (n, nwin, nf) = 5, wf.shape
    wb = jpx._resolve_win_block(nwin, win_block)
    sr, si = jpx._planar_padded(jnp.asarray(wf[:m]), "bf16")
    ar, ai = jpx._planar_padded(jnp.asarray(wf), "bf16")
    assert sr.dtype == jnp.bfloat16
    cr, ci = jpx._pallas_cross_spectra(sr, si, ar, ai, win_block=wb, interpret=True)
    want = (np.asarray(cr) + 1j * np.asarray(ci))[:m, :n, :nf]
    src = pcs.to_bf16_pairs(torch.from_numpy(wf[:m].copy()))
    rcv = pcs.to_bf16_pairs(torch.from_numpy(wf.copy()))
    assert src.dtype == torch.bfloat16 and src.shape == (m, nwin, nf, 2)
    got = pcs.cross_spectra(src, rcv, nwin, wb)
    assert got.dtype == torch.complex64 and got.shape == (m, n, nf)
    assert _peak_rel(got.numpy(), want) <= F32_PEAK_REL
    f32 = pcs.cross_spectra_plain(torch.from_numpy(wf[:m].copy()), torch.from_numpy(wf.copy()),
                                  nwin, wb)
    assert not torch.equal(got, f32)


def test_cross_spectra_plain_bf16_is_rounded_f32_plain():
    """The bf16 tier's plain version is ``bf16_round`` of the real and
    imaginary parts of both spectra, then the f32 plain version, bit for bit;
    the pairs hold those rounded parts."""
    rng = np.random.default_rng(12)
    wf = torch.from_numpy((rng.standard_normal((9, 5, 33))
                           + 1j * rng.standard_normal((9, 5, 33))).astype(np.complex64))
    pairs = pcs.to_bf16_pairs(wf)
    assert pairs.is_contiguous() and pairs.shape == (9, 5, 33, 2)
    rounded = bf16_round_complex(wf)
    assert torch.equal(pairs.float(), torch.view_as_real(rounded))
    for wb in (5, 2):
        got = pcs.cross_spectra_plain(pairs[:3], pairs, 5, wb)
        assert torch.equal(got, pcs.cross_spectra_plain(rounded[:3], rounded, 5, wb))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_peak_from_spectra_bf16_matches_jax(use_kernel):
    """``peak_from_spectra(precision="bf16")`` on the same spectra as the JAX
    entry, both routes (the kernel route through B3's plain version and
    ``interpret=True``), ``win_block=8`` with a ragged slab: the same bf16
    values reach both, so the f32 bar holds."""
    wf = np.array(jpx._window_spectra(jnp.asarray(_record(3)), WLEN, 0.5))
    kw = dict(win_block=8, precision="bf16")
    want = jpx.peak_from_spectra(jnp.asarray(wf), jnp.asarray(wf), WLEN, SRC_CHUNK,
                                 use_kernel, interpret=True, **kw)
    got = pap.peak_from_spectra(torch.from_numpy(wf), torch.from_numpy(wf), WLEN, SRC_CHUNK,
                                use_kernel, device="cpu", **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _peak_rel(got.numpy(), want) <= F32_PEAK_REL


# Record in, peaks out, in bf16: the two packages' FFTs differ by ~1e-7
# relative, which moves the odd spectrum value across a bfloat16 rounding
# midpoint; such a value then differs by one bf16 step (2^-8 relative) between
# the packages.  2e-6 to 4e-6 peak-relative was measured on 22 x 700 records
# (seeds 3 and 5; 1.1e-7 on seed 4, where nothing crossed), so the bar for
# the entries that take a record is 1e-5; on the same spectra the f32 bar
# holds (above).
BF16_ENTRY_PEAK_REL = 1e-5


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("entry", ["peak", "lag"])
def test_entries_bf16_match_jax(entry, use_kernel):
    """Both entries in the bf16 tier on both routes against the JAX entries
    in bf16 with the same flags."""
    data = _record(3)
    kw = dict(src_chunk=SRC_CHUNK, precision="bf16")
    if entry == "peak":
        want = jpx.xcorr_all_pairs_peak(jnp.asarray(data), WLEN, use_pallas=use_kernel,
                                        interpret=True, **kw)
        got = pap.xcorr_all_pairs_peak(torch.from_numpy(data), WLEN, use_kernel=use_kernel,
                                       device="cpu", **kw)
    else:
        want = jpx.xcorr_all_pairs(jnp.asarray(data), WLEN, use_pallas=use_kernel,
                                   interpret=True, **kw)
        got = pap.xcorr_all_pairs(torch.from_numpy(data), WLEN, use_kernel=use_kernel,
                                  device="cpu", **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _peak_rel(got.numpy(), want) <= BF16_ENTRY_PEAK_REL


@pytest.mark.parametrize("use_kernel", [True, False])
def test_bf16_gap_within_ring_budget(use_kernel):
    """The port's bf16 peaks change bits and stay within
    ``tests/test_precision.py``'s ring budget of its f32 peaks, on that
    file's 24 x 1024 record at ``wlen=128``."""
    data = torch.from_numpy(np.random.default_rng(20).standard_normal((24, 1024))
                            .astype(np.float32))
    kw = dict(use_kernel=use_kernel, device="cpu")
    f32 = pap.xcorr_all_pairs_peak(data, 128, **kw)
    b16 = pap.xcorr_all_pairs_peak(data, 128, precision="bf16", **kw)
    assert torch.equal(f32, pap.xcorr_all_pairs_peak(data, 128, precision="f32", **kw))
    assert not torch.equal(f32, b16)
    assert _peak_rel(b16.numpy(), f32.numpy()) < RING_BF16_BUDGET


def test_unknown_precision_rejected():
    data = torch.from_numpy(_record(9, 6, 300))
    with pytest.raises(ValueError, match="precision"):
        pap.xcorr_all_pairs_peak(data, 64, precision="f16", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        pap.xcorr_all_pairs(data, 64, precision="f16", device="cpu")


@pytest.mark.parametrize("nwin", [1, 7, 48, 49, 121])
def test_block_resolvers_match_jax(nwin):
    for wb in (None, 0, 1, 3, nwin, nwin + 5):
        assert pap._resolve_win_block(nwin, wb) == jpx._resolve_win_block(nwin, wb)
    for use_kernel in (False, True):
        for lb in (None, 0, 4, 10 ** 6):
            assert (pap._resolve_lagmax_block(nwin, use_kernel, lb)
                    == jpx._resolve_lagmax_block(nwin, use_kernel, lb))


def test_kernel_decision_and_no_launch_on_cpu():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    n = pap.PALLAS_MIN_CH
    assert pap._decide_kernel(n, None, cuda) and not pap._decide_kernel(n - 1, None, cuda)
    assert not pap._decide_kernel(10 ** 5, None, cpu)
    assert pap._decide_kernel(4, True, cpu) and not pap._decide_kernel(10 ** 5, False, cuda)
    before = (pcs.launches, pla.launches)
    pap.xcorr_all_pairs_peak(torch.from_numpy(_record(10, 9, 300)), 64, src_chunk=4,
                             use_kernel=True, device="cpu")
    assert (pcs.launches, pla.launches) == before


def test_entries_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pap.xcorr_all_pairs_peak(np.zeros((4, 300), np.float32), 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pwl.make_ambient_record(4, 300)


def test_bound_counts_at_config_4():
    """The bytes and operations the bounds in chip_smoke.py are made of, at
    one config-4 launch (64 source rows x 10000 receivers, 7 windows, 513
    frequencies; 64 x 512 lag rows of 1024)."""
    assert pcs.bytes_moved(64, 10000, 7, 513) == 8 * ((64 + 10000) * 7 * 513
                                                       + 64 * 10000 * 513)
    assert pcs.bytes_moved(64, 10000, 7, 513, "bf16") == 4 * (64 + 10000) * 7 * 513 + 8 * (
        64 * 10000 * 513) == 2_771_119_296
    assert pcs.flops(64, 10000, 7, 513) == 18_385_920_000
    assert pla.bytes_moved(64 * 512, 1024) == 4 * 64 * 512 * 1025
