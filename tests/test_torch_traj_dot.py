"""The "dot" finish of the trajectory gather (``das_diff_veh_tpu_torch.ops.
traj_gather.traj_follow_correlate_dot``): its plain version against the JAX
Pallas kernel ``_dot_kernel`` in interpret mode, both precision tiers, the
joint shape gate with the JAX error texts, and the routing of
``xcorr_traj_follow``.  The CUDA kernel is held against the plain version on
the card in tests/test_torch_cuda.py.

Tolerances: XLA's HIGHEST dot sums the wlen products in its own order and
the plain version in ascending order, so the two agree to float rounding:
1e-12 peak-relative in float64 and 1e-6 in float32.  In the bf16 tier both
round the operands through bfloat16 and sum exact products in float32, in
their own orders: 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das_diff_veh_tpu.ops import pallas_gather as pg
from das_diff_veh_tpu.ops import xcorr as jx
from das_diff_veh_tpu_torch.ops import traj_gather as tg
from das_diff_veh_tpu_torch.ops import xcorr as px

NCH, NT, WLEN, NSAMP, PIVOT = 10, 2000, 250, 800, 6
OFFSET = WLEN // 2
NWIN = (NSAMP - WLEN) // OFFSET + 1
CH = np.array([2, 3, 5, 7])
RNG = np.random.default_rng(53)
# dt_idx per case: in range, at/near the record end, and (backward) the
# numpy empty slice start < nsamp; backward cases run with swap, as the
# time-reversed side of xcorr_traj_follow does
CASES = {
    "forward": (np.array([250, 500, 750, 1000]), False),
    "backward": (np.array([900, 1200, 1500, 1999]), True),
    "forward_edge_truncated": (np.array([1725, 1875, 1999, 1000]), False),
    "backward_edge_truncated": (np.array([1725, 1875, 1999, 2000]), True),
    "backward_empty": (np.array([25, 125, 875, 1250]), True),
}
TOL = {np.float64: 1e-12, np.float32: 1e-6}
BF16_TOL = 1e-5
GATHER_DOT_BF16_BUDGET = 2e-2      # tests/test_precision.py


def _peak_rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _port(data, dt_idx, backward, swap, **kw):
    return tg.traj_follow_correlate_dot(torch.from_numpy(data), PIVOT, torch.from_numpy(CH),
                                        torch.from_numpy(dt_idx), NSAMP, WLEN, OFFSET,
                                        backward=backward, swap=swap, **kw).numpy()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dot_plain_matches_jax_kernel_interpret(case, dtype):
    dt_idx, backward = CASES[case]
    data = RNG.standard_normal((NCH, NT)).astype(dtype)
    want = np.asarray(pg.traj_follow_correlate_dot(
        jnp.asarray(data), PIVOT, jnp.asarray(CH), jnp.asarray(dt_idx), NSAMP, WLEN, OFFSET,
        backward=backward, swap=backward, interpret=True))
    got = _port(data, dt_idx, backward, backward)
    assert got.shape == want.shape == (CH.size, WLEN) and got.dtype == want.dtype
    assert _peak_rel(got, want) <= TOL[dtype]
    if case == "backward_empty":
        assert not got[:2].any() and np.abs(got[2:]).max() > 0


@pytest.mark.parametrize("swap", [False, True])
def test_dot_swap_matches_jax(swap):
    """``swap`` alone (not tied to the window direction) exchanges the
    operands, as in the Pallas kernel."""
    dt_idx = np.array([250, 500, 750, 1000])
    data = RNG.standard_normal((NCH, NT))
    want = np.asarray(pg.traj_follow_correlate_dot(
        jnp.asarray(data), PIVOT, jnp.asarray(CH), jnp.asarray(dt_idx), NSAMP, WLEN, OFFSET,
        swap=swap, interpret=True))
    assert _peak_rel(_port(data, dt_idx, False, swap), want) <= 1e-12


@pytest.mark.parametrize("reverse", [False, True])
def test_dot_finish_matches_rfft_finish(reverse):
    """The dot finish is the rfft finish's circular correlation in the time
    domain (the JAX package ties the two at 1e-7; float64 gives ~1e-13)."""
    data = torch.from_numpy(RNG.standard_normal((NCH, NT)))
    args = (data, torch.arange(NT, dtype=torch.float64) * 0.004, PIVOT, torch.from_numpy(CH),
            torch.tensor([1.0, 2.0, 3.0, 7.9], dtype=torch.float64), NSAMP, WLEN)
    dot = px.xcorr_traj_follow(*args, reverse=reverse, mode="fused", finish="dot")
    rfft = px.xcorr_traj_follow(*args, reverse=reverse, mode="fused", finish="rfft")
    assert _peak_rel(dot.numpy(), rfft.numpy()) <= 1e-12


# ---- the precision tiers, on tests/test_precision.py's record and geometry ----

def _precision_args(as_torch):
    rec = np.random.default_rng(20).standard_normal((24, 1024)).astype(np.float32)
    t_axis = np.arange(1024) * 0.004
    ch = np.arange(4, 12)
    t_at = 0.5 + 0.02 * np.arange(8)
    conv = torch.from_numpy if as_torch else jnp.asarray
    return (conv(rec), conv(t_axis), 2, conv(ch), conv(t_at)), dict(nsamp=512, wlen=128,
                                                                    overlap_ratio=0.5)


def _port_traj(**kw):
    args, geo = _precision_args(True)
    return px.xcorr_traj_follow(*args, mode="fused", **geo, **kw).numpy()


def test_dot_bf16_matches_jax_bf16():
    args, geo = _precision_args(False)
    want = np.asarray(jx.xcorr_traj_follow(*args, mode="fused", finish="dot", interpret=True,
                                           precision="bf16", **geo))
    got = _port_traj(finish="dot", precision="bf16")
    f32 = _port_traj(finish="dot")
    assert got.dtype == want.dtype == np.float32
    assert _peak_rel(got, want) <= BF16_TOL
    assert not np.array_equal(got, f32), "the bf16 tier must change bits"
    assert _peak_rel(got, f32) < GATHER_DOT_BF16_BUDGET


def test_dot_f32_default_and_rfft_ignores_precision():
    assert np.array_equal(_port_traj(finish="dot"), _port_traj(finish="dot", precision="f32"))
    assert np.array_equal(_port_traj(finish="rfft"), _port_traj(finish="rfft", precision="bf16"))


def test_dot_bf16_in_float64_casts_like_jax():
    """Float64 data: the bf16 tier contracts in float32 and casts the window
    correlations back to float64 before the window mean, as the Pallas
    kernel does."""
    dt_idx, backward = CASES["backward_edge_truncated"]
    data = RNG.standard_normal((NCH, NT))
    want = np.asarray(pg.traj_follow_correlate_dot(
        jnp.asarray(data), PIVOT, jnp.asarray(CH), jnp.asarray(dt_idx), NSAMP, WLEN, OFFSET,
        backward=True, swap=True, interpret=True, precision="bf16"))
    got = _port(data, dt_idx, True, True, precision="bf16")
    assert got.dtype == want.dtype == np.float64
    assert _peak_rel(got, want) <= BF16_TOL


# ---- the gate ----

GATE_GRID = [(nwin, wlen, finish) for nwin in (0, 1, 6, 15, 16, 17, 64, 65)
             for wlen in (33, 250, 256, 257, 512) for finish in ("rfft", "dot")]


def test_fused_supported_matches_jax():
    for nwin, wlen, finish in GATE_GRID:
        assert tg.fused_supported(nwin, wlen, finish) == pg.fused_supported(nwin, wlen, finish)
        caps = dict(max_nwin=8, dot_max_wlen=512, dot_max_elems=1 << 21)
        assert (tg.fused_supported(nwin, wlen, finish, **caps)
                == pg.fused_supported(nwin, wlen, finish, **caps)), (nwin, wlen, finish)


def test_gate_refusals_name_the_jax_knobs():
    """Mirrors tests/test_pallas_gather.py::test_invalid_knobs_rejected."""
    data = torch.zeros((NCH, NT), dtype=torch.float64)
    args = (data, torch.arange(NT, dtype=torch.float64) * 0.004, PIVOT, torch.from_numpy(CH),
            torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64))
    big_wlen = tg.DOT_MAX_WLEN + 2
    with pytest.raises(ValueError, match="dot_max_wlen"):
        px.xcorr_traj_follow(*args, 4 * big_wlen, big_wlen, mode="fused", finish="dot")
    nwin_many = 17                                      # 17*256^2 > 2^20
    nsamp_many = (nwin_many - 1) * (tg.DOT_MAX_WLEN // 2) + tg.DOT_MAX_WLEN
    assert not tg.fused_supported(nwin_many, tg.DOT_MAX_WLEN, "dot")
    with pytest.raises(ValueError, match="dot_max_matrix_elems"):
        px.xcorr_traj_follow(*args, nsamp_many, tg.DOT_MAX_WLEN, mode="fused", finish="dot")
    small_wlen = 16
    nsamp_big = (tg.FUSED_MAX_NWIN + 2) * (small_wlen // 2) + small_wlen
    assert not tg.fused_supported(tg.FUSED_MAX_NWIN + 2, small_wlen, "rfft")
    for finish in ("rfft", "dot"):
        with pytest.raises(ValueError, match="fused_max_nwin"):
            px.xcorr_traj_follow(*args, nsamp_big, small_wlen, mode="fused", finish=finish)
    with pytest.raises(ValueError, match="at least one window"):
        tg.traj_follow_correlate_dot(data, PIVOT, torch.tensor([1]), torch.tensor([0]),
                                     100, WLEN, OFFSET)
    with pytest.raises(ValueError, match="precision"):
        tg.traj_follow_correlate_dot(data, PIVOT, torch.tensor([1]), torch.tensor([0]),
                                     NSAMP, WLEN, OFFSET, precision="tf32")
    # tuned caps let through what the defaults refuse
    out = px.xcorr_traj_follow(*args, nsamp_many, tg.DOT_MAX_WLEN, mode="fused",
                               finish="dot", dot_max_elems=1 << 21)
    assert out.shape == (CH.size, tg.DOT_MAX_WLEN)


def test_auto_takes_the_dot_finish_inside_the_caps_only():
    """``"auto"`` routes a dot finish inside the caps to the dot wrapper and
    one outside them to the serialized rfft cut, as JAX's gate does."""
    data = torch.from_numpy(RNG.standard_normal((NCH, NT)))
    args = (data, torch.arange(NT, dtype=torch.float64) * 0.004, PIVOT, torch.from_numpy(CH),
            torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64))
    for nsamp, wlen in ((NSAMP, WLEN), (4 * 300, 300)):
        auto = px.xcorr_traj_follow(*args, nsamp, wlen, mode="auto", finish="dot")
        inside = tg.fused_supported((nsamp - wlen) // (wlen // 2) + 1, wlen, "dot")
        ref = px.xcorr_traj_follow(*args, nsamp, wlen, mode="fused" if inside else "serialized",
                                   finish="dot")
        assert inside == (wlen == WLEN)
        assert torch.equal(auto, ref)


def test_empty_channel_set():
    data = torch.zeros((3, NCH, NT))
    none = torch.zeros(0, dtype=torch.long)
    out = tg.traj_follow_correlate_dot(data, PIVOT, none, torch.zeros((3, 0), dtype=torch.long),
                                       NSAMP, WLEN, OFFSET)
    assert out.shape == (3, 0, WLEN)
    out = tg.traj_follow_correlate_dot(data[0], PIVOT, none, none, NSAMP, WLEN, OFFSET)
    assert out.shape == (0, WLEN)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_batched_call_equals_per_slot_calls(precision):
    """The port correlates every window slot in one call; each slot equals
    its own unbatched call bit for bit."""
    data = RNG.standard_normal((3, NCH, NT)).astype(np.float32)
    dt_idx = RNG.integers(0, NT + 1, size=(3, CH.size))
    batched = _port(data, dt_idx, True, True, precision=precision)
    for b in range(3):
        assert np.array_equal(batched[b], _port(data[b], dt_idx[b], True, True,
                                                precision=precision))


def test_dot_flops_and_bytes_count_valid_windows():
    scal = tg.traj_scalars(torch.tensor([[100, 1900]]), torch.tensor([2, 3]), NCH, NT,
                           NSAMP, backward=False)
    # (ch 2, start 100): all 5 windows valid; (ch 3, start 1900): none
    assert tg.dot_flops(scal, NWIN, WLEN, OFFSET) == 2 * 5 * WLEN * WLEN
    nbytes = tg.bytes_moved(scal, NCH, NT, PIVOT, NWIN, WLEN, OFFSET, out_elems=2 * WLEN)
    assert nbytes == 4 * (2 * 750 + 2 * WLEN) + scal.numel() * 4


# ---- the GEMM layout of the kernel's bf16 tier (correlate_dot_gemm_plain) ----

GEMM_WLENS = [1, 5, 8, 33, 64, 250, 256]


def _gemm_case(wlen, seed):
    """A 3-window record and, per trajectory direction, starts with full,
    truncated and empty rows: (data, [(dt_idx, backward, swap), ...])."""
    offset = max(1, wlen // 2)
    nsamp = 2 * offset + wlen
    nt = 4 * nsamp + 40
    data = np.random.default_rng(seed).standard_normal((NCH, nt))
    forward = np.array([0, nsamp, nt - nsamp + offset + 1, nt])       # full, full, truncated, empty
    backward = np.array([nsamp + 5, nt, nt + offset + 1, nsamp - 1])  # ..., truncated, empty slice
    return data, offset, nsamp, [(forward, False, False), (backward, True, True)]


def _dot_rows(fn, data, dt_idx, backward, swap, offset, nsamp, wlen, precision):
    t = torch.from_numpy(data)
    scal = tg.traj_scalars(torch.from_numpy(dt_idx), torch.from_numpy(CH), NCH, data.shape[1],
                           nsamp, backward)
    nwin = (nsamp - wlen) // offset + 1
    return fn(t[None], scal[None], PIVOT, nwin, wlen, offset, swap, precision)[0].numpy(), scal


@pytest.mark.parametrize("wlen", GEMM_WLENS)
def test_gemm_layout_matches_plain_float64(wlen):
    """The kernel's M/K padding and zero fill: equal to the direct sum up to
    float64 rounding, with swap, truncated and empty rows."""
    data, offset, nsamp, cases = _gemm_case(wlen, 60 + wlen)
    for dt_idx, backward, swap in cases:
        got, scal = _dot_rows(tg.correlate_dot_gemm_plain, data, dt_idx, backward, swap,
                              offset, nsamp, wlen, "f32")
        want, _ = _dot_rows(tg.correlate_dot_plain, data, dt_idx, backward, swap, offset,
                            nsamp, wlen, "f32")
        assert got.dtype == np.float64 and got.shape == (CH.size, wlen)
        assert _peak_rel(got, want) <= TOL[np.float64]
        empty = (scal[:, 1] < wlen).numpy()
        assert empty.any() and not got[empty].any()
        assert np.abs(got[~empty]).max() > 0


@pytest.mark.parametrize("wlen", GEMM_WLENS)
def test_gemm_layout_matches_plain_bf16(wlen):
    """bfloat16 operands, float32 sums in the matmul's order against the
    plain version's sequential order."""
    data, offset, nsamp, cases = _gemm_case(wlen, 70 + wlen)
    data = data.astype(np.float32)
    for dt_idx, backward, swap in cases:
        got, _ = _dot_rows(tg.correlate_dot_gemm_plain, data, dt_idx, backward, swap, offset,
                           nsamp, wlen, "bf16")
        want, _ = _dot_rows(tg.correlate_dot_plain, data, dt_idx, backward, swap, offset,
                            nsamp, wlen, "bf16")
        assert got.dtype == np.float32
        assert _peak_rel(got, want) <= BF16_TOL


@pytest.mark.parametrize("wlen", GEMM_WLENS)
def test_gemm_layout_matches_jax_bf16_interpret(wlen):
    """The same layout against the Pallas dot kernel's bf16 tier."""
    data, offset, nsamp, cases = _gemm_case(wlen, 80 + wlen)
    data = data.astype(np.float32)
    for dt_idx, backward, swap in cases:
        got, _ = _dot_rows(tg.correlate_dot_gemm_plain, data, dt_idx, backward, swap, offset,
                           nsamp, wlen, "bf16")
        want = np.asarray(pg.traj_follow_correlate_dot(
            jnp.asarray(data), PIVOT, jnp.asarray(CH), jnp.asarray(dt_idx), nsamp, wlen, offset,
            backward=backward, swap=swap, interpret=True, precision="bf16"))
        assert got.shape == want.shape
        assert _peak_rel(got, want) <= BF16_TOL
