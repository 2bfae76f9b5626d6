"""Tests of the port that need the card: the CUDA kernels against their plain
PyTorch versions, a small chunk on the card against the CPU, the batch loop,
and the fused chunk's CUDA graph against the staged chunk.

They carry the ``cuda`` marker and skip without a CUDA device.  The file
imports neither JAX nor the JAX package, so on a machine without JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from das_diff_veh_tpu_torch.ops import traj_gather as tg  # noqa: E402

pytestmark = pytest.mark.cuda

NCH, NT, WLEN, NSAMP, PIVOT = 10, 2000, 250, 800, 6
OFFSET = WLEN // 2
NWIN = (NSAMP - WLEN) // OFFSET + 1
CH = [2, 3, 5, 7]
CASES = {
    "forward": ([250, 500, 750, 1000], False),
    "backward": ([900, 1200, 1500, 1999], True),
    "forward_edge_truncated": ([1725, 1875, 1999, 1000], False),
    "backward_edge_truncated": ([1725, 1875, 1999, 2400], True),
    "backward_empty": ([25, 125, 875, 1250], True),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(CASES))
def test_traj_gather_kernel_equals_plain(card, case):
    dt_idx, backward = CASES[case]
    gen = torch.Generator(device=card).manual_seed(3)
    rec = torch.randn((4, NCH, NT), generator=gen, device=card)
    idx = torch.tensor(dt_idx, device=card).expand(4, -1)
    scal = tg.traj_scalars(idx, torch.tensor(CH, device=card), NCH, NT, NSAMP,
                           backward).contiguous()
    before = tg.launches
    k = tg.pack_windows_cuda(rec, scal, PIVOT, NWIN, WLEN, OFFSET)
    p = tg.pack_windows_plain(rec, scal, PIVOT, NWIN, WLEN, OFFSET)
    torch.cuda.synchronize()
    assert tg.launches == before + 1
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    if case == "backward_empty":
        assert not k[0][:, :2].any()


# (nb, nk, nsamp, wlen, offset, backward) of the flat, 16-byte-store layout's
# edges: rows of 99 floats (wlen 33, not a multiple of 4, so groups of 4
# straddle windows and rows), one channel, the main path's grid of 64 slots
# x 25 rows, and windows of 1 and 3 samples (a group of 4 spans windows)
B1_SHAPES = {"wlen33_rows_of_99": (8, 10, 99, 33, 33, False),
             "nk1": (64, 1, 999, 500, 250, True),
             "main_grid_64x25": (64, 25, 999, 500, 250, True),
             "wlen1": (3, 5, 7, 1, 2, False),
             "wlen3_nwin1": (5, 3, 3, 3, 1, True)}


@pytest.mark.parametrize("shape", sorted(B1_SHAPES))
def test_traj_gather_kernel_equals_plain_at_layout_edges(card, shape):
    """Starts at every alignment mod 4, rows truncated at the record end and
    empty: the cut is a copy, so equal bit for bit."""
    nb, nk, nsamp, wlen, offset, backward = B1_SHAPES[shape]
    nch, nt = 37, 2000
    nwin = (nsamp - wlen) // offset + 1
    gen = torch.Generator(device=card).manual_seed(5)
    rec = torch.randn((nb, nch, nt), generator=gen, device=card)
    idx = torch.randint(0, nt + nsamp, (nb, nk), generator=gen, device=card)
    idx.view(-1)[:4] = torch.arange(4, device=card) + (nsamp if backward else 0)  # base % 4
    ch = torch.arange(nk, device=card) % (nch - 1)
    scal = tg.traj_scalars(idx, ch, nch, nt, nsamp, backward).contiguous()
    assert set((scal[..., 0] % 4).flatten().tolist()) == {0, 1, 2, 3}
    before = tg.launches
    k = tg.pack_windows_cuda(rec, scal, nch - 1, nwin, wlen, offset)
    p = tg.pack_windows_plain(rec, scal, nch - 1, nwin, wlen, offset)
    torch.cuda.synchronize()
    assert tg.launches == before + 1
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def test_traj_follow_windows_one_launch_for_all_slots(card):
    rec = torch.randn((64, 37, NT), device=card)
    before = tg.launches
    wc, wp, n = tg.traj_follow_windows(rec, 28, torch.arange(10, 28, device=card),
                                       torch.randint(0, NT, (64, 18), device=card),
                                       999, 500, 250, backward=True)
    assert tg.launches == before + 1
    assert wc.shape == wp.shape == (64, 18, 2, 500) and n.shape == (64, 18)
    cpu = tg.traj_follow_windows(rec.cpu(), 28, torch.arange(10, 28),
                                 torch.zeros(64, 18, dtype=torch.long), 999, 500, 250)
    assert cpu[0].device.type == "cpu" and tg.launches == before + 1


def test_traj_gather_rejects_what_the_kernel_does_not_take(card):
    scal = torch.zeros((1, 1, 3), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="float32"):
        tg.pack_windows_cuda(torch.zeros((1, NCH, NT), dtype=torch.float64, device=card),
                             scal, PIVOT, NWIN, WLEN, OFFSET)
    with pytest.raises(ValueError, match="contiguous"):
        tg.pack_windows_cuda(torch.zeros((1, NT, NCH), device=card).transpose(1, 2),
                             scal, PIVOT, NWIN, WLEN, OFFSET)
    with pytest.raises(ValueError, match="int32"):
        tg.pack_windows_cuda(torch.zeros((1, NCH, NT), device=card), scal.long(),
                             PIVOT, NWIN, WLEN, OFFSET)


def test_small_chunk_on_card_matches_cpu(card):
    from das_diff_veh_tpu_torch.config import ImagingConfig, PipelineConfig
    from das_diff_veh_tpu_torch.io.synthetic import SceneConfig, synthesize_section
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    sec, _ = synthesize_section(SceneConfig(nch=100, duration=120.0, n_vehicles=4,
                                            seed=11, speed_range=(12.0, 18.0)))
    cfg = PipelineConfig().replace(imaging=ImagingConfig(x0=400.0))
    tg.launches = 0
    got = process_chunk(sec.to(dtype=torch.float32), cfg, device=card)
    assert tg.launches == 2
    want = process_chunk(sec, cfg, device="cpu")
    assert got.n_windows == want.n_windows > 0
    assert torch.equal(got.batch.valid.cpu(), want.batch.valid)
    err = (got.disp_image.double().cpu() - want.disp_image).abs().max()
    # float32 against float64, the same bound and reason as chip_smoke.py
    assert float(err / want.disp_image.abs().max()) <= 1e-3


# ---- the dot finish: B2 (traj_dot.cu) ----

# (wlen, nsamp): the dot chunk's 250 samples (nwin 6), a whole-warp 256 at
# nwin 16 (nwin*wlen^2 = 2^20, the cap), 64, 33 (off the warp width), and
# 64 windows of 128 (the gate's other corner, nwin*wlen^2 = 2^20: the
# windows pass through shared memory 8 at a time), and the kernel's longest
# window, 3072 (one window a group, past 48 KB of shared memory in f32)
DOT_SHAPES = {"w250": (250, 999), "w256_nwin16": (256, 15 * 128 + 256),
              "w64": (64, 300), "w33_nwin1": (33, 40), "w128_nwin64": (128, 63 * 64 + 128),
              "w3072_nwin2": (3072, 3072 + 1536)}
# The bf16 tier on the tensor cores: the bfloat16 products are exact in
# float32, but the tensor core sums them in its own order, so the tier is
# held at 1e-5 peak-relative per launch (tests/test_torch_traj_dot.py's
# BF16_TOL) against the plain version's sequential float32 sum and against
# a float64 evaluation of the same bfloat16 operands.
DOT_BF16_TOL = 1e-5


def _peak_rel(a, ref):
    a, ref = a.double().cpu(), ref.double().cpu()
    return float((a - ref).abs().max() / ref.abs().max().clamp(min=1e-300))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(DOT_SHAPES))
def test_traj_dot_kernel_equals_plain(card, shape, precision):
    """f32: every product and sum rounded where the plain version rounds it,
    in the same order, so equal bit for bit; bf16: within DOT_BF16_TOL of
    the plain version and of float64.  Forward and swapped, with rows
    truncated at the record end and backward empty slices."""
    from das_diff_veh_tpu_torch.ops.precision import bf16_round

    wlen, nsamp = DOT_SHAPES[shape]
    offset = wlen // 2
    nwin = (nsamp - wlen) // offset + 1
    gen = torch.Generator(device=card).manual_seed(13)
    nb, nch, nt = 8, 12, max(3000, nsamp + 600)
    rec = torch.randn((nb, nch, nt), generator=gen, device=card)
    ch = torch.arange(1, 11, device=card)
    for backward, swap in ((False, False), (True, True), (False, True)):
        idx = torch.randint(0, nt + 300, (nb, ch.numel()), generator=gen, device=card)
        scal = tg.traj_scalars(idx, ch, nch, nt, nsamp, backward).contiguous()
        before = tg.dot_launches
        k = tg.correlate_dot_cuda(rec, scal, 5, nwin, wlen, offset, swap, precision)
        p = tg.correlate_dot_plain(rec, scal, 5, nwin, wlen, offset, swap, precision)
        torch.cuda.synchronize()
        assert tg.dot_launches == before + 1
        assert k.shape == (nb, ch.numel(), wlen)
        if precision == "f32":
            assert torch.equal(k, p), (backward, swap)
        else:
            f64 = tg.correlate_dot_plain(bf16_round(rec).double(), scal, 5, nwin, wlen, offset,
                                         swap)
            assert _peak_rel(k, p) <= DOT_BF16_TOL, (backward, swap)
            assert _peak_rel(k, f64) <= DOT_BF16_TOL, (backward, swap)
        empty = scal[..., 1] < wlen
        assert not k[empty].any()


def test_traj_dot_one_launch_for_all_slots_and_rejects(card):
    rec = torch.randn((64, 37, 2000), device=card)
    before = tg.dot_launches
    out = tg.traj_follow_correlate_dot(rec, 28, torch.arange(10, 28, device=card),
                                       torch.randint(0, 2000, (64, 18), device=card),
                                       999, 250, 125, backward=True, swap=True)
    assert tg.dot_launches == before + 1 and out.shape == (64, 18, 250)
    scal = torch.zeros((1, 1, 3), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="float32"):
        tg.correlate_dot_cuda(rec[:1].double(), scal, 5, 6, 250, 125)
    with pytest.raises(ValueError, match="int32"):
        tg.correlate_dot_cuda(rec[:1].contiguous(), scal.long(), 5, 6, 250, 125)
    with pytest.raises(ValueError, match="precision"):
        tg.correlate_dot_cuda(rec[:1].contiguous(), scal, 5, 6, 250, 125, precision="fp8")
    with pytest.raises(ValueError, match="wlen <= 3072"):
        tg.correlate_dot_cuda(rec[:1].contiguous(), scal, 5, 1, tg.DOT_KERNEL_MAX_WLEN + 1, 1)
    with pytest.raises(ValueError, match="offset >= 1"):
        tg.correlate_dot_cuda(rec[:1].contiguous(), scal, 5, 1, 250, 0)


def test_small_dot_chunk_on_card_matches_cpu(card, monkeypatch):
    """16 s windows at the default 8 s isolation spacing, so that the
    time-reversed rows near the pivot are live (with the default 8 s window
    every one is a backward empty slice) and the image and the stack see
    both of B2's launches."""
    import dataclasses

    from das_diff_veh_tpu_torch.config import ImagingConfig, PipelineConfig
    from das_diff_veh_tpu_torch.io.synthetic import SceneConfig, synthesize_section
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    sec, _ = synthesize_section(SceneConfig(nch=100, duration=120.0, n_vehicles=4,
                                            seed=11, speed_range=(12.0, 18.0)))
    cfg = PipelineConfig().replace(imaging=ImagingConfig(x0=400.0))
    cfg = cfg.replace(gather=dataclasses.replace(cfg.gather, wlen=1.0, traj_gather_finish="dot"),
                      window=dataclasses.replace(cfg.window, wlen_sw=16.0, temporal_spacing=8.0))
    outs, launch = [], tg.correlate_dot_cuda

    def recording(*args):
        outs.append(launch(*args))
        return outs[-1]

    monkeypatch.setattr(tg, "correlate_dot_cuda", recording)
    tg.launches = tg.dot_launches = 0
    got = process_chunk(sec.to(dtype=torch.float32), cfg, device=card)
    assert (tg.launches, tg.dot_launches) == (0, 2)
    want = process_chunk(sec, cfg, device="cpu")
    assert got.n_windows == want.n_windows > 0
    assert torch.equal(got.batch.valid.cpu(), want.batch.valid)
    for name in ("disp_image", "vsg_stack"):
        a, b = getattr(got, name).double().cpu(), getattr(want, name)
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-3, name
    # both launches (main side, then time-reversed) have live rows in valid slots
    assert [o.shape[0] for o in outs] == [64, 64]
    assert all(bool(o[got.batch.valid].abs().amax(-1).gt(0).any()) for o in outs)


# ---- the all-pairs kernels: B3 (cross_spectra.cu) and B4 (lag_absmax.cu) ----

# (m, nall, nwin, nf, win_block), chip_smoke.py's B3 edge cases at smaller
# receiver counts: one, 63 and 64 source rows (the resident group is 64);
# fewer receivers than one 16-row tile; 513 frequencies (16 segments of 32
# and a one-frequency tail), 33 and 1 (a tail alone); a ragged slab (7 = 3 +
# 3 + 1); and the automatic 32-window slabs past 48 windows, streamed
B3_CASES = {
    "one_source_ragged_slab": (1, 37, 7, 513, 3),
    "m63_one_slab": (63, 100, 7, 513, None),
    "m64_nall_below_tile_nf33": (64, 5, 7, 33, None),
    "nf1": (7, 300, 7, 1, None),
    "auto_slabs_nwin50": (9, 50, 50, 33, None),
    "auto_slabs_nwin119": (64, 40, 119, 513, None),
}


def _spectra(card, n, nwin, nf, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    return torch.randn((n, nwin, nf), generator=gen, device=card, dtype=torch.complex64)


def _tier(x, precision):
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs

    return cs.to_bf16_pairs(x) if precision == "bf16" else x.contiguous()


def _same(a, b):
    """Equal bit for bit, NaN where NaN (torch.equal counts NaN unequal)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(B3_CASES))
def test_cross_spectra_kernel_equals_plain(card, case, precision):
    from das_diff_veh_tpu_torch.ops import all_pairs as ap
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs

    m, nall, nwin, nf, wb = B3_CASES[case]
    wb = ap._resolve_win_block(nwin, wb)
    rcv = _spectra(card, nall, nwin, nf, 5)
    src = rcv[:m] if m <= nall else _spectra(card, m, nwin, nf, 6)
    src, rcv = _tier(src, precision), _tier(rcv, precision)
    before = cs.launches
    k = cs.cross_spectra(src, rcv, nwin, wb)
    p = cs.cross_spectra_plain(src, rcv, nwin, wb)
    torch.cuda.synchronize()
    assert cs.launches == before + 1
    assert k.shape == (m, nall, nf) and k.dtype == torch.complex64
    # the kernel rounds every product and sum where the plain version does
    assert torch.equal(k, p)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cross_spectra_pairs_do_not_depend_on_tiling(card, precision):
    """One pair's sum is the same bits whatever the number of source rows in
    the launch and whatever receiver set it runs against."""
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs

    rcv = _spectra(card, 300, 7, 513, 8)
    full = cs.cross_spectra_cuda(_tier(rcv[:64], precision), _tier(rcv, precision), 7, 7)
    few = cs.cross_spectra_cuda(_tier(rcv[:16], precision), _tier(rcv, precision), 7, 7)
    subset = cs.cross_spectra_cuda(_tier(rcv[:16], precision),
                                   _tier(rcv[101:250], precision), 7, 7)
    assert torch.equal(full[:16], few)
    assert torch.equal(few[:, 101:250], subset)


@pytest.mark.parametrize("nlag", [1024, 1023, 5])
def test_lag_absmax_kernel_equals_plain(card, nlag):
    from das_diff_veh_tpu_torch.ops import lag_absmax as la

    gen = torch.Generator(device=card).manual_seed(9)
    lag = torch.randn((1000, nlag), generator=gen, device=card)
    lag[3, nlag // 2] = float("nan")
    lag[5] = 0.0
    before = la.launches
    k = la.lag_absmax(lag)
    p = la.lag_absmax_plain(lag)
    torch.cuda.synchronize()
    assert la.launches == before + 1
    assert torch.isnan(k[3]) and k[5] == 0.0
    assert _same(k, p)


def test_all_pairs_kernels_reject_what_they_do_not_take(card):
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.ops import lag_absmax as la

    s = _spectra(card, 4, 7, 33, 1)
    with pytest.raises(ValueError, match="complex64"):
        cs.cross_spectra_cuda(s.to(torch.complex128), s, 7, 7)
    with pytest.raises(ValueError, match="contiguous"):
        cs.cross_spectra_cuda(s, s.transpose(0, 1).contiguous().transpose(0, 1), 7, 7)
    with pytest.raises(ValueError, match="win_block"):
        cs.cross_spectra_cuda(s, s, 7, 8)
    b = cs.to_bf16_pairs(s)
    with pytest.raises(ValueError, match="bfloat16"):      # the tiers mixed
        cs.cross_spectra_cuda(b, s, 7, 7)
    with pytest.raises(ValueError, match="bfloat16"):      # float16 pairs
        cs.cross_spectra_cuda(b, b.to(torch.float16), 7, 7)
    with pytest.raises(ValueError, match="complex64"):     # bf16 receivers, f32 sources
        cs.cross_spectra_cuda(s, b, 7, 7)
    with pytest.raises(ValueError, match="contiguous"):
        cs.cross_spectra_cuda(b, b.transpose(0, 1).contiguous().transpose(0, 1), 7, 7)
    with pytest.raises(ValueError, match="float32"):
        la.lag_absmax_cuda(torch.zeros((4, 8), dtype=torch.float64, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        la.lag_absmax_cuda(torch.zeros((8, 4), device=card).t())


def test_all_pairs_peak_on_card(card):
    """A small record through the kernel path on the card: the launch counts,
    the card's plain path bit for bit, and the CPU plain path at float32."""
    from das_diff_veh_tpu_torch.ops import all_pairs as ap
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.ops import lag_absmax as la
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    rec = make_ambient_record(100, 1200, seed=4, device=card)
    kw = dict(src_chunk=16, use_kernel=True, lagmax_block=32)
    cs.launches = la.launches = 0
    got = ap.xcorr_all_pairs_peak(rec, 128, device=card, **kw)
    torch.cuda.synchronize()
    assert (cs.launches, la.launches) == (7, 7 * 4)     # ceil(100/16), x ceil(100/32)
    cuda_fns = cs.cross_spectra_cuda, la.lag_absmax_cuda
    try:
        cs.cross_spectra_cuda, la.lag_absmax_cuda = cs.cross_spectra_plain, la.lag_absmax_plain
        plain = ap.xcorr_all_pairs_peak(rec, 128, device=card, **kw)
    finally:
        cs.cross_spectra_cuda, la.lag_absmax_cuda = cuda_fns
    assert torch.equal(got, plain)
    cpu = ap.xcorr_all_pairs_peak(rec.cpu(), 128, device="cpu", **kw)
    # cuFFT and pocketfft round float32 differently (~1e-7 peak-relative)
    assert float((got.cpu() - cpu).abs().max() / cpu.abs().max()) <= 1e-5


# ---- the batch loop: the health screen and run_directory on the card ----

def test_health_screen_on_card_equals_cpu(card):
    """Every operation of the screen is exact, so the card's screen of the
    float32 data is the CPU's bit for bit: the sanitised data, the mask and
    every ChannelHealth field."""
    import numpy as np

    from das_diff_veh_tpu_torch.config import HealthConfig
    from das_diff_veh_tpu_torch.resilience.health import screen_arrays

    d = np.random.default_rng(0).standard_normal((140, 3000)).astype(np.float32)
    d[[3, 4], 100:400] = np.nan
    d[7, 9] = np.inf
    d[9] = 0.5
    d[20, ::3] = 6.0
    d[139] = 0.0
    for cfg in (HealthConfig(enabled=True),
                HealthConfig(enabled=True, clip_limit=5.0, clip_fraction_max=1 / 3)):
        got_data, got = screen_arrays(torch.from_numpy(d).to(card), cfg, tag="card_test")
        want_data, want = screen_arrays(torch.from_numpy(d), cfg, tag="card_test")
        assert got_data.is_cuda and got_data.dtype == torch.float32
        assert torch.equal(got_data.cpu(), want_data)
        assert np.array_equal(got.healthy, want.healthy)
        assert got.summary() == want.summary() and got.nan_fraction == want.nan_fraction


def test_run_directory_on_card_bit_equal_at_depth_0_and_2(card, tmp_path):
    """Three files through run_directory on the card: the accumulated image
    is the same bits with the loader inline and two chunks staged ahead (a
    staging race would show as a changed image), with 2 launches of B1 per
    chunk."""
    import numpy as np

    from das_diff_veh_tpu_torch.config import ImagingConfig, PipelineConfig
    from das_diff_veh_tpu_torch.io.readers import DirectoryDataset, save_section_npz
    from das_diff_veh_tpu_torch.io.synthetic import SceneConfig, synthesize_section
    from das_diff_veh_tpu_torch.pipeline.workflow import run_directory
    from das_diff_veh_tpu_torch.runtime import RuntimeConfig

    day = tmp_path / "20230301"
    day.mkdir()
    for i, seed in enumerate((11, 12, 13)):
        sec, _ = synthesize_section(SceneConfig(nch=100, duration=120.0, n_vehicles=4,
                                                seed=seed, speed_range=(12.0, 18.0)))
        save_section_npz(str(day / f"20230301_{i:02d}0000.npz"), sec)
    cfg = PipelineConfig().replace(imaging=ImagingConfig(x0=400.0))
    runs = {}
    for depth in (0, 2, 0):
        ds = DirectoryDataset("20230301", root=str(tmp_path), ch1=None, ch2=None,
                              smoothing=False, rescale_after=None)
        tg.launches = 0
        res = run_directory(ds, cfg, x_is_channels=False,
                            runtime=RuntimeConfig(prefetch_depth=depth), device=card)
        assert tg.launches == 2 * 3 and not res.quarantined
        assert res.n_vehicles > 0 and res.avg_image.dtype == np.float32
        if depth in runs:
            assert np.array_equal(res.avg_image, runs[depth].avg_image)
        runs[depth] = res
    assert np.array_equal(runs[0].avg_image, runs[2].avg_image)
    assert runs[0].n_vehicles == runs[2].n_vehicles


# ---- the fused chunk: one CUDA graph per geometry ----

def _fused_scene(seed: int, card):
    """A 100-channel, 2-minute scene at float32 on the card and its staged
    and fused configurations (pivot 400 m)."""
    from das_diff_veh_tpu_torch.config import ImagingConfig, PipelineConfig
    from das_diff_veh_tpu_torch.io.synthetic import SceneConfig, synthesize_section

    sec, _ = synthesize_section(SceneConfig(nch=100, duration=120.0, n_vehicles=4, seed=seed,
                                            speed_range=(12.0, 18.0)))
    cfg = PipelineConfig().replace(imaging=ImagingConfig(x0=400.0))
    return sec.to(card, torch.float32), cfg, cfg.replace(chunk_pipeline="fused")


def _same_chunk(a, b) -> bool:
    """Every field of two chunk results bit for bit (NaN where NaN)."""
    import dataclasses

    pairs = [(a.disp_image, b.disp_image), (a.vsg_stack, b.vsg_stack)]
    for obj in ("tracks", "batch"):
        pairs += [(getattr(getattr(a, obj), f.name), getattr(getattr(b, obj), f.name))
                  for f in dataclasses.fields(getattr(a, obj))]
    return int(a.n_windows) == int(b.n_windows) and all(_same(x, y) for x, y in pairs)


def test_fused_chunk_on_card_equals_staged_without_aliasing_or_recapture(card):
    """The first fused call captures one graph (2 launches of B1 recorded),
    every call equals the staged chunk bit for bit, a later call leaves an
    earlier result alone, and warm calls replay without capturing."""
    from das_diff_veh_tpu_torch.pipeline import fused as F
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    F.clear_programs()
    sec, cfg, fcfg = _fused_scene(11, card)
    other, _, _ = _fused_scene(12, card)
    caps, progs, reps = F.n_captures(), F.n_programs(), F.n_replays()
    first = process_chunk(sec, fcfg, device=card)
    assert (F.n_captures(), F.n_programs(), F.n_replays()) == (caps + 1, progs + 1, reps + 1)
    assert F.programs()[-1].launches_per_replay == {"traj_gather": 2, "traj_dot": 0}
    assert first.n_windows.is_cuda and first.n_windows.dim() == 0
    kept = {k: v.clone() for k, v in (("img", first.disp_image), ("data", first.batch.data))}
    assert _same_chunk(first, process_chunk(sec, cfg, device=card))
    second = process_chunk(other, fcfg, device=card)
    assert torch.equal(first.disp_image, kept["img"]) and torch.equal(first.batch.data,
                                                                      kept["data"])
    assert second.disp_image.data_ptr() != first.disp_image.data_ptr()
    assert _same_chunk(second, process_chunk(other, cfg, device=card))
    for _ in range(3):
        process_chunk(sec, fcfg, device=card)
    assert (F.n_captures(), F.n_programs(), F.n_replays()) == (caps + 1, progs + 1, reps + 5)
    held, reserved = torch.cuda.memory_allocated(card), torch.cuda.memory_reserved(card)
    pool = F.programs()[-1].pool_bytes()
    assert pool > 0
    F.clear_programs()
    assert torch.cuda.memory_allocated(card) < held
    assert reserved - torch.cuda.memory_reserved(card) >= pool


def test_fused_body_does_not_sync_on_card(card):
    """A second eager call of the program body (the constants cached by the
    first) under ``torch.cuda.set_sync_debug_mode("error")``: no operation of
    the body synchronises with the host."""
    from das_diff_veh_tpu_torch.pipeline import fused as F
    from das_diff_veh_tpu_torch.pipeline.timelapse import resolve_chunk_metadata

    sec, _, fcfg = _fused_scene(11, card)
    x, t, _ = resolve_chunk_metadata(sec, fcfg)
    prog = F._program(sec.data.shape, sec.data.dtype, sec.data.device, x, t, fcfg, "xcorr",
                      False)
    first = prog.body(sec.data)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = prog.body(sec.data)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _same(first[0], second[0])


def test_fused_run_directory_captures_beside_the_loader(card, tmp_path):
    """Six files through run_directory with the fused chunk at prefetch depth
    2, the program cache empty: the first chunk is captured while the loader
    thread reads, pins and stages the next files (a slowed reader keeps it
    busy), and the image equals the staged run's bit for bit."""
    import time

    import numpy as np

    from das_diff_veh_tpu_torch.io.readers import DirectoryDataset
    from das_diff_veh_tpu_torch.pipeline import fused as F
    from das_diff_veh_tpu_torch.pipeline.workflow import run_directory
    from das_diff_veh_tpu_torch.runtime import RuntimeConfig, load_trace

    sec, cfg, fcfg = _fused_scene(11, card)
    day = tmp_path / "20230301"
    day.mkdir()
    for i in range(6):
        np.savez(day / f"20230301_{i:02d}0000.npz", data=sec.data.cpu().double().numpy()
                 * (1.0 + 0.01 * i), x_axis=sec.x.numpy(), t_axis=sec.t.numpy())

    class SlowReader(DirectoryDataset):
        def read(self, i):
            time.sleep(0.15)
            return super().read(i)

    runs = {}
    for name, c, depth in (("staged", cfg, 0), ("fused", fcfg, 2)):
        F.clear_programs()
        caps = F.n_captures()
        trace = str(tmp_path / f"{name}.jsonl")
        ds = SlowReader("20230301", root=str(tmp_path), ch1=None, ch2=None, smoothing=False,
                        rescale_after=None)
        runs[name] = run_directory(ds, c, x_is_channels=False, device=card,
                                   runtime=RuntimeConfig(prefetch_depth=depth, trace_path=trace))
        assert F.n_captures() == caps + (name == "fused")
        assert not runs[name].quarantined and runs[name].n_vehicles > 0
    spans = [e for e in load_trace(trace) if e["ph"] == "X"]
    first = min((e for e in spans if e["name"] == "compute"), key=lambda e: e["ts"])
    beside = [e for e in spans if e["name"] in ("read", "device_put")
              and e["tid"] != first["tid"] and e["ts"] < first["ts"] + first["dur"]
              and first["ts"] < e["ts"] + e["dur"]]
    assert beside, "no loader span overlapped the capturing chunk"
    assert np.array_equal(runs["fused"].avg_image, runs["staged"].avg_image)
    assert runs["fused"].n_vehicles == runs["staged"].n_vehicles
