"""Tests of the port that need the card: the CUDA kernels against their plain
PyTorch versions, a small chunk on the card against the CPU, the batch loop,
the fused chunk's CUDA graph against the staged chunk, the mesh (the
all-pairs ring and the sharded stack on slots of the card, a gather
demotion's recapture), the science path's forward model, misfit and
CLAHE on the card against the CPU, and the ops layers (the figure set's
gathers, the profiler window's CUDA trace, the memory sampler).

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


def test_run_directory_smooths_on_card(card, tmp_path, monkeypatch):
    """Six files of a rescaled date, savgol pre-smooth on, through
    run_directory with the fused chunk at prefetch depths 0 and 2 (the
    program cache emptied before each, so at depth 2 the first chunk is
    captured while the loader stages the next files): the loader smooths on
    the card (every ``preprocess`` span ``presmooth: "card"``, every chunk
    staged with the on-card step), each staged chunk lies within one float32 step of the
    host's ``preprocess`` and cast (largest gap over the peak at most 1e-7),
    and counts and images are the same bits at both depths."""
    import os

    import numpy as np

    from das_diff_veh_tpu_torch.io.readers import DirectoryDataset
    from das_diff_veh_tpu_torch.pipeline import fused as F
    from das_diff_veh_tpu_torch.pipeline import workflow as W
    from das_diff_veh_tpu_torch.runtime import RuntimeConfig, load_trace
    from das_diff_veh_tpu_torch.runtime.staging import Stager

    sec, _, fcfg = _fused_scene(11, card)
    day = tmp_path / "20230301"             # after the reader's 20230219: rescaled
    day.mkdir()
    ds = DirectoryDataset("20230301", root=str(tmp_path), ch1=None, ch2=None)
    for i in range(6):
        np.savez(day / f"20230301_{i:02d}0000.npz", x_axis=sec.x.numpy(), t_axis=sec.t.numpy(),
                 data=sec.data.cpu().double().numpy() * (1.0 + 0.01 * i) * ds.rescale_value)
    ds = DirectoryDataset("20230301", root=str(tmp_path), ch1=None, ch2=None)
    put = Stager.put
    staged = {}

    def spy(self, host, unit, step=None, **args):
        out = put(self, host, unit, step, **args)
        with torch.cuda.stream(self.stream):
            staged[args["key"]] = (step is not None, out.cpu())
        return out

    monkeypatch.setattr(Stager, "put", spy)

    runs = {}
    for depth in (0, 2):
        F.clear_programs()
        caps = F.n_captures()
        staged.clear()
        trace = str(tmp_path / f"depth{depth}.jsonl")
        runs[depth] = run = W.run_directory(
            ds, fcfg, x_is_channels=False, device=card,
            runtime=RuntimeConfig(prefetch_depth=depth, trace_path=trace))
        assert F.n_captures() == caps + 1
        assert not run.quarantined and run.n_vehicles > 0
        spans = [e for e in load_trace(trace) if e["ph"] == "X"]
        assert [e["args"]["presmooth"] for e in spans
                if e["name"] == "preprocess"] == ["card"] * 6
        assert sorted(staged) == [os.path.basename(p) for p in ds.files]
        for i, path in enumerate(ds.files):
            on_card, got = staged[os.path.basename(path)]
            want = ds.preprocess(ds.read(i), i).data.to(torch.float32).numpy()
            got = got.numpy()
            assert on_card and got.dtype == np.float32
            assert np.max(np.abs(got - want)) <= 1e-7 * np.max(np.abs(want))
            assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))
    first = min((e for e in spans if e["name"] == "compute"), key=lambda e: e["ts"])
    assert [e for e in spans if e["name"] == "device_put" and e["tid"] != first["tid"]
            and e["ts"] < first["ts"] + first["dur"] and first["ts"] < e["ts"] + e["dur"]], \
        "no chunk was staged while the first chunk captured"
    assert runs[0].n_vehicles == runs[2].n_vehicles
    assert np.array_equal(runs[0].avg_image, runs[2].avg_image)


# elements of float32 a put moves, in slabs of the ring
STAGED_SIZES = {"one_element": lambda per: 1, "one_slab": lambda per: per,
                "one_slab_plus_one": lambda per: per + 1,
                "slabs_17_3": lambda per: int(17.3 * per)}


@pytest.mark.parametrize("size", sorted(STAGED_SIZES))
def test_staged_float32_equals_the_host_array(card, size):
    """``Stager.put`` through the ring of pinned slabs lands the host array
    bit for bit, in one piece a slab."""
    from das_diff_veh_tpu_torch.runtime import staging
    from das_diff_veh_tpu_torch.runtime.tracing import NullTracer

    n = STAGED_SIZES[size](staging.SLAB_BYTES // 4)
    host = torch.randn(n, generator=torch.Generator().manual_seed(n))
    st = staging.Stager(card, NullTracer())
    try:
        got = st.claim(st.put(host, "ambient_stage", record=0))
        assert got.is_cuda and got.dtype == torch.float32
        assert torch.equal(got.cpu(), host)
        assert (st.bytes, st.slabs) == (4 * n, -(-4 * n // staging.SLAB_BYTES))
    finally:
        st.close()


@pytest.mark.parametrize("rows", [140, 700])
def test_staged_float64_through_a_step_equals_the_host_array(card, rows):
    """A float64 chunk (140 x 30000 in one slab, 700 x 30000 over three)
    lands as it is, and the step runs on it on the side stream."""
    from das_diff_veh_tpu_torch.runtime import staging
    from das_diff_veh_tpu_torch.runtime.tracing import NullTracer

    host = torch.randn((rows, 30000), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(rows))
    raws = []

    def step(raw):
        raws.append(raw.clone())
        return raw.to(torch.float32)

    st = staging.Stager(card, NullTracer())
    try:
        got = st.claim(st.put(host, "device_stage", step, key="a"))
        assert torch.equal(raws[0].cpu(), host)
        assert got.dtype == torch.float32 and torch.equal(got.cpu(), host.to(torch.float32))
        assert st.slabs == -(-host.numel() * 8 // staging.SLAB_BYTES)
    finally:
        st.close()


def test_staging_ring_reuses_no_slot_before_its_copy_lands(card, monkeypatch):
    """8 puts back to back through a ring of 1 MB slabs, each of other
    contents (5.3 slabs, so every slot is filled again within a put and
    across puts), from one host buffer that is rewritten as soon as a put
    returns; each staged buffer is read by a kernel queued on this thread's
    stream after ``claim`` and dropped, and every result is checked."""
    from das_diff_veh_tpu_torch.runtime import staging
    from das_diff_veh_tpu_torch.runtime.tracing import NullTracer

    monkeypatch.setattr(staging, "SLAB_BYTES", 1 << 20)
    n = int(5.3 * (1 << 20) / 4)

    def contents(i):
        return torch.randn(n, generator=torch.Generator().manual_seed(100 + i))

    buf = torch.empty(n)
    st = staging.Stager(card, NullTracer())
    tripled = []
    try:
        for i in range(8):
            buf.copy_(contents(i))
            data = st.claim(st.put(buf, "ambient_stage", record=i))
            tripled.append(data * 3)
            del data
        torch.cuda.synchronize()
        for i, t in enumerate(tripled):
            assert torch.equal(t.cpu(), contents(i) * 3), f"put {i}"
        assert st.slabs == 8 * 6
    finally:
        st.close()


# ---- the mesh: the all-pairs ring, the sharded stack, the gather ladder ----

@pytest.mark.parametrize("slots", [1, 4])
def test_ring_on_card_equals_unsharded(card, slots):
    """The ring over ``slots`` slots of the card (``make_mesh(n,
    device="cuda")``) equals the unsharded kernel path bit for bit, in every
    mode and both tiers: B3 sums one pair's windows in a fixed order
    whatever the launch's shape.  The launches: per step and slot,
    ceil(shard/src_chunk) of B3 and that times ceil(shard/lagmax_block) of
    B4."""
    from das_diff_veh_tpu_torch.config import RingConfig
    from das_diff_veh_tpu_torch.ops import all_pairs as ap
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.ops import lag_absmax as la
    from das_diff_veh_tpu_torch.parallel import make_mesh, sharded_all_pairs_peak
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    rec = make_ambient_record(198, 1200, seed=6, device=card)    # 50 rows a slot, 2 padded
    mesh = make_mesh(slots, device="cuda")
    for tier in ("f32", "bf16"):
        want = ap.xcorr_all_pairs_peak(rec, 128, src_chunk=16, use_kernel=True,
                                       lagmax_block=32, precision=tier, device=card)
        ring = RingConfig(lagmax_block=32, precision=tier)
        cs.launches = la.launches = 0
        got = sharded_all_pairs_peak(rec, 128, mesh, src_chunk=16, use_kernel=True, ring=ring)
        torch.cuda.synchronize()
        rows = -(-198 // slots)
        assert (cs.launches, la.launches) == (slots * slots * -(-rows // 16),
                                              slots * slots * -(-rows // 16) * -(-rows // 32))
        assert got.is_cuda and got.shape == (198, 198) and torch.equal(got, want), tier
        for cfg in (RingConfig(mode="replicated", lagmax_block=32, precision=tier),
                    RingConfig(double_buffer=False, lagmax_block=32, precision=tier)):
            assert torch.equal(sharded_all_pairs_peak(rec, 128, mesh, src_chunk=16,
                                                      use_kernel=True, ring=cfg), want)


def test_sharded_stack_on_card(card):
    """The window-sharded stack of a chunk's window batch on the card: one
    slot is ``stack_gathers`` and its image bit for bit, four slots within
    1e-6 (another order of the window sum); 2 launches of B1 a slot."""
    import numpy as np

    from das_diff_veh_tpu_torch.models import vsg as V
    from das_diff_veh_tpu_torch.models.windows import window_x_slice
    from das_diff_veh_tpu_torch.parallel import make_mesh, sharded_stack_pipeline
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

    sec, cfg, _ = _fused_scene(11, card)
    res = process_chunk(sec, cfg, device=card)
    batch = res.batch
    x = window_x_slice(np.asarray(sec.x), cfg.imaging.x0, cfg.window)
    im = cfg.imaging
    g = V.VsgGeometry.build(x, float(sec.t[1] - sec.t[0]), im.x0, im.x0 + im.disp_start_x,
                            im.x0 + cfg.gather.far_offset, cfg.gather)
    offs = g.offsets(x)
    kw = dict(disp_start_x=im.disp_start_x, disp_end_x=im.disp_end_x, dx=cfg.interrogator.dx)
    stack1 = V.stack_gathers(V.build_gather_batch(batch, g, cfg.gather), batch.valid)
    assert torch.equal(stack1, res.vsg_stack)
    img1 = V.gather_disp_image(stack1, offs, g.dt, cfg.interrogator.dx, cfg.dispersion,
                               im.disp_start_x, im.disp_end_x)
    for slots in (1, 4):
        before = tg.launches
        stack, img = sharded_stack_pipeline(batch, g, offs, make_mesh(slots, device="cuda"),
                                            cfg.gather, cfg.dispersion, **kw)
        torch.cuda.synchronize()
        assert tg.launches - before == 2 * slots
        if slots == 1:
            assert torch.equal(stack, stack1) and torch.equal(img, img1)
        else:
            assert float((stack - stack1).abs().max() / stack1.abs().max()) <= 1e-6
            assert float((img - img1).abs().max() / img1.abs().max()) <= 1e-6


def test_gather_demotion_recaptures_without_b1(card):
    """A ``gather.fused`` demotion on the card: the staged chunk launches B1
    no more, the next fused call captures a program that records no launch
    of it, and both images stay within the card's 1e-3 of the kernel route;
    after ``reset`` the first program is the one replayed again."""
    from das_diff_veh_tpu_torch.obs.registry import MetricsRegistry
    from das_diff_veh_tpu_torch.pipeline import fused as F
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk
    from das_diff_veh_tpu_torch.resilience import degrade

    degrade.set_ladder(degrade.DegradationLadder(registry=MetricsRegistry()))
    try:
        F.clear_programs()
        sec, cfg, fcfg = _fused_scene(11, card)
        ref = process_chunk(sec, fcfg, device=card)
        first = F.programs()[-1]
        assert first.launches_per_replay["traj_gather"] == 2
        degrade.note_failure(degrade.GATHER_FUSED, RuntimeError("planted"))
        before, caps = tg.launches, F.n_captures()
        staged = process_chunk(sec, cfg, device=card)
        fused = process_chunk(sec, fcfg, device=card)
        torch.cuda.synchronize()
        assert tg.launches == before and F.n_captures() == caps + 1
        assert F.programs()[-1].launches_per_replay == {"traj_gather": 0, "traj_dot": 0}
        for res in (staged, fused):
            err = (res.disp_image - ref.disp_image).abs().max() / ref.disp_image.abs().max()
            assert float(err) <= 1e-3
        degrade.reset()
        again = process_chunk(sec, fcfg, device=card)
        assert F.n_captures() == caps + 1 and _same_chunk(again, ref)
        before = tg.launches
        process_chunk(sec, cfg, device=card)
        assert tg.launches == before + 2
    finally:
        degrade.set_ladder(None)
        F.clear_programs()


# -- the science path: card against CPU (float64 on both) ------------------------

def _science_problem(dev):
    import numpy as np

    from das_diff_veh_tpu_torch.inversion import Curve, speed_model_spec
    spec = speed_model_spec()
    x = torch.as_tensor(np.random.default_rng(4).uniform(0.2, 0.8, (5, 12)), device=dev)
    T = np.asarray(1.0 / np.arange(2.0, 24.0, 0.5))
    return spec, x, T, Curve


@pytest.mark.parametrize("mode", [0, 3, 4])
def test_phase_velocity_card_equals_cpu(card, mode):
    import numpy as np

    from das_diff_veh_tpu_torch.inversion import phase_velocity
    spec, x, T, _ = _science_problem(card)
    got = phase_velocity(T, spec.to_model(x), mode=mode, n_grid=300).cpu().numpy()
    want = phase_velocity(T, spec.to_model(x.cpu()), mode=mode, n_grid=300).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-10, atol=0)
    # one member alone gives its value in the batch, bit for bit
    one = phase_velocity(T, spec.to_model(x[2]), mode=mode, n_grid=300).cpu().numpy()
    np.testing.assert_array_equal(np.nan_to_num(one), np.nan_to_num(got[2]))


@pytest.mark.parametrize("invalid", ["penalty", "truncate"])
def test_misfit_card_equals_cpu(card, invalid):
    import numpy as np

    from das_diff_veh_tpu_torch.inversion import make_misfit_fn, phase_velocity
    spec, x, T, Curve = _science_problem(card)
    ref = spec.to_model(torch.full((12,), 0.5, dtype=torch.float64))
    c0 = phase_velocity(T, ref, mode=0, n_grid=300).numpy()
    c3 = phase_velocity(T, ref, mode=3, n_grid=300).numpy()
    ok = np.isfinite(c3)
    curves = [Curve(T, c0, 0, 2.0, 0.02 * c0), Curve(T[ok], c3[ok], 3, 1.0, 0.02 * c3[ok])]
    f = make_misfit_fn(spec, curves, n_grid=300, invalid=invalid)
    np.testing.assert_allclose(f(x).cpu().numpy(), f(x.cpu()).numpy(), rtol=1e-10)
    # the gradient the refinement takes: the root's gradient divides the
    # secular function's derivative by a secant across a bracket of ~0.1 m/s,
    # whose two values carry the determinant's cancellation noise (~1e-12 of
    # its peak on these 6-layer models), so it agrees to ~1e-6 (3.7e-6 on
    # the H100), not to the misfit's 1e-10
    z = x.clone().requires_grad_(True)
    f(z).sum().backward()
    zc = x.cpu().clone().requires_grad_(True)
    f(zc).sum().backward()
    np.testing.assert_allclose(z.grad.cpu().numpy(), zc.grad.numpy(), rtol=1e-5, atol=1e-9)


def test_clahe_and_enhance_card_equal_cpu(card):
    import numpy as np

    from das_diff_veh_tpu_torch.ops.enhance import clahe_u8, fv_map_enhance
    rng = np.random.default_rng(7)
    img = torch.as_tensor((np.abs(rng.standard_normal((1000, 242))) * 60).clip(0, 255)
                          .astype(np.int32))
    assert torch.equal(clahe_u8(img.to(card)).cpu(), clahe_u8(img))
    fv = torch.as_tensor(np.abs(rng.standard_normal((1000, 242))) + 0.05)
    assert torch.equal(fv_map_enhance(fv.to(card)).cpu(), fv_map_enhance(fv))


# ---- serving: the engine's requests on the card ----

@pytest.mark.parametrize("pipeline", ["staged", "fused"])
def test_serve_imaging_engine_on_card_equals_direct(card, pipeline):
    """``ServingEngine`` + ``ImagingComputeFactory`` on the card: a request
    and the same scene one hour into the recording each equal a direct
    ``process_chunk`` bit for bit, nothing is built after the warm-up (the
    shifted segment rebases onto the warmed grid), B1 launches twice a staged
    request, and a fused bucket's graph records 2 launches of B1."""
    import numpy as np

    from das_diff_veh_tpu_torch.config import ServeConfig
    from das_diff_veh_tpu_torch.core.section import DasSection
    from das_diff_veh_tpu_torch.obs import MetricsRegistry
    from das_diff_veh_tpu_torch.pipeline import fused as F
    from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk
    from das_diff_veh_tpu_torch.pipeline.workflow import pull_count_and_image
    from das_diff_veh_tpu_torch.serve import ImagingComputeFactory, ServingEngine

    F.clear_programs()
    sec, cfg, fcfg = _fused_scene(11, card)
    cfg = fcfg if pipeline == "fused" else cfg
    data, x, t = sec.data.cpu().numpy(), sec.x.numpy(), sec.t.numpy()
    reg = MetricsRegistry()
    eng = ServingEngine(ImagingComputeFactory(cfg, x_is_channels=False, x_axis=x, device=card),
                        ServeConfig(buckets=(data.shape,)), registry=reg).start()
    try:
        caps = F.n_captures()
        before = tg.launches
        got = eng.process(DasSection(data, x, t), timeout=600)
        shifted = eng.process(DasSection(data, x, t + 3600.0), timeout=600)
        torch.cuda.synchronize()
        launched = tg.launches - before
        snap = eng.metrics()
        steady = reg.get("das_serve_steady_state_compiles").value
    finally:
        eng.close()
    want = process_chunk(sec, cfg, device=card)
    n, img = pull_count_and_image(want.n_windows, want.disp_image)
    assert got.n_windows == shifted.n_windows == n >= 1
    assert np.array_equal(got.image, img) and np.array_equal(shifted.image, img)
    assert shifted.t0 == 3600.0 and F.n_captures() == caps
    assert snap["cache_misses"] == 0 and steady == 0
    if pipeline == "staged":
        assert launched == 4
    else:
        assert launched == 0 and F.programs()[-1].launches_per_replay == {"traj_gather": 2,
                                                                        "traj_dot": 0}


def test_serve_ring_placement_on_card_equals_single_device_engine(card):
    """``MeshServingEngine`` + ``AllPairsComputeFactory`` with the ring on 4
    slots of the card: a large request takes the ring (B3 and B4 on every
    step), a small one a replica, both equal to the single-device engine
    bit for bit."""
    import numpy as np

    from das_diff_veh_tpu_torch.config import MeshServeConfig, ServeConfig
    from das_diff_veh_tpu_torch.core.section import DasSection
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.ops import lag_absmax as la
    from das_diff_veh_tpu_torch.parallel import make_mesh
    from das_diff_veh_tpu_torch.serve import ServingEngine
    from das_diff_veh_tpu_torch.serve.mesh import AllPairsComputeFactory, MeshServingEngine
    from das_diff_veh_tpu_torch.workloads import make_ambient_record

    big = make_ambient_record(2048, 1200, seed=6, device="cpu").numpy()
    small = make_ambient_record(600, 1200, seed=7, device="cpu").numpy()

    def sec(a):
        return DasSection(a, np.arange(a.shape[0], dtype=np.float64),
                          np.arange(a.shape[1], dtype=np.float64) / 1000.0)

    buckets = ((2048, 1200), (600, 1200))
    kw = dict(wlen=128, src_chunk=16, use_kernel=True, device=card)
    single = ServingEngine(AllPairsComputeFactory(**kw), ServeConfig(buckets=buckets)).start()
    meng = MeshServingEngine(
        AllPairsComputeFactory(mesh=make_mesh(4, device="cuda"), **kw),
        MeshServeConfig(serve=ServeConfig(buckets=buckets), replicas=2, ring_min_channels=1024),
        device="cuda").start()
    try:
        cs.launches = la.launches = 0
        ring = meng.process(sec(big), timeout=600)
        torch.cuda.synchronize()
        assert cs.launches == 16 * -(-512 // 16) and la.launches > 0
        rep = meng.process(sec(small), timeout=600)
        assert ring.placement == "ring" and rep.placement == "single"
        assert np.array_equal(ring.peaks, single.process(sec(big), timeout=600).peaks)
        assert np.array_equal(rep.peaks, single.process(sec(small), timeout=600).peaks)
        assert meng.metrics()["cache_misses"] == 0
        assert tuple(r.device for r in meng._replicas) == make_mesh(2, device="cuda").devices
    finally:
        meng.close()
        single.close()


# --------------------------------------------------------------------------
# the ops layers on the card: the figure set's gathers, the profiler window,
# the memory sampler
# --------------------------------------------------------------------------

def test_figure_set_arrays_on_card_match_cpu(card):
    """The figure set's run on the card: 2 launches of B1, the stack and the
    image within the chunk's 1e-3 of the CPU float64 run."""
    import numpy as np

    from das_diff_veh_tpu_torch.workloads import figure_set_arrays

    tg.launches = 0
    got = figure_set_arrays(n_windows=4, seed=1, device=card)
    torch.cuda.synchronize()
    assert tg.launches == 2
    want = figure_set_arrays(n_windows=4, seed=1, dtype=np.float64, device="cpu")
    for a, b in ((got.stack, want.stack), (got.image, want.image)):
        assert a.is_cuda and bool(torch.isfinite(a).all())
        assert float((a.double().cpu() - b).abs().max() / b.abs().max()) <= 1e-3


def test_profiler_window_traces_the_card(card, tmp_path):
    """The window records CUDA activity: B1's kernel is named in its trace."""
    import json

    from das_diff_veh_tpu_torch.obs import ProfilerWindow

    gen = torch.Generator(device=card).manual_seed(3)
    rec = torch.randn((4, NCH, NT), generator=gen, device=card)
    idx = torch.tensor(CASES["forward"][0], device=card).expand(4, -1)
    scal = tg.traj_scalars(idx, torch.tensor(CH, device=card), NCH, NT, NSAMP,
                           False).contiguous()
    win = ProfilerWindow(str(tmp_path), start_after=1, n_steps=2)
    for _ in range(4):
        tg.pack_windows_cuda(rec, scal, PIVOT, NWIN, WLEN, OFFSET)
        win.step()
    assert win.captured
    with open(win.trace_path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    assert any("traj_gather_pack_kernel" in n for n in names), names


def test_hbm_sampler_reads_the_card(card):
    """The sampler's largest bytes in use see a 256 MiB block; the peak gauge
    is ``max_memory_allocated()``; ``close()`` joins the thread."""
    import time

    from das_diff_veh_tpu_torch.obs import HBMSampler, MetricsRegistry

    reg = MetricsRegistry()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s = HBMSampler(reg, interval_s=0.01)
    block = torch.empty(64 << 20, dtype=torch.float32, device=card)
    time.sleep(0.1)
    s.close()
    sampled = s.max_in_use["cuda:0"]
    peak = reg.gauge("das_device_peak_bytes", labels=("device",)).labels(device="cuda:0").value
    assert block.numel() * 4 <= sampled <= peak == torch.cuda.max_memory_allocated()
    assert not s.alive


# ---- the device timeline: CUDA events on the spans' clock ----

class _EventTracer:
    """An in-memory tracer with the device timeline on (host spans dropped)."""

    device_timeline = True

    def __init__(self):
        import threading

        self.device_spans = []
        self.lock = threading.Lock()

    def now_us(self):
        import time

        return time.perf_counter() * 1e6

    def span(self, name, cat="runtime", **args):
        import contextlib

        return contextlib.nullcontext()

    def complete(self, name, start_us, cat="runtime", **args):
        pass

    def counter(self, name, **values):
        pass

    def instant(self, name, **args):
        pass

    def device(self, name, start_us, end_us, **args):
        with self.lock:
            self.device_spans.append((name, start_us, end_us, args))


def _union(intervals, lo, hi):
    """Sorted, disjoint union of ``intervals`` clipped to ``[lo, hi]``."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _busy_us(intervals, lo, hi):
    """Length of the union of ``intervals`` inside ``[lo, hi]``."""
    return sum(e - s for s, e in _union(intervals, lo, hi))


def _profiled(run, kernels_only=False):
    """``run()`` under ``torch.profiler`` (CPU and CUDA): ``(lo, hi, busy)``,
    the host clock's microseconds at the stretch's two ends and the device
    activity's intervals (or only its kernels') put on that clock (the
    profiler stamps Unix-epoch nanoseconds)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        offset_ns = time.time_ns() - time.perf_counter_ns()
        lo = time.perf_counter() * 1e6
        run()
        torch.cuda.synchronize()
        hi = time.perf_counter() * 1e6
    busy = [((e.start_ns() - offset_ns) / 1e3, (e.start_ns() + e.duration_ns() - offset_ns) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")
            and not (kernels_only and e.name().startswith(("Memcpy", "Memset")))]
    return lo, hi, busy


def _covered_us(a, b, lo, hi):
    """Length of ``[lo, hi]`` inside both unions."""
    a, b = _union(a, lo, hi), _union(b, lo, hi)
    tot, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        tot += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def test_device_timeline_blocks_agree_with_the_profiler(card):
    """Six units of kernel-bound work (three float32 products of 4096 x 4096
    in one marked block), 20 ms of host sleep apart: put on one clock with
    the profiler's, the spans cover 95 % of its busy time, and a block's
    span is mostly kernel time (the median block 90 %; the profiler now and
    then holds the host inside a block, between a mark and a launch, which
    leaves the card idle there: that block alone reads long)."""
    import time

    from das_diff_veh_tpu_torch.runtime.tracing import DeviceTimeline, device_work

    a = torch.randn(4096, 4096, device=card)
    (a @ a).sum().item()
    tracer = _EventTracer()
    tl = DeviceTimeline(tracer, card)

    def run():
        for k in range(6):
            with tl.unit("device_compute", key=k):
                with device_work():
                    c = a @ a
                    c = c @ a
                    c = c @ a
                float(c[0, 0])
            time.sleep(0.02)

    lo, hi, busy = _profiled(run)
    spans = [(s, e) for _, s, e, _ in tracer.device_spans]
    assert len(spans) == 6
    kernels = _busy_us(busy, lo, hi)
    assert _covered_us(spans, busy, lo, hi) >= 0.95 * kernels, (spans, lo, hi)
    ratios = sorted(_busy_us(busy, s, e) / (e - s) for s, e in spans)
    assert (ratios[2] + ratios[3]) / 2 >= 0.9, ratios


def test_device_timeline_of_served_requests_covers_their_device_work(card):
    """Six requests of a fused imaging engine under the profiler, 20 ms of
    host sleep apart: every request has its copy in and its block of
    compute (the graph's copy in, replay and output copies), with its
    ``rid``; the spans cover 90 % of the time the profiler sees kernels run
    (93.6-100 % read).  (They also hold the host's launch of the graph,
    which the device waits for inside the block and which the profiler
    stretches: their busy share is not the profiler's here.)  The warm-up,
    which captures the bucket's graph, records its spans round the
    capture, not inside it."""
    import time

    import numpy as np

    from das_diff_veh_tpu_torch.config import ServeConfig
    from das_diff_veh_tpu_torch.core.section import DasSection
    from das_diff_veh_tpu_torch.pipeline import fused as F
    from das_diff_veh_tpu_torch.serve import ImagingComputeFactory, ServingEngine

    F.clear_programs()
    sec, _, fcfg = _fused_scene(11, card)
    data, x, t = sec.data.cpu().numpy(), sec.x.numpy(), sec.t.numpy()
    tracer = _EventTracer()
    eng = ServingEngine(ImagingComputeFactory(fcfg, x_is_channels=False, x_axis=x, device=card),
                        ServeConfig(buckets=(data.shape,)), tracer=tracer).start()

    def run():
        for _ in range(6):
            eng.process(DasSection(data, x, t), timeout=600)
            time.sleep(0.02)

    try:
        eng.process(DasSection(data, x, t), timeout=600)          # warm, outside the profile
        n_before = len(tracer.device_spans)
        lo, hi, busy = _profiled(run, kernels_only=True)
    finally:
        eng.close()
    assert n_before == 4, [(n, a) for n, *_, a in tracer.device_spans]
    spans = tracer.device_spans[n_before:]
    per_rid = {}
    for n, *_, args in spans:
        per_rid.setdefault(args["rid"], []).append(n)
    assert len(per_rid) == 6, per_rid
    assert all(sorted(v) == ["device_compute", "device_stage"] for v in per_rid.values()), per_rid
    ev = [(s, e) for _, s, e, _ in spans]
    covered, kernels = _covered_us(ev, busy, lo, hi), _busy_us(busy, lo, hi)
    assert covered >= 0.9 * kernels, (covered, kernels, _busy_us(ev, lo, hi), hi - lo)


# ---- the ambient-noise day stack (pipeline.ambient) on the card ----

def _ambient_reference():
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "benchmark" / "reference" / "ambient" / "ncf.py"
    spec = importlib.util.spec_from_file_location("ambient_reference_ncf", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rows", [(400, 464), (983, 1000)], ids=["full_chunk", "last_chunk"])
def test_cross_spectra_on_a_receiver_band_equals_its_full_receiver_result(card, rows):
    """B3 at the day stack's shapes (13 windows, 2049 bins): a chunk against
    its 664-row band (or the last chunk's 17 rows against its clipped
    317-row band) gives the bits of the same chunk against every row."""
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs

    wf = _spectra(card, 1000, 13, 2049, 21)
    s0, s1 = rows
    r0, r1 = max(s0 - 300, 0), min(s1 + 300, wf.shape[0])
    full = cs.cross_spectra_cuda(wf[s0:s1], wf, 13, 13)
    band = cs.cross_spectra_cuda(wf[s0:s1], wf[r0:r1], 13, 13)
    torch.cuda.synchronize()
    assert torch.equal(full[:, r0:r1], band)


def test_banded_finish_pair_bits_do_not_depend_on_the_chunk(card):
    """The same spectra with the first row dropped put every pair in
    another chunk and at another place in it (and clip other bands); each
    pair's lags come out the same bits, since every irfft takes one batch
    shape."""
    from das_diff_veh_tpu_torch.ops.all_pairs import add_banded

    wf = _spectra(card, 300, 13, 2049, 22)
    off, lag, chunk = 40, 100, 64
    a = torch.zeros((300, 2 * off + 1, 2 * lag + 1), device=card)
    b = torch.zeros((299, 2 * off + 1, 2 * lag + 1), device=card)
    add_banded(wf, a, 4096, off, lag, chunk, use_kernel=True)
    add_banded(wf[1:].contiguous(), b, 4096, off, lag, chunk, use_kernel=True)
    torch.cuda.synchronize()
    for s in range(1, 300):
        j0 = max(off - s + 1, 0)                 # receivers from row 1 on
        assert torch.equal(a[s, j0:], b[s - 1, j0:]), s


def test_day_stack_of_a_full_width_record_matches_the_reference(card):
    """One 8721 x 30000 record of the PoroTomo DASH deployment through the
    day stack, four sources (both array ends and a chunk edge) against the
    plain reference on the card, each within 1e-5 of its gather's peak:
    both sides float32, summed in other orders (B3's against the einsum's,
    cuFFT's batches)."""
    import numpy as np

    from das_diff_veh_tpu_torch.config import AmbientConfig
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.pipeline.ambient import DayStack

    cfg = AmbientConfig()
    gen = torch.Generator(device=card).manual_seed(23)
    rec = torch.randn((8721, 30000), generator=gen, device=card)
    stack = DayStack(8721, cfg, card)
    before = cs.launches
    stack.add(rec)
    assert cs.launches - before == 137
    sources = [0, 64, 4000, 8720]
    got = stack.flush(sources)
    del stack
    torch.cuda.empty_cache()
    want = _ambient_reference().gathers(
        rec, sources, fs=cfg.fs, wlen=cfg.wlen, overlap_ratio=cfg.overlap_ratio,
        band_hz=cfg.band_hz, max_offset=cfg.max_offset, max_lag=cfg.max_lag,
        device=card).cpu().numpy()
    assert got.shape == (4, 601, 2001)
    for g, w in zip(got, want):
        assert float(np.abs(g - w).max() / np.abs(w).max()) <= 1e-5
    assert np.all(got[0, :300] == 0) and np.all(got[3, 301:] == 0)


def test_day_stack_device_blocks_on_card(card):
    """With the device timeline on, a record gives one ``ambient_stage`` and
    one ``ambient_spectra`` device span and one ``ambient_cross`` and one
    ``ambient_finish`` span a source chunk, each with its ``record``."""
    import numpy as np

    from das_diff_veh_tpu_torch.config import AmbientConfig
    from das_diff_veh_tpu_torch.pipeline.ambient import stack_records

    recs = [np.random.default_rng(k).standard_normal((200, 30000)).astype(np.float32)
            for k in range(2)]
    tracer = _EventTracer()
    run = stack_records(recs, AmbientConfig(max_offset=50, max_lag=200), tracer=tracer,
                        device=card)
    assert run.records == 2 and not run.quarantined
    chunks = len(run.stack.schedule)
    for name, per in [("ambient_stage", 1), ("ambient_spectra", 1), ("ambient_cross", chunks),
                      ("ambient_finish", chunks)]:
        recs_seen = [a["record"] for n, _, _, a in tracer.device_spans if n == name]
        assert sorted(recs_seen) == [0] * per + [1] * per, name
    assert all(e >= s for _, s, e, _ in tracer.device_spans)


# ---- the day stack's band-pruned finish (ops.band_lag_add) on the card ----

# DASH's three launch shapes: sources, receiver rows, lead (band rows
# clipped below row 0)
BAND_LAUNCHES = {"first_clipped": (64, 364, 300), "full": (64, 664, 0), "last": (17, 317, 0)}


def _band_cross(card, m, nb, seed, lo=9, hi=204, wlen=4096):
    """Seeded complex64 cross-spectra, zero outside bins lo..hi."""
    c = _spectra(card, m, nb, wlen // 2 + 1, seed)
    c[..., :lo] = 0
    c[..., hi + 1:] = 0
    return c


def _gather_gap(got, want):
    m = want.shape[0]
    peak = want.abs().reshape(m, -1).amax(1)
    return float(((got - want).abs().reshape(m, -1).amax(1) / peak).max())


@pytest.mark.parametrize("shape", sorted(BAND_LAUNCHES))
def test_band_lag_add_kernel_equals_plain(card, shape):
    """The kernel against its plain version on the card at DASH's launch
    shapes (4096-sample windows, bins 9..204, 601 slots, +-1000 lags), each
    adding into zeroed stack rows: within 1e-6 of each gather's peak; added
    into seeded rows, the slots past the array's ends keep their bits and
    every other slot changes."""
    from das_diff_veh_tpu_torch.ops import band_lag_add as bla

    m, nb, lead = BAND_LAUNCHES[shape]
    cross = _band_cross(card, m, nb, seed=31 + m + nb)
    got = torch.zeros((m, 601, 2001), device=card)
    want = torch.zeros_like(got)
    before = bla.launches
    bla.band_lag_add(cross, got, lead, 9, 204, 4096, 1000)
    bla.band_lag_add_plain(cross, want, lead, 9, 204, 4096, 1000)
    torch.cuda.synchronize()
    assert bla.launches - before == 1
    assert _gather_gap(got, want) <= 1e-6
    gen = torch.Generator(device=card).manual_seed(32)
    base = torch.randn((m, 601, 2001), generator=gen, device=card)
    seeded = base.clone()
    bla.band_lag_add(cross, seeded, lead, 9, 204, 4096, 1000)
    torch.cuda.synchronize()
    inside = bla.in_array(m, nb, 601, lead).to(card)
    assert torch.equal(seeded[~inside], base[~inside])
    assert bool(torch.all((seeded[inside] != base[inside]).any(dim=-1)))


@pytest.mark.parametrize("band", [(0, 2048), (2048, 2048), (0, 5)],
                         ids=["whole_window", "nyquist_only", "below_q_min"])
def test_band_lag_add_kernel_at_the_band_edges(card, band):
    """Bands from bin 0, to bin wlen/2 and below Q's least: the kernel
    against its plain version, with imaginary parts in bins 0 and wlen/2
    (c2r's rule drops them), and, with those bins real as a real record
    leaves them, against the irfft finish; 1e-6 of each gather's peak."""
    from das_diff_veh_tpu_torch.ops import band_lag_add as bla
    from das_diff_veh_tpu_torch.ops.all_pairs import _banded_finish

    lo, hi = band
    cross = _band_cross(card, 8, 28, seed=33, lo=lo, hi=hi)
    got = torch.zeros((8, 21, 2001), device=card)
    plain = torch.zeros_like(got)
    before = bla.launches
    _banded_finish(cross, got, 100, 90, 4096, 10, 1000, 8, band=band)
    bla.band_lag_add_plain(cross, plain, 0, lo, hi, 4096, 1000)
    torch.cuda.synchronize()
    assert bla.launches - before == 1
    assert _gather_gap(got, plain) <= 1e-6
    cross[..., 0] = cross[..., 0].real
    cross[..., 2048] = cross[..., 2048].real
    got.zero_()
    want = torch.zeros_like(got)
    _banded_finish(cross, got, 100, 90, 4096, 10, 1000, 8, band=band)
    _banded_finish(cross, want, 100, 90, 4096, 10, 1000, 8)
    torch.cuda.synchronize()
    assert _gather_gap(got, want) <= 1e-6


def test_band_finish_pair_bits_do_not_depend_on_the_chunk(card):
    """As ``test_banded_finish_pair_bits_do_not_depend_on_the_chunk``, on
    spectra zero outside the DASH band and with the band given: each pair's
    lags come out the same bits in either chunking, since the kernel takes
    each pair alone (one band launch a chunk)."""
    from das_diff_veh_tpu_torch.ops import band_lag_add as bla
    from das_diff_veh_tpu_torch.ops.all_pairs import add_banded

    wf = _band_cross(card, 300, 13, seed=34)
    off, lag, chunk = 40, 100, 64
    a = torch.zeros((300, 2 * off + 1, 2 * lag + 1), device=card)
    b = torch.zeros((299, 2 * off + 1, 2 * lag + 1), device=card)
    k0 = bla.launches
    add_banded(wf, a, 4096, off, lag, chunk, use_kernel=True, band=(9, 204))
    add_banded(wf[1:].contiguous(), b, 4096, off, lag, chunk, use_kernel=True, band=(9, 204))
    torch.cuda.synchronize()
    assert bla.launches - k0 == 10              # 5 chunks of 300 and of 299 sources
    for s in range(1, 300):
        j0 = max(off - s + 1, 0)                 # receivers from row 1 on
        assert torch.equal(a[s, j0:], b[s - 1, j0:]), s


@pytest.mark.parametrize("whiten", [True, False], ids=["whitened", "unwhitened"])
def test_a_dash_record_launches_the_band_kernel_once_a_chunk(card, whiten):
    """A record of the DASH array's 8721 channels (one 4096-sample window,
    so that it stays small): 137 B3 launches and, whitened, 137 of the band
    kernel, the stack's ``finish_band`` the whitening band's bins;
    unwhitened, the irfft finish, no band launch and no ``finish_band``."""
    import numpy as np

    from das_diff_veh_tpu_torch.config import AmbientConfig
    from das_diff_veh_tpu_torch.obs import default_registry
    from das_diff_veh_tpu_torch.ops import band_lag_add as bla
    from das_diff_veh_tpu_torch.ops import cross_spectra as cs
    from das_diff_veh_tpu_torch.pipeline.ambient import stack_records

    reg = default_registry()
    n0 = reg.counter("das_ambient_records_total").value
    rec = np.random.default_rng(35).standard_normal((8721, 4096)).astype(np.float32)
    c0, k0 = cs.launches, bla.launches
    run = stack_records([rec], AmbientConfig(whiten=whiten), device=card)
    assert run.records == 1 and not run.quarantined
    assert cs.launches - c0 == 137 and bla.launches - k0 == (137 if whiten else 0)
    assert reg.counter("das_ambient_records_total").value - n0 == 1
    assert run.stack.finish_band == ((9, 204) if whiten else None)
    ends = run.stack.flush([0, 8720])
    assert np.all(ends[0, :300] == 0) and np.all(ends[1, 301:] == 0)
    assert np.all(np.abs(ends[0, 300:]).max(axis=1) > 0)
    del run
    torch.cuda.empty_cache()


# ---- the day stack split over four cards (DayStack(devices=...)) ----

@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: the day stack split over cards")
    return [torch.device("cuda", i) for i in range(4)]


def _assert_rows_equal(one, four):
    """Every row of the one-card stack against the split stack's, slab by
    slab on the card that holds the row."""
    for shard, part in zip(four.shards, four.sums):
        for a in range(0, len(part), 512):
            b = min(a + 512, len(part))
            theirs = one.sum[shard.first + a:shard.first + b].to(shard.card)
            assert torch.equal(part[a:b], theirs), (shard, a)


@pytest.mark.parametrize("whiten", [True, False], ids=["band", "irfft"])
def test_day_stack_over_four_cards_equals_one_card(four_cards, whiten):
    """Three 1500 x 30000 records at the 500 m, +-2 s widths through the day
    stack on one card and split over four: every row equal bit for bit,
    with the band finish (B5) and with the irfft.  A record sends each
    other card its rows once, and every device block names its card."""
    import numpy as np

    from das_diff_veh_tpu_torch.config import AmbientConfig
    from das_diff_veh_tpu_torch.pipeline.ambient import DayStack, stack_records

    cfg = AmbientConfig(max_offset=500, max_lag=2000, whiten=whiten)
    recs = [np.random.default_rng(40 + k).standard_normal((1500, 30000)).astype(np.float32)
            for k in range(3)]
    one = stack_records(recs, cfg, device=four_cards[0]).stack
    tracer = _EventTracer()
    four = stack_records(recs, stack=DayStack(1500, cfg, devices=four_cards),
                         tracer=tracer).stack
    assert [s.card for s in four.shards] == four_cards and four.records == 3
    _assert_rows_equal(one, four)
    np.testing.assert_array_equal(four.flush([0, 1499, 700, *[s.last for s in four.shards]]),
                                  one.flush([0, 1499, 700, *[s.last for s in four.shards]]))
    chunks = {p.index: len(p.schedule) for p in four._parts}
    for record in range(3):
        seen = [(n, a.get("card")) for n, _, _, a in tracer.device_spans
                if a["record"] == record]
        assert sorted(c for n, c in seen if n == "ambient_scatter") == [1, 2, 3]
        for name in ("ambient_cross", "ambient_finish"):
            by_card = [c for n, c in seen if n == name]
            assert {c: by_card.count(c) for c in set(by_card)} == chunks, name
    assert all(e >= s for _, s, e, _ in tracer.device_spans)
    assert one.peer_bytes_per_record == 0 and four.peer_bytes_per_record > 0
    del one, four
    torch.cuda.empty_cache()


def test_dash_day_stack_over_four_cards_equals_one_card(four_cards):
    """The PoroTomo DASH day stack at its accepted widths (8721 channels,
    300 m, +-1 s: 41.95 GB, which one card holds): three 8721 x 30000
    records on one card and split over four give every row bit for bit."""
    from das_diff_veh_tpu_torch.config import AmbientConfig
    from das_diff_veh_tpu_torch.pipeline.ambient import DayStack, stack_records

    gen = torch.Generator(device=four_cards[0]).manual_seed(41)
    recs = [torch.randn((8721, 30000), generator=gen, device=four_cards[0]).cpu()
            for _ in range(3)]
    one = stack_records(recs, AmbientConfig(), device=four_cards[0]).stack
    four = stack_records(recs, stack=DayStack(8721, AmbientConfig(), devices=four_cards)).stack
    assert [len(p.schedule) for p in four._parts] == [35, 33, 34, 35]
    _assert_rows_equal(one, four)
    del one, four
    torch.cuda.empty_cache()
