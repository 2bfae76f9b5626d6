"""Tests of the port that need the card: the CUDA kernels against their plain
PyTorch versions, and a small chunk on the card against the CPU.

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
