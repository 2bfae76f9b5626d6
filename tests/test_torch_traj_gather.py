"""The trajectory gather (``das_diff_veh_tpu_torch.ops.traj_gather``): its
plain version is held bit-exactly against the JAX Pallas kernel in interpret
mode (``traj_follow_windows``).  The CUDA kernel is held against the plain
version on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from das_diff_veh_tpu.ops import pallas_gather as pg
from das_diff_veh_tpu_torch.ops import traj_gather as tg

NCH, NT, WLEN, NSAMP = 10, 2000, 250, 800
OFFSET = WLEN // 2
PIVOT = 6
CH = np.array([2, 3, 5, 7])
RNG = np.random.default_rng(41)

# dt_idx per case: in range, at/near the record end, and (backward) the
# numpy empty slice start < nsamp
CASES = {
    "forward": (np.array([250, 500, 750, 1000]), False),
    "backward": (np.array([900, 1200, 1500, 1999]), True),
    "forward_edge_truncated": (np.array([1725, 1875, 1999, 1000]), False),
    "backward_edge_truncated": (np.array([1725, 1875, 1999, 2000]), True),
    "backward_empty": (np.array([25, 125, 875, 1250]), True),
}


def _port(data, dt_idx, backward):
    return tg.traj_follow_windows(torch.from_numpy(data), PIVOT, torch.from_numpy(CH),
                                  torch.from_numpy(dt_idx), NSAMP, WLEN, OFFSET,
                                  backward=backward)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel_interpret(case):
    import jax.numpy as jnp

    dt_idx, backward = CASES[case]
    data = RNG.standard_normal((NCH, NT))
    want = pg.traj_follow_windows(jnp.asarray(data), PIVOT, jnp.asarray(CH),
                                  jnp.asarray(dt_idx), NSAMP, WLEN, OFFSET,
                                  backward=backward, interpret=True)
    got = _port(data, dt_idx, backward)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "backward_empty":
        assert not got[0][:2].any() and got[2][:2].sum() == 0


def test_batched_call_equals_per_slot_calls():
    """The port cuts every window slot in one call; each slot equals its own
    unbatched cut."""
    data = RNG.standard_normal((3, NCH, NT)).astype(np.float32)
    dt_idx = RNG.integers(0, NT + 1, size=(3, CH.size))
    batched = _port(data, dt_idx, True)
    for b in range(3):
        single = _port(data[b], dt_idx[b], True)
        for x, y in zip(batched, single):
            assert torch.equal(x[b], y)


def test_nwin_cap_and_empty_channel_set():
    data = torch.zeros((NCH, NT))
    with pytest.raises(ValueError, match="fused_max_nwin"):
        tg.traj_follow_windows(data, PIVOT, torch.tensor([1]), torch.tensor([0]),
                               NSAMP, WLEN, OFFSET, max_nwin=2)
    wc, wp, n = tg.traj_follow_windows(data, PIVOT, torch.zeros(0, dtype=torch.long),
                                       torch.zeros(0, dtype=torch.long), NSAMP, WLEN, OFFSET)
    assert wc.shape == wp.shape == (0, 5, WLEN) and n.shape == (0,)


def test_bytes_moved_counts_valid_spans():
    scal = tg.traj_scalars(torch.tensor([[100, 1900]]), torch.tensor([2, 3]), NCH, NT,
                           NSAMP, backward=False)
    # slot (ch 2, start 100): all 5 windows, span 750; (ch 3, start 1900): none
    nbytes = tg.bytes_moved(scal, NCH, NT, PIVOT, 5, WLEN, OFFSET)
    assert nbytes == 4 * (2 * 750 + 2 * 2 * 5 * WLEN) + scal.numel() * 4

