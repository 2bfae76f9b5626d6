"""``das_diff_veh_tpu_torch.ops.xcorr`` against ``das_diff_veh_tpu.ops.xcorr``
at the repository's oracle bar (1e-7 peak-relative), and the port's two
trajectory-gather modes against each other bit for bit (as the JAX test
holds JAX's fused and serialized modes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das_diff_veh_tpu.ops import xcorr as jx
from das_diff_veh_tpu_torch.ops import xcorr as px

RNG = np.random.default_rng(43)
NCH, NT, WLEN, NSAMP, PIVOT = 10, 2000, 250, 800, 6
CH = np.array([2, 3, 5, 7])
T_AXIS = np.arange(NT) * 0.004
# in range, truncated at the record end, and backward empty slices
T_AT_CH = {"in_range": [1.0, 2.0, 3.0, 4.0], "edge": [6.9, 7.5, 7.996, 4.0],
           "early": [0.1, 0.5, 3.5, 5.0]}


def _peak_rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-300)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case", sorted(T_AT_CH))
def test_traj_follow_modes_match_jax(case, reverse):
    data = RNG.standard_normal((NCH, NT))
    t_at = np.asarray(T_AT_CH[case])
    want = np.asarray(jx.xcorr_traj_follow(jnp.asarray(data), jnp.asarray(T_AXIS), PIVOT,
                                           jnp.asarray(CH), jnp.asarray(t_at), NSAMP, WLEN,
                                           reverse=reverse, mode="serialized"))
    got = {mode: px.xcorr_traj_follow(torch.from_numpy(data), torch.from_numpy(T_AXIS),
                                      PIVOT, torch.from_numpy(CH), torch.from_numpy(t_at),
                                      NSAMP, WLEN, reverse=reverse, mode=mode).numpy()
           for mode in ("serialized", "fused", "auto")}
    assert got["fused"].shape == want.shape == (CH.size, WLEN)
    assert _peak_rel(got["serialized"], want) <= 1e-7
    np.testing.assert_array_equal(got["fused"], got["serialized"])
    np.testing.assert_array_equal(got["auto"], got["fused"])


def test_traj_follow_float32_modes_bit_identical():
    data = RNG.standard_normal((NCH, NT)).astype(np.float32)
    args = (torch.from_numpy(data), torch.from_numpy(T_AXIS), PIVOT, torch.from_numpy(CH),
            torch.tensor([1.0, 2.5, 3.0, 6.5], dtype=torch.float64), NSAMP, WLEN)
    fus = px.xcorr_traj_follow(*args, mode="fused")
    assert fus.dtype == torch.float32
    assert torch.equal(fus, px.xcorr_traj_follow(*args, mode="serialized"))


@pytest.mark.parametrize("backward", [False, True])
def test_vshot_and_pair_at_match_jax(backward):
    data = RNG.standard_normal((NCH, NT))
    for start in [0, 300, 900, 1300, 1999]:
        want = jx.xcorr_vshot_at(jnp.asarray(data), 3, start, NSAMP, WLEN,
                                 reverse=backward, backward=backward)
        got = px.xcorr_vshot_at(torch.from_numpy(data), 3, start, NSAMP, WLEN,
                                reverse=backward, backward=backward)
        assert _peak_rel(got.numpy(), want) <= 1e-7, start
        want = jx.xcorr_pair_at(jnp.asarray(data[0]), jnp.asarray(data[1]), start,
                                NSAMP, WLEN, backward=backward)
        got = px.xcorr_pair_at(torch.from_numpy(data[0]), torch.from_numpy(data[1]),
                               start, NSAMP, WLEN, backward=backward)
        if np.abs(np.asarray(want)).max() == 0:
            assert not got.any()
        else:
            assert _peak_rel(got.numpy(), want) <= 1e-7, start


def test_sliding_windows_and_cut_match_jax():
    data = RNG.standard_normal((3, 1000))
    np.testing.assert_array_equal(px.sliding_windows(torch.from_numpy(data), 250, 125).numpy(),
                                  np.asarray(jx.sliding_windows(jnp.asarray(data), 250, 125)))
    starts = np.array([0, 10, 760, 900])             # the last one clamps like dynamic_slice
    np.testing.assert_array_equal(
        px.cut_windows_at(torch.from_numpy(data), torch.from_numpy(starts), 250).numpy(),
        np.asarray(jx.cut_windows_at(jnp.asarray(data), jnp.asarray(starts), 250)))


def test_unported_and_invalid_knobs():
    """Every knob value is ported now: what stays refused is a dot finish
    past its caps (the JAX texts) and names that are not knob values."""
    args = (torch.zeros((NCH, NT)), torch.from_numpy(T_AXIS), PIVOT, torch.from_numpy(CH),
            torch.ones(4, dtype=torch.float64), NSAMP, WLEN)
    big = 258                                           # past dot_max_wlen=256
    with pytest.raises(ValueError, match="dot_max_wlen"):
        px.xcorr_traj_follow(*args[:5], 4 * big, big, mode="fused", finish="dot")
    with pytest.raises(ValueError, match="precision"):
        px.xcorr_traj_follow(*args, mode="fused", finish="dot", precision="f16")
    with pytest.raises(ValueError, match="traj_gather_finish"):
        px.xcorr_traj_follow(*args, finish="fft2")
    with pytest.raises(ValueError, match="traj_gather"):
        px.xcorr_traj_follow(*args, mode="warp")
