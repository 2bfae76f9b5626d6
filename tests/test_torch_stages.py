"""Stage-by-stage parity of the port against the JAX package on the CPU, one
test (or parametrised family) per module: preprocess, tracking, windows,
dispersion, virtual shot gathers and trace quality control.  Inputs are made with numpy from a seed
and handed to both packages; tolerances are the repository's oracle bar
(1e-7 peak-relative) and exact equality for masks and pure copies."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_tracking import _tracking_scene
from test_vsg import _window_scene
from test_windows import _make_tracks_and_data

from das_diff_veh_tpu import config as JC
from das_diff_veh_tpu.core.section import VehicleTracks as JTracks
from das_diff_veh_tpu.models import tracking as JT
from das_diff_veh_tpu.models import vsg as JV
from das_diff_veh_tpu.models import windows as JW
from das_diff_veh_tpu.ops import dispersion as JD
from das_diff_veh_tpu.pipeline import preprocess as JP
from das_diff_veh_tpu_torch import config as PC
from das_diff_veh_tpu_torch.core.section import VehicleTracks as PTracks
from das_diff_veh_tpu_torch.models import tracking as PT
from das_diff_veh_tpu_torch.models import vsg as PV
from das_diff_veh_tpu_torch.models import windows as PW
from das_diff_veh_tpu_torch.ops import dispersion as PD
from das_diff_veh_tpu_torch.pipeline import preprocess as PP

RNG = np.random.default_rng(47)


def _peak_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _port_cfg(jcfg, cls):
    return cls(**dataclasses.asdict(jcfg))


def _record(nch=24, nt=5000):
    data = RNG.standard_normal((nch, nt)) * 2.0
    data[3] *= 40.0            # loud channel (killed on the tracking band)
    data[7] = 0.0              # dead channel (imputed)
    return data


def test_preprocess_surface_wave_band_matches_jax():
    data = _record()
    jcfg = JC.SurfaceWavePreprocessConfig()
    for normalize in (False, True):
        want = JP.preprocess_for_surface_waves(jnp.asarray(data), 0.004, jcfg, normalize)
        got = PP.preprocess_for_surface_waves(torch.from_numpy(data), 0.004,
                                              _port_cfg(jcfg, PC.SurfaceWavePreprocessConfig),
                                              normalize)
        assert _peak_rel(got.numpy(), want) <= 1e-7


def test_filters_match_jax():
    from das_diff_veh_tpu.ops import filters as JF
    from das_diff_veh_tpu_torch.ops import filters as PF

    data = RNG.standard_normal((24, 5000))
    for n, alpha in [(37, 0.3), (64, 0.05), (1, 0.5), (10, 0.0)]:
        np.testing.assert_allclose(PF.tukey_window(n, alpha).numpy(),
                                   np.asarray(JF.tukey_window(n, alpha)), rtol=0, atol=1e-15)
    for pf, jf in [(PF.taper_time, JF.taper_time), (PF.detrend_linear, JF.detrend_linear),
                   (PF.remove_common_mode, JF.remove_common_mode),
                   (PF.l2_normalize_traces, JF.l2_normalize_traces)]:
        assert _peak_rel(pf(torch.from_numpy(data)).numpy(), jf(jnp.asarray(data))) <= 1e-12
    want = JF.bandpass_space(jnp.asarray(data), 8.16, 0.006, 0.04)
    assert _peak_rel(PF.bandpass_space(torch.from_numpy(data), 8.16, 0.006, 0.04).numpy(),
                     want) <= 1e-7


def test_preprocess_tracking_band_matches_jax():
    data = _record()
    x = np.arange(data.shape[0]) * 8.16 + 16.32
    jcfg = JC.TrackingPreprocessConfig()
    want, wx, ws = JP.preprocess_for_tracking(jnp.asarray(data), x, 0.004, jcfg)
    got, gx, gs = PP.preprocess_for_tracking(torch.from_numpy(data), x, 0.004,
                                             _port_cfg(jcfg, PC.TrackingPreprocessConfig))
    assert got.shape == want.shape and gs == ws
    np.testing.assert_array_equal(gx, wx)
    assert _peak_rel(got.numpy(), want) <= 1e-7


def test_track_section_matches_jax():
    """Whole tracking stage (detection, Kalman filter, QC, upsampling): equal
    validity and NaN pattern; the float32 states agree to the last bit here."""
    data, x, t, _, _ = _tracking_scene(seed=7)
    jcfg = JC.TrackingConfig(max_vehicles=8)
    pcfg = PC.TrackingConfig(max_vehicles=8)
    want = JT.track_section(jnp.asarray(data), x, t, 10.0, 300.0, jcfg)
    got = PT.track_section(torch.from_numpy(data), x, t, 10.0, 300.0, pcfg)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    wt, gt = np.asarray(want.t_idx), got.t_idx.numpy()
    assert gt.dtype == wt.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(gt), np.isnan(wt))
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))


def test_select_windows_and_mute_match_jax():
    data, x, t, states, x_track, t_track, x0 = _make_tracks_and_data()
    jcfg = JC.WindowConfig()
    jtr = JTracks(t_idx=jnp.asarray(states), valid=jnp.ones(states.shape[0], bool),
                  x=jnp.asarray(x_track), t=jnp.asarray(t_track))
    ptr = PTracks(t_idx=torch.from_numpy(states),
                  valid=torch.ones(states.shape[0], dtype=torch.bool),
                  x=torch.from_numpy(x_track), t=torch.from_numpy(t_track))
    want = JW.select_windows(jnp.asarray(data), x, t, jtr, x0, jcfg)
    got = PW.select_windows(torch.from_numpy(data), x, t, ptr, x0,
                            _port_cfg(jcfg, PC.WindowConfig))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() >= 2
    for name in ("data", "x", "t", "traj_x", "traj_t"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    k = int(np.flatnonzero(np.asarray(want.valid))[0])
    tt = np.asarray(want.traj_t[k])
    args = (want.x, want.t[k], want.traj_x[k], jnp.asarray(tt), jnp.isfinite(jnp.asarray(tt)))
    wmask = JW.traj_mute_mask(*args, 8.16)
    gmask = PW.traj_mute_mask(got.x, got.t[k], got.traj_x[k], got.traj_t[k],
                              torch.isfinite(got.traj_t[k]), 8.16)
    np.testing.assert_allclose(gmask.numpy(), np.asarray(wmask), rtol=0, atol=1e-12)


def test_fv_map_fk_matches_jax():
    data = RNG.standard_normal((19, 500))
    freqs = np.arange(0.8, 25.0, 0.1)
    vels = np.arange(200.0, 1200.0, 1.0)
    for norm in (False, True):
        want = JD.fv_map_fk(jnp.asarray(data), 8.16, 0.004, jnp.asarray(freqs),
                            jnp.asarray(vels), norm=norm)
        got = PD.fv_map_fk(torch.from_numpy(data), 8.16, 0.004, freqs, vels, norm=norm)
        assert got.shape == (vels.size, freqs.size)
        assert _peak_rel(got.numpy(), want) <= 1e-7
    mag, fa, ka = PD.fk_transform(torch.from_numpy(data), 8.16, 0.004)
    jmag, jfa, jka = JD.fk_transform(jnp.asarray(data), 8.16, 0.004)
    assert _peak_rel(mag.numpy(), jmag) <= 1e-7
    np.testing.assert_array_equal(fa.numpy(), np.asarray(jfa))
    np.testing.assert_array_equal(ka.numpy(), np.asarray(jka))


@pytest.mark.parametrize("other_side,pivot_frac", [(False, 0.5), (True, 0.5), (True, 0.75)])
def test_build_gather_matches_jax(other_side, pivot_frac):
    data, x, t, traj_x, traj_t, x0 = _window_scene(pivot_frac=pivot_frac)
    jcfg = JC.GatherConfig(include_other_side=other_side)
    pcfg = _port_cfg(jcfg, PC.GatherConfig)
    g = JV.VsgGeometry.build(x, t[1] - t[0], x0, x0 - 150.0, x0 + 75.0, jcfg)
    pg = PV.VsgGeometry.build(x, t[1] - t[0], x0, x0 - 150.0, x0 + 75.0, pcfg)
    assert dataclasses.asdict(pg) == dataclasses.asdict(g)
    want = JV.build_gather(jnp.asarray(data), jnp.asarray(t), jnp.asarray(x),
                           jnp.asarray(traj_x), jnp.asarray(traj_t),
                           jnp.ones(traj_t.size, bool), g, jcfg)
    tens = lambda a: torch.from_numpy(np.asarray(a))
    got = PV.build_gather(tens(data), tens(t), tens(x), tens(traj_x), tens(traj_t),
                          torch.ones(traj_t.size, dtype=torch.bool), pg, pcfg)
    assert got.shape == want.shape == (g.nch_out, g.wlen)
    assert _peak_rel(got.numpy(), want) <= 1e-7
    # the whole-batch form (one gather-kernel call per side) equals per-window
    # calls to float64 rounding (reductions of other shapes round differently)
    batch_fn = lambda d: PV.build_gather(d, tens(np.stack([t, t])), tens(x),
                                         tens(np.stack([traj_x] * 2)),
                                         tens(np.stack([traj_t] * 2)),
                                         torch.ones((2, traj_t.size), dtype=torch.bool),
                                         pg, pcfg)
    both = batch_fn(tens(np.stack([data, data[:, ::-1].copy()])))
    assert _peak_rel(both[0].numpy(), got.numpy()) <= 1e-12
    stacked = PV.stack_gathers(both, torch.tensor([True, False]))
    assert torch.equal(stacked, both[0])


@pytest.mark.parametrize("empty, bad_row", [(False, 0), (False, 4), (False, 5), (True, 2),
                                            (False, None)])
def test_qc_impute_first_noisy_matches_jax(empty, bad_row):
    """The reference's single-channel imputation (contract
    tests/test_dsp.py:166): the edge rule copies the neighbour, an interior
    channel takes the neighbour sum, no match imputes channel 0."""
    from das_diff_veh_tpu.ops.qc import impute_first_noisy as jax_impute
    from das_diff_veh_tpu_torch.ops.qc import impute_first_noisy

    data = np.random.default_rng(11).standard_normal((6, 30))
    if bad_row is not None:
        data[bad_row] = 0.01 if empty else 50.0
    threshold = 1.0 if empty else 5.0
    got = impute_first_noisy(torch.from_numpy(data), threshold, empty=empty).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_impute(jnp.asarray(data), threshold,
                                                             empty=empty)))
    if bad_row == 4:
        np.testing.assert_array_equal(got[4], data[3] + data[5])


def test_qc_kill_loud_channels_matches_jax():
    from das_diff_veh_tpu.ops.qc import kill_loud_channels as jax_kill
    from das_diff_veh_tpu_torch.ops.qc import kill_loud_channels

    data = np.random.default_rng(12).standard_normal((8, 40))
    data[[2, 5]] *= 30.0
    data[6, :21] = 10.5                   # median of an even count at the threshold
    for nt in (40, 39):
        got = kill_loud_channels(torch.from_numpy(data[:, :nt]), 10.0).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_kill(jnp.asarray(data[:, :nt]), 10.0)))
    assert not got[2].any() and got[0].any()
