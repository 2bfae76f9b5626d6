"""The port's analysis layer (``das_diff_veh_tpu_torch/analysis``) against
the JAX package on the CPU: ridge extraction in its three modes, the
bootstrap with and without the count mask, the convergence study, and the
classification and class-profile helpers.

The same seeded numpy inputs go to both packages at float64.  Ridge picks
are held equal (the raw picks, with a one-tap smoother, and the smoothed
curves at 1e-12); the bootstrap's ridges equal and the convergence study's
spreads at 1e-10; the classification at 1e-12 with masks equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import interp1d

from das_diff_veh_tpu import analysis as JA
from das_diff_veh_tpu import config as JC
from das_diff_veh_tpu.core.section import VehicleTracks as JTracks
from das_diff_veh_tpu.core.section import WindowBatch as JBatch
from das_diff_veh_tpu_torch import analysis as PA
from das_diff_veh_tpu_torch import config as PC
from das_diff_veh_tpu_torch.core.section import VehicleTracks as PTracks
from das_diff_veh_tpu_torch.core.section import WindowBatch as PBatch

RNG = np.random.default_rng(29)


@pytest.fixture(autouse=True)
def one_thread():
    """The suite runs in several worker processes on a few cores: PyTorch's
    CPU pool of one thread a core in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _fv_map(rng, nvel=400, nfreq=120):
    """A dispersion-like map: one bright dispersive ridge + texture."""
    vels = np.arange(200.0, 200.0 + nvel)
    freqs = np.linspace(2.0, 20.0, nfreq)
    ridge = 500.0 - 8.0 * (freqs - 2.0)
    fv = np.exp(-0.5 * ((vels[:, None] - ridge[None, :]) / 40.0) ** 2)
    return freqs, vels, fv + 0.1 * rng.random((nvel, nfreq))


def _ridge_kw(mode, freqs):
    if mode == "none":
        return dict(vel_max=520.0)
    if mode == "ref_idx":
        return dict(ref_freq_idx=60, sigma=30.0)
    if mode == "ref_vel":
        return dict(ref_vel=lambda f: 500.0 - 8.0 * (f - 2.0), sigma=30.0)
    return dict(ref_vel=interp1d(freqs, 500.0 - 8.0 * (freqs - 2.0)), sigma=40.0)


@pytest.mark.parametrize("mode", ["none", "ref_idx", "ref_vel", "ref_interp1d"])
def test_extract_ridge_matches_jax(mode):
    freqs, vels, fv = _fv_map(RNG)
    kw = _ridge_kw(mode, freqs)
    want = np.asarray(JA.extract_ridge(freqs, vels, jnp.asarray(fv), **kw))
    got = PA.extract_ridge(freqs, vels, torch.as_tensor(fv), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # the raw picks (a one-tap smoother) are equal
    raw_j = np.asarray(JA.extract_ridge(freqs, vels, jnp.asarray(fv), sg_window=1,
                                        sg_order=0, **kw))
    raw_p = PA.extract_ridge(freqs, vels, torch.as_tensor(fv), sg_window=1, sg_order=0,
                             **kw).numpy()
    np.testing.assert_array_equal(raw_p, raw_j)


def test_extract_ridge_ties_take_the_first_maximum():
    """A flat map: every masked argmax ties, and both packages take the
    first index of the (reversed) velocity axis."""
    freqs = np.linspace(2.0, 20.0, 40)
    vels = np.arange(200.0, 600.0)
    fv = np.ones((vels.size, freqs.size))
    for kw in (dict(vel_max=450.0), dict(ref_freq_idx=10, sigma=30.0)):
        want = np.asarray(JA.extract_ridge(freqs, vels, jnp.asarray(fv), sg_window=1,
                                           sg_order=0, **kw))
        got = PA.extract_ridge(freqs, vels, torch.as_tensor(fv), sg_window=1, sg_order=0,
                               **kw).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["none", "ref_idx", "ref_interp1d"])
def test_extract_ridge_batch_matches_jax(mode):
    rng = np.random.default_rng(5)
    freqs, vels, _ = _fv_map(rng)
    maps = np.stack([_fv_map(rng)[2] for _ in range(4)])
    kw = _ridge_kw(mode, freqs)
    want = np.asarray(JA.extract_ridge_batch(freqs, vels, jnp.asarray(maps), **kw))
    got = PA.extract_ridge_batch(freqs, vels, torch.as_tensor(maps), **kw).numpy()
    assert got.shape == want.shape == (4, freqs.size)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def _gathers(seed=7, nwin=8, nch=20, wlen=250):
    return np.random.default_rng(seed).standard_normal((nwin, nch, wlen))


BOOT = dict(bt_times=3, bt_size=3, sigma=(30.0, 50.0), ref_freq_idx=(10, 30),
            freq_lb=(3.0, 8.0), freq_ub=(16.0, 22.0))


@pytest.mark.parametrize("counts", [False, True])
def test_bootstrap_disp_matches_jax(counts):
    g = _gathers()
    offsets = (np.arange(g.shape[1]) - g.shape[1] + 1) * 8.16
    jd, pd = (JC.DispersionConfig(freq_step=0.5, vel_step=10.0),
              PC.DispersionConfig(freq_step=0.5, vel_step=10.0))
    jb, pb = JC.BootstrapConfig(**BOOT), PC.BootstrapConfig(**BOOT)
    idx = PA.sample_indices(g.shape[0], 3, 3, np.random.default_rng(5))
    np.testing.assert_array_equal(idx, JA.sample_indices(g.shape[0], 3, 3,
                                                         np.random.default_rng(5)))
    kw = {}
    if counts:
        idx = np.concatenate([idx, np.broadcast_to(idx[:, :1], (3, 4))], axis=1)
        kw = dict(counts=np.full(3, 3))
    rj, fj = JA.bootstrap_disp(jnp.asarray(g), offsets, 0.004, 8.16, idx, jb, jd, **kw)
    rp, fp = PA.bootstrap_disp(torch.as_tensor(g), offsets, 0.004, 8.16, idx, pb, pd, **kw)
    np.testing.assert_array_equal(fp, fj)
    assert len(rp) == len(rj) == 2
    for a, b in zip(rp, rj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12, atol=0)


def test_convergence_test_matches_jax():
    g = _gathers(seed=21, nwin=10)
    offsets = (np.arange(g.shape[1]) - g.shape[1] + 1) * 8.16
    kw = dict(bt_times=3, sigma=(50.0,), ref_freq_idx=(12,), freq_lb=(3.0,), freq_ub=(12.0,))
    want = JA.convergence_test(jnp.asarray(g), offsets, 0.004, 8.16, 4, 3,
                               np.random.default_rng(1), JC.BootstrapConfig(**kw),
                               JC.DispersionConfig(freq_step=0.25, vel_step=25.0))
    got = PA.convergence_test(torch.as_tensor(g), offsets, 0.004, 8.16, 4, 3,
                              np.random.default_rng(1), PC.BootstrapConfig(**kw),
                              PC.DispersionConfig(freq_step=0.25, vel_step=25.0))
    assert got.shape == (1, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_bootstrap_entry_points_need_a_card_unless_given_a_cpu_tensor():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PA.bootstrap_disp(_gathers(), np.arange(20.0), 0.004, 8.16, np.array([[1, 2]]))


# -- classification and class profiles ---------------------------------------

def _scene(bumps, speeds_mps, nch=6, nt=1024):
    """(jax, port) window batch and tracks of the JAX tests' classed scene."""
    nveh = len(bumps)
    fs, dt_track = 250.0, 0.02
    t = np.arange(nt) / fs
    data = np.random.default_rng(8).standard_normal((nveh, nch, nt)) * 0.01
    for w, b in enumerate(bumps):
        data[w] += b * np.exp(-0.5 * ((t - 2.0) / 0.3) ** 2)[None, :]
    valid = np.ones(nveh, bool)
    valid[-1] = len(bumps) < 8
    x_track = np.arange(50.0)
    t_idx = np.stack([x_track / (v * dt_track) for v in speeds_mps])
    t_idx[1, :7] = np.nan                       # a partly tracked vehicle
    tt = np.broadcast_to(t, (nveh, nt)).copy()
    fields = dict(data=data, x=np.arange(nch, dtype=np.float64), t=tt,
                  traj_x=np.zeros((nveh, 4)), traj_t=np.zeros((nveh, 4)), valid=valid)
    tr = dict(t_idx=t_idx, valid=np.ones(nveh, bool), x=x_track,
              t=np.arange(2000.0) * dt_track)
    return ((JBatch(**{k: jnp.asarray(v) for k, v in fields.items()}),
             JTracks(**{k: jnp.asarray(v) for k, v in tr.items()})),
            (PBatch(**{k: torch.as_tensor(v) for k, v in fields.items()}),
             PTracks(**{k: torch.as_tensor(v) for k, v in tr.items()})))


SPEED_SCENE = ([1.0, 1.05, 0.95, 3.0, 1.0, 1.02, 0.98, 1.0],
               [20.0, 20.0, 15.0, 15.0, 15.0, 15.0, 10.0, 10.0])
WEIGHT_SCENE = ([1.5, 1.6, 0.5, 0.52, 0.48, 0.5, 0.9, 0.92], [15.0] * 8)


def test_vehicle_speeds_and_signatures_match_jax():
    (jb, jt), (pb, pt) = _scene(*SPEED_SCENE)
    np.testing.assert_allclose(PA.vehicle_speeds(pt).numpy(),
                               np.asarray(JA.vehicle_speeds(jt)), rtol=1e-12, atol=0)
    sj = np.asarray(JA.quasi_static_signatures(jb))
    sp = PA.quasi_static_signatures(pb).numpy()
    np.testing.assert_array_equal(np.isnan(sp), np.isnan(sj))
    ok = ~np.isnan(sj)
    np.testing.assert_allclose(sp[ok], sj[ok], rtol=1e-12, atol=1e-12 * np.abs(sj[ok]).max())
    pj = np.asarray(JA.quasi_static_peaks(jb))
    pp = PA.quasi_static_peaks(pb).numpy()
    np.testing.assert_allclose(pp, pj, rtol=1e-12, atol=0)


def test_class_masks_match_jax():
    rng = np.random.default_rng(3)
    speeds = np.concatenate([rng.normal(15, 1, 200), [30.0, 31.0], [5.0], [np.nan]])
    peaks = np.concatenate([rng.normal(0.8, 0.05, 300), rng.uniform(1.3, 3.0, 20), [np.nan]])
    for fn in ("classify_by_speed", "classify_by_weight"):
        arg = speeds if fn == "classify_by_speed" else peaks
        for a, b in zip(getattr(PA, fn)(arg), getattr(JA, fn)(arg)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PA.majority_speed_mask(speeds), JA.majority_speed_mask(speeds))
    np.testing.assert_array_equal(PA.majority_weight_mask(peaks), JA.majority_weight_mask(peaks))
    empty = np.full(3, np.nan)
    assert not PA.majority_weight_mask(empty).any() and not any(
        m.any() for m in PA.classify_by_speed(empty))


def test_class_profiles_match_jax():
    (jb, _), (pb, _) = _scene(*SPEED_SCENE)
    masks = {"a": np.array([1, 1, 0, 0, 1, 0, 0, 0], bool),
             "b": np.array([0, 0, 1, 1, 0, 1, 1, 1], bool),
             "one": np.array([0, 0, 0, 0, 0, 0, 1, 0], bool),
             "none": np.zeros(8, bool)}
    sj = np.asarray(JA.quasi_static_signatures(jb))
    tj = JA.class_timeseries_stats(sj, masks)
    tp = PA.class_timeseries_stats(PA.quasi_static_signatures(pb), masks)
    for name in masks:
        for a, b in zip(tp[name], tj[name]):
            np.testing.assert_allclose(a, b, rtol=1e-11, atol=1e-12, equal_nan=True)
    fj, cj = JA.class_psd(np.asarray(jb.data), masks, 250.0, nperseg=256)
    fp, cp = PA.class_psd(pb.data, masks, 250.0, nperseg=256)
    np.testing.assert_allclose(fp, np.asarray(fj), rtol=1e-12)
    for name in masks:
        np.testing.assert_allclose(cp[name][0], cj[name][0], rtol=1e-12, equal_nan=True)
        np.testing.assert_allclose(cp[name][1], cj[name][1], rtol=1e-12)


@pytest.mark.parametrize("by,scene", [("speed", SPEED_SCENE), ("weight", WEIGHT_SCENE)])
def test_classed_analysis_matches_jax(by, scene):
    (jb, jt), (pb, pt) = _scene(*scene)
    rj = JA.classed_analysis(jb, jt, by=by, fs=250.0, nperseg=256)
    rp = PA.classed_analysis(pb, pt, by=by, fs=250.0, nperseg=256)
    assert rp.masks.keys() == rj.masks.keys()
    for name in rj.masks:
        np.testing.assert_array_equal(rp.masks[name], rj.masks[name])
        for a, b in zip(rp.ts_stats[name], rj.ts_stats[name]):
            np.testing.assert_allclose(a, b, rtol=1e-11, atol=1e-12, equal_nan=True)
        np.testing.assert_allclose(rp.psd[name][0], rj.psd[name][0], rtol=1e-12,
                                   equal_nan=True)
    np.testing.assert_array_equal(rp.majority, rj.majority)
    np.testing.assert_allclose(rp.speeds, rj.speeds, rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose(rp.peaks, rj.peaks, rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose(rp.psd_freqs, rj.psd_freqs, rtol=1e-12)


def test_class_stacks_match_jax():
    per_win = RNG.standard_normal((8, 3, 4))
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)
    masks = {"a": np.array([1, 1, 0, 0, 0, 0, 0, 1], bool),
             "b": np.array([0, 0, 1, 1, 1, 0, 0, 0], bool)}
    want = JA.class_stacks(jnp.asarray(per_win), valid, masks)
    got = PA.class_stacks(torch.as_tensor(per_win), torch.as_tensor(valid), masks)
    for name in masks:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-12)
