"""The port's input-health sentinel against the JAX package's: the screen bit
for bit on numpy inputs made from a seed, the host screen and the admission
verdicts, the zero-screen default, and one real chunk with the screen on.

Contracts: the health cases of tests/test_resilience.py.  Both sides run on
the CPU at float64 (conftest runs JAX with x64).
"""

import dataclasses

import numpy as np
import pytest

import das_diff_veh_tpu.resilience.health as JH
import das_diff_veh_tpu_torch.resilience.health as PH
from das_diff_veh_tpu.config import HealthConfig as JHealth
from das_diff_veh_tpu.core.section import DasSection as JSection
from das_diff_veh_tpu.pipeline.timelapse import process_chunk as jax_process_chunk
from das_diff_veh_tpu_torch.config import HealthConfig, PipelineConfig
from das_diff_veh_tpu_torch.convert import config_from_dict, section_from_numpy
from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

FIELDS = ("nan_fraction", "n_nonfinite_channels", "n_dead", "n_clipped")


def _waterfall(nch=16, nt=300, seed=0):
    """NaN, +Inf and -Inf channels, a constant channel, two clipped
    channels, two adjacent bad channels, and bad edge channels."""
    d = np.random.default_rng(seed).standard_normal((nch, nt))
    d[0, 10:40] = np.nan                  # bad edge channel
    d[3, 7] = np.inf
    d[5, 100:103] = -np.inf
    d[6] = 0.25                           # flatline beside a bad channel
    d[8] = 6.0 * np.sign(d[8] + 0.01)     # saturated rail
    d[10, ::3] = 5.5                      # a third of the samples clipped
    d[11, ::40] = 5.0                     # 2.5 % clipped: under 5 %
    d[nch - 1] = 0.0                      # dead edge channel
    return d


CONFIGS = {
    "default": dict(enabled=True),
    "clip": dict(enabled=True, clip_limit=5.0, clip_fraction_max=0.05),
    "clip_no_impute": dict(enabled=True, clip_limit=5.0, impute=False),
    "clip_at_fraction": dict(enabled=True, clip_limit=5.0, clip_fraction_max=0.025),
    "flatline_var": dict(enabled=True, flatline_var=0.5, clip_limit=4.0),
}


def _check_health(got, want):
    np.testing.assert_array_equal(got.healthy, np.asarray(want.healthy))
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.summary() == want.summary()
    assert (got.n_masked, got.degraded) == (want.n_masked, want.degraded)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_screen_arrays_bit_equal_to_jax(name):
    data = _waterfall()
    cfg, jcfg = HealthConfig(**CONFIGS[name]), JHealth(**CONFIGS[name])
    got_data, got = PH.screen_arrays(data, cfg, tag="unit")
    want_data, want = JH.screen_arrays(data, jcfg, tag="unit")
    assert got_data.dtype.is_floating_point and got_data.dtype.itemsize == 8
    np.testing.assert_array_equal(got_data.numpy(), np.asarray(want_data))
    _check_health(got, want)
    assert np.isfinite(got_data.numpy()).all()
    assert got.degraded


def test_screen_masks_the_planted_channels():
    data = _waterfall()
    san, h = PH.screen_arrays(data, HealthConfig(**CONFIGS["clip"]), tag="unit")
    bad = {0, 3, 5, 6, 8, 10, 15}
    assert set(np.flatnonzero(~h.healthy)) == bad
    san = san.numpy()
    for c in set(range(16)) - bad:
        assert np.array_equal(san[c], data[c])
    assert np.array_equal(san[0], san[1])                  # edge copies its neighbour
    assert np.array_equal(san[9], data[9])
    # adjacent bad channels: each sums its good neighbour and a zeroed one
    assert np.array_equal(san[5], data[4]) and np.array_equal(san[6], data[7])


def test_clean_data_passes_bit_identical():
    data = np.random.default_rng(4).standard_normal((12, 200))
    san, h = PH.screen_arrays(data, HealthConfig(enabled=True), tag="unit")
    assert h.healthy.all() and not h.degraded and h.ok(HealthConfig())
    assert np.array_equal(san.numpy(), data)


def test_quick_screen_and_admission_match_jax():
    for name, kw in CONFIGS.items():
        data = _waterfall(seed=5)
        got, want = PH.quick_screen(data, HealthConfig(**kw)), JH.quick_screen(data, JHealth(**kw))
        _check_health(got, want)
        _, fused = PH.screen_arrays(data, HealthConfig(**kw), tag="unit")
        assert got.summary() == fused.summary(), name
        for bound in (0.0, 0.01, 0.25):
            cfg = HealthConfig(**kw, max_masked_fraction=bound, nan_fraction_max=bound / 10)
            jcfg = JHealth(**kw, max_masked_fraction=bound, nan_fraction_max=bound / 10)
            assert PH.admission_verdict(got, cfg) == JH.admission_verdict(want, jcfg)
    ok = PH.quick_screen(np.random.default_rng(6).standard_normal((8, 50)), HealthConfig())
    assert PH.admission_verdict(ok, HealthConfig()) is None


def test_poison_verdicts():
    cfg = HealthConfig(enabled=True, max_masked_fraction=0.25)
    data = np.random.default_rng(1).standard_normal((8, 100))
    data[:4] = np.nan                      # half the fiber gone
    _, h = PH.screen_arrays(data, cfg, tag="unit")
    _, jh = JH.screen_arrays(data, JHealth(enabled=True, max_masked_fraction=0.25), tag="unit")
    assert not h.ok(cfg) and not jh.ok(JHealth(max_masked_fraction=0.25))
    assert str(PH.PoisonedChunkError(h)) == str(JH.PoisonedChunkError(jh))
    assert PH.admission_verdict(h, cfg) is not None
    sec = section_from_numpy(data, np.arange(8) * 8.16, np.arange(100) * 0.004, device="cpu")
    pcfg = PipelineConfig().replace(health=cfg)
    with pytest.raises(PH.PoisonedChunkError, match="4/8 channels masked"):
        process_chunk(sec, pcfg, device="cpu")
    out, _ = PH.screen_section(sec, HealthConfig(enabled=True), tag="unit")
    assert out.x is sec.x and out.t is sec.t


def test_disabled_screen_never_runs_in_process_chunk(pipeline_scene, pipeline_cfg):
    section, _ = pipeline_scene
    sec = section_from_numpy(np.asarray(section.data), np.asarray(section.x),
                             np.asarray(section.t), device="cpu")
    cfg = config_from_dict(dataclasses.asdict(pipeline_cfg))
    assert not cfg.health.enabled
    before = PH.n_screens("process_chunk")
    res = process_chunk(sec, cfg, device="cpu")
    assert res.health is None and PH.n_screens("process_chunk") == before


def _peak_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_chunk_with_screen_matches_jax(pipeline_scene, pipeline_cfg, monkeypatch):
    """3 NaN channels and a flatline channel, the screen on: the image
    within 1e-7 peak-relative of JAX and the same health summary.  The JAX
    screen counts into a fresh ``SCREENS_BY_TAG``, restored afterwards:
    tests/test_resilience.py pins that nothing in the suite screens under
    the JAX tag "process_chunk"."""
    monkeypatch.setattr(JH, "SCREENS_BY_TAG", {})
    section, _ = pipeline_scene
    data = np.array(section.data)
    data[[20, 47, 48], 500:900] = np.nan
    data[60] = 0.5
    jcfg = pipeline_cfg.replace(health=JHealth(enabled=True))
    want = jax_process_chunk(JSection(data, np.asarray(section.x), np.asarray(section.t)),
                             jcfg, method="xcorr")
    before = PH.n_screens("process_chunk")
    got = process_chunk(section_from_numpy(data, np.asarray(section.x), np.asarray(section.t),
                                           device="cpu"),
                        config_from_dict(dataclasses.asdict(jcfg)), method="xcorr",
                        device="cpu")
    assert PH.n_screens("process_chunk") == before + 1
    assert got.health.summary() == want.health.summary()
    assert got.health.summary()["n_masked"] == 4
    np.testing.assert_array_equal(got.health.healthy, np.asarray(want.health.healthy))
    assert got.n_windows == want.n_windows
    assert _peak_rel(got.disp_image.numpy(), want.disp_image) <= 1e-7
