"""The port's configuration mirrors the JAX package's field for field (the
per-chunk path's, the bootstrap's and the fleet's, ``ObsConfig`` and
``RuntimeConfig``), and ``convert.config_from_dict`` carries a JAX
configuration across."""

import dataclasses

import pytest

from das_diff_veh_tpu import config as J
from das_diff_veh_tpu.runtime import RuntimeConfig as JRuntime
from das_diff_veh_tpu_torch import config as P
from das_diff_veh_tpu_torch.convert import config_from_dict
from das_diff_veh_tpu_torch.runtime import RuntimeConfig as PRuntime

MIRRORED = ["InterrogatorConfig", "DetectConfig", "TrackingConfig", "TrackQCConfig",
            "TrackingPreprocessConfig", "SurfaceWavePreprocessConfig", "WindowConfig",
            "MuteConfig", "GatherConfig", "DispersionConfig", "ImagingConfig",
            "HealthConfig", "ObsConfig", "BootstrapConfig", "FleetInversionConfig"]
# sub-configurations of the JAX PipelineConfig that the port lacks: none
# since the science path (bootstrap, fleet) is ported
NOT_PORTED = set()


@pytest.mark.parametrize("name", MIRRORED)
def test_defaults_match_field_for_field(name):
    assert dataclasses.asdict(getattr(P, name)()) == dataclasses.asdict(getattr(J, name)())


def test_pipeline_config_matches_without_unported_parts():
    jd = {k: v for k, v in dataclasses.asdict(J.PipelineConfig()).items()
          if k not in NOT_PORTED}
    assert dataclasses.asdict(P.PipelineConfig()) == jd
    assert P.DispersionConfig().n_freqs == J.DispersionConfig().n_freqs
    assert P.DispersionConfig().n_vels == J.DispersionConfig().n_vels


def test_runtime_config_matches_field_for_field():
    assert dataclasses.asdict(PRuntime()) == dataclasses.asdict(JRuntime())
    kw = dict(prefetch_depth=4, max_retries=3, retry_quarantined=True, state_every=2,
              trace_path="t.jsonl")
    assert dataclasses.asdict(PRuntime(**kw, obs=P.ObsConfig(flight_dir="f"))) == \
        dataclasses.asdict(JRuntime(**kw, obs=J.ObsConfig(flight_dir="f")))


def test_config_from_dict_round_trip():
    jcfg = J.PipelineConfig().replace(
        imaging=J.ImagingConfig(x0=400.0),
        tracking=J.TrackingConfig(max_vehicles=8, detect=J.DetectConfig(max_peaks=32)),
        gather=J.GatherConfig(traj_gather="serialized"), max_windows=16)
    pcfg = config_from_dict(dataclasses.asdict(jcfg))
    jd = {k: v for k, v in dataclasses.asdict(jcfg).items() if k not in NOT_PORTED}
    assert dataclasses.asdict(pcfg) == jd
    assert pcfg.tracking.detect.max_peaks == 32 and pcfg.imaging.x0 == 400.0


def test_config_from_dict_refuses_unported_modes():
    """The fused chunk is ported and carries across; an unknown chunk
    pipeline is refused."""
    d = dataclasses.asdict(J.PipelineConfig().replace(chunk_pipeline="fused"))
    assert config_from_dict(d).chunk_pipeline == "fused"
    d["chunk_pipeline"] = "bogus"
    with pytest.raises(ValueError, match="chunk_pipeline"):
        config_from_dict(d)


def test_config_from_dict_converts_the_health_sentinel():
    jcfg = J.PipelineConfig().replace(health=J.HealthConfig(enabled=True, clip_limit=4.0,
                                                             impute=False))
    pcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert pcfg.health == P.HealthConfig(enabled=True, clip_limit=4.0, impute=False)
    assert dataclasses.asdict(pcfg.health) == dataclasses.asdict(jcfg.health)
