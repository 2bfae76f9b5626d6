"""Resilience: chaos injection and input-health screening (the part of
``das_diff_veh_tpu/resilience`` on the batch path).

- :mod:`faults` — deterministic, seeded fault injection behind named sites
  threaded through the loaders and the batch executor (off by default, one
  global read when off);
- :mod:`health` — the input-health sentinel (NaN/Inf, flatline, clipping
  per channel) producing the ``ChannelHealth`` mask, plus the numpy screen
  for admission.

The degradation ladder (``resilience/degrade.py``) is not ported yet
(ROADMAP item 5): nothing in the port demotes a code path after a failure.
Knobs live in ``config.HealthConfig`` (``PipelineConfig.health``).
"""

from das_diff_veh_tpu_torch.config import HealthConfig
from das_diff_veh_tpu_torch.resilience.faults import (FaultInjector, FaultPlan,
                                                      FaultSpec, InjectedFault,
                                                      injected, install, uninstall)
from das_diff_veh_tpu_torch.resilience.health import (ChannelHealth,
                                                      PoisonedChunkError,
                                                      admission_verdict,
                                                      quick_screen, screen_arrays,
                                                      screen_section)

__all__ = [
    "HealthConfig",
    "FaultPlan", "FaultSpec", "FaultInjector", "InjectedFault",
    "injected", "install", "uninstall",
    "ChannelHealth", "PoisonedChunkError", "screen_arrays", "screen_section",
    "quick_screen", "admission_verdict",
]
