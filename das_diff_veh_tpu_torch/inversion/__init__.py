"""Differentiable Rayleigh-wave Vs inversion (the counterpart of
``das_diff_veh_tpu/inversion``): the layered forward model, the swarm +
Adam search, the fleet engine and the sensitivity kernels."""

from das_diff_veh_tpu_torch.inversion.curves import (Curve, curves_from_ridges,
                                                     load_reference_ridge_npz, ridge_stats)
from das_diff_veh_tpu_torch.inversion.fleet import (CurveBatch, FleetResult, VsShiftEvent,
                                                    detect_vs_shifts, invert_fleet,
                                                    make_packed_misfit_fn, pack_curve_sets)
from das_diff_veh_tpu_torch.inversion.forward import (LayeredModel, density_gardner_linear,
                                                      phase_velocity,
                                                      rayleigh_halfspace_velocity,
                                                      scan_mode_diagnostics, secular,
                                                      vp_from_poisson)
from das_diff_veh_tpu_torch.inversion.invert import (InversionResult, LayerBounds, ModelSpec,
                                                     invert, invert_multirun, make_misfit_fn,
                                                     speed_model_spec, weight_model_spec)
from das_diff_veh_tpu_torch.inversion.sensitivity import (SensitivityKernel,
                                                          phase_sensitivity, resample_fine)

__all__ = [
    "Curve", "curves_from_ridges", "load_reference_ridge_npz", "ridge_stats",
    "LayeredModel", "density_gardner_linear", "phase_velocity",
    "rayleigh_halfspace_velocity", "scan_mode_diagnostics",
    "secular", "vp_from_poisson",
    "InversionResult", "LayerBounds", "ModelSpec", "invert",
    "invert_multirun", "make_misfit_fn",
    "CurveBatch", "FleetResult", "VsShiftEvent", "detect_vs_shifts",
    "invert_fleet", "make_packed_misfit_fn", "pack_curve_sets",
    "speed_model_spec", "weight_model_spec",
    "SensitivityKernel", "phase_sensitivity", "resample_fine",
]
