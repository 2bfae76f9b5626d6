"""Analysis layer: vehicle classification, ridge extraction, bootstrap
uncertainty and class summaries (the counterpart of
``das_diff_veh_tpu/analysis``)."""

from das_diff_veh_tpu_torch.analysis.bootstrap import (bootstrap_disp, convergence_test,
                                                       sample_indices)
from das_diff_veh_tpu_torch.analysis.class_profiles import (class_psd,
                                                            class_timeseries_stats,
                                                            quasi_static_signatures)
from das_diff_veh_tpu_torch.analysis.classed import (ClassedAnalysis, class_stacks,
                                                     classed_analysis)
from das_diff_veh_tpu_torch.analysis.classify import (classify_by_speed, classify_by_weight,
                                                      majority_speed_mask,
                                                      majority_weight_mask,
                                                      quasi_static_peaks, vehicle_speeds)
from das_diff_veh_tpu_torch.analysis.ridge import extract_ridge, extract_ridge_batch
