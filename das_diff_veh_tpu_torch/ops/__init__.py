"""Numerical operators of the port: filters, resampling, peaks,
correlation, dispersion, the all-pairs correlation, Welch PSD, the Morlet
CWT, f-v enhancement (CLAHE + blur), and the wrappers of the hand-written
kernels (trajectory gather, cross-spectra, lag-axis peak, the day stack's
band finish)."""

from das_diff_veh_tpu_torch.ops.cwt import cwt_morlet, pick_travel_times
from das_diff_veh_tpu_torch.ops.enhance import box_blur_u8, clahe_u8, fv_map_enhance
from das_diff_veh_tpu_torch.ops.filters import (bandpass_space, bandpass_time, das_preprocess,
                                                detrend_linear, remove_common_mode, taper_time,
                                                tukey_window)
from das_diff_veh_tpu_torch.ops.psd import stack_avg_psd, welch_psd
from das_diff_veh_tpu_torch.ops.qc import empty_trace_mask, impute_traces, noisy_trace_mask
from das_diff_veh_tpu_torch.ops.resample import resample_poly
from das_diff_veh_tpu_torch.ops.savgol import savgol_filter
