"""Peak |x| over the lag axis: the counterpart of the Pallas reduction
``das_diff_veh_tpu/ops/pallas_xcorr.py::_lag_absmax_kernel`` (entry
``_pallas_lag_absmax``), which the fused peak finish of the all-pairs path
runs on every receiver block.

:func:`lag_absmax` is the wrapper: for a CUDA tensor it launches the
hand-written kernel ``csrc/lag_absmax.cu`` or raises; for a CPU tensor it runs
:func:`lag_absmax_plain`, the plain PyTorch version of the same function.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

launches = 0


def lag_absmax_plain(lag: torch.Tensor) -> torch.Tensor:
    """(npairs, nlag) -> (npairs,) ``max |lag|`` per row; NaN propagates."""
    return lag.abs().amax(dim=-1)


def lag_absmax_cuda(lag: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/lag_absmax.cu`` on PyTorch's current stream; same
    contract as :func:`lag_absmax_plain` for a contiguous float32 CUDA
    tensor."""
    global launches
    from das_diff_veh_tpu_torch import kernels

    if not lag.is_cuda or lag.dtype != torch.float32 or lag.dim() != 2:
        raise ValueError(f"lag_absmax kernel takes an (npairs, nlag) float32 CUDA "
                         f"tensor, got {tuple(lag.shape)} {lag.dtype} on {lag.device}")
    if not lag.is_contiguous():
        raise ValueError("lag_absmax kernel needs a contiguous lag block")
    npairs, nlag = lag.shape
    if nlag == 0:
        raise ValueError("lag_absmax needs at least one lag")
    out = torch.empty((npairs,), dtype=torch.float32, device=lag.device)
    fn = kernels.load("lag_absmax").lag_absmax
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    with torch.cuda.device(lag.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(lag.data_ptr(), out.data_ptr(), npairs, nlag, stream)
    if rc != 0:
        raise RuntimeError(f"lag_absmax kernel launch failed with CUDA error {rc}")
    launches += 1
    return out


def lag_absmax(lag: torch.Tensor) -> torch.Tensor:
    """Per-row peak |lag| of an (npairs, nlag) block: the kernel on the card,
    the plain version on the CPU."""
    if lag.is_cuda:
        return lag_absmax_cuda(lag)
    return lag_absmax_plain(lag)


def bytes_moved(npairs: int, nlag: int) -> int:
    """Least bytes one reduction must move: the float32 block read once and
    the (npairs,) float32 result written once."""
    return 4 * npairs * nlag + 4 * npairs
