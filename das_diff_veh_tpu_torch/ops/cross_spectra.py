"""Window-mean cross-spectra of source rows against receiver rows: the
counterpart of the Pallas kernel
``das_diff_veh_tpu/ops/pallas_xcorr.py::_spectra_tile_kernel`` (entry
``_pallas_cross_spectra``), the product stage of the all-pairs path.

    C[s, r, f] = sum over slabs ((sum_{w in slab} S[s,w,f] conj(R[r,w,f])) * (1/nwin))

The window axis is cut into ``win_block`` slabs (the last one ragged); each
slab's sum starts from zero, is scaled by ``1/nwin`` and is added to the
output, in the Pallas kernel's order.  The TPU kernel's planar split and
(32, 128) tile padding are not carried over: both versions here take the
interleaved complex64 spectra as ``torch.fft.rfft`` leaves them.

:func:`cross_spectra` is the wrapper: for CUDA tensors it launches the
hand-written kernel ``csrc/cross_spectra.cu`` or raises; for CPU tensors it
runs :func:`cross_spectra_plain`.  ``launches`` counts kernel launches and
nothing else.
"""

from __future__ import annotations

import ctypes

import torch

launches = 0


def _inv(nwin: int) -> float:
    """float32(1/nwin), the scale both versions apply to each slab."""
    return float(torch.tensor(1.0 / nwin, dtype=torch.float32))


def cross_spectra_plain(src: torch.Tensor, rcv: torch.Tensor, nwin: int,
                        win_block: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, one window after another in the
    kernel's order and rounding: complex (m, nwin, nf) x (nall, nwin, nf) ->
    (m, nall, nf)."""
    s, r = torch.view_as_real(src), torch.view_as_real(rcv)
    a, b = s[:, None, :, :, 0], s[:, None, :, :, 1]       # (m, 1, nwin, nf)
    c, d = r[None, :, :, :, 0], r[None, :, :, :, 1]       # (1, nall, nwin, nf)
    shape = (src.shape[0], rcv.shape[0], src.shape[2])
    inv = torch.tensor(_inv(nwin), dtype=s.dtype, device=s.device)
    out_r = s.new_zeros(shape)
    out_i = s.new_zeros(shape)
    for w0 in range(0, nwin, win_block):
        acc_r = s.new_zeros(shape)
        acc_i = s.new_zeros(shape)
        for w in range(w0, min(w0 + win_block, nwin)):
            aw, bw, cw, dw = a[:, :, w], b[:, :, w], c[:, :, w], d[:, :, w]
            acc_r = acc_r + (aw * cw + bw * dw)
            acc_i = acc_i + (bw * cw - aw * dw)
        out_r = out_r + acc_r * inv
        out_i = out_i + acc_i * inv
    return torch.complex(out_r, out_i)


def cross_spectra_cuda(src: torch.Tensor, rcv: torch.Tensor, nwin: int,
                       win_block: int) -> torch.Tensor:
    """Launch ``csrc/cross_spectra.cu`` on PyTorch's current stream; same
    contract as :func:`cross_spectra_plain` for contiguous complex64 CUDA
    tensors."""
    global launches
    from das_diff_veh_tpu_torch import kernels

    for name, x in (("source", src), ("receiver", rcv)):
        if not x.is_cuda or x.dtype != torch.complex64 or x.dim() != 3:
            raise ValueError(f"cross_spectra kernel takes (n, nwin, nf) complex64 CUDA "
                             f"{name} spectra, got {tuple(x.shape)} {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"cross_spectra kernel needs contiguous {name} spectra")
    if rcv.device != src.device:
        raise ValueError(f"source spectra on {src.device}, receiver spectra on {rcv.device}")
    m, nw, nf = src.shape
    nall = rcv.shape[0]
    if nw != nwin or rcv.shape[1:] != (nwin, nf) or nwin < 1:
        raise ValueError(f"spectra {tuple(src.shape)} x {tuple(rcv.shape)} do not share "
                         f"nwin={nwin} windows and one frequency axis")
    if not 1 <= win_block <= nwin:
        raise ValueError(f"win_block must be in [1, nwin={nwin}], got {win_block}")
    out = torch.empty((m, nall, nf), dtype=torch.complex64, device=src.device)
    fn = kernels.load("cross_spectra").cross_spectra
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                               ctypes.c_void_p]
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(src.data_ptr(), rcv.data_ptr(), out.data_ptr(), m, nall, nwin, nf,
                win_block, _inv(nwin), stream)
    if rc != 0:
        raise RuntimeError(f"cross_spectra kernel launch failed with CUDA error {rc}")
    launches += 1
    return out


def cross_spectra(src: torch.Tensor, rcv: torch.Tensor, nwin: int,
                  win_block: int) -> torch.Tensor:
    """Window-mean cross-spectra: the kernel on the card, the plain version
    on the CPU."""
    if src.is_cuda:
        return cross_spectra_cuda(src, rcv, nwin, win_block)
    return cross_spectra_plain(src, rcv, nwin, win_block)


def bytes_moved(m: int, nall: int, nwin: int, nf: int) -> int:
    """Least bytes one launch must move: both complex64 spectra read once and
    the complex64 (m, nall, nf) output written once."""
    return 8 * ((m + nall) * nwin * nf + m * nall * nf)


def flops(m: int, nall: int, nwin: int, nf: int) -> int:
    """Real float32 operations of one launch: 8 per complex multiply-add."""
    return 8 * m * nall * nwin * nf
