"""Window-mean cross-spectra of source rows against receiver rows: the
counterpart of the Pallas kernel
``das_diff_veh_tpu/ops/pallas_xcorr.py::_spectra_tile_kernel`` (entry
``_pallas_cross_spectra``), the product stage of the all-pairs path.

    C[s, r, f] = sum over slabs ((sum_{w in slab} S[s,w,f] conj(R[r,w,f])) * (1/nwin))

The window axis is cut into ``win_block`` slabs (the last one ragged); each
slab's sum starts from zero, is scaled by ``1/nwin`` and is added to the
output, in the Pallas kernel's order.  The TPU kernel's planar split and
(32, 128) tile padding are not carried over: both versions here take the
spectra interleaved, in one of two tiers:

- ``"f32"``: complex64 as ``torch.fft.rfft`` leaves them;
- ``"bf16"``: (n, nwin, nf, 2) bfloat16 pairs (:func:`to_bf16_pairs`), the
  counterpart of the Pallas kernel's bf16 planes.  Each value is widened to
  float32 exactly and the float32 arithmetic is the f32 tier's, so the plain
  version of the bf16 tier is ``bf16_round`` of both spectra followed by the
  f32 plain version.

The output is complex64 (m, nall, nf) in both tiers.

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


def to_bf16_pairs(spectra: torch.Tensor) -> torch.Tensor:
    """Complex (n, nwin, nf) spectra -> the bf16 tier's contiguous (n, nwin,
    nf, 2) bfloat16 (re, im) pairs, each part rounded to nearest even: 4
    bytes a value instead of complex64's 8."""
    return torch.view_as_real(spectra.to(torch.complex64)).to(torch.bfloat16).contiguous()


def is_bf16_pairs(x: torch.Tensor) -> bool:
    return x.dtype == torch.bfloat16 and x.dim() == 4 and x.shape[-1] == 2


def _widened(x: torch.Tensor) -> torch.Tensor:
    """Real (re, im) view of either tier's spectra; bf16 pairs are widened
    to float32, which is exact."""
    return x.to(torch.float32) if is_bf16_pairs(x) else torch.view_as_real(x)


def cross_spectra_plain(src: torch.Tensor, rcv: torch.Tensor, nwin: int,
                        win_block: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, one window after another in the
    kernel's order and rounding: (m, nwin, nf) x (nall, nwin, nf) spectra,
    complex or both bf16 pairs, -> (m, nall, nf) complex."""
    s, r = _widened(src), _widened(rcv)
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
    contract as :func:`cross_spectra_plain` for contiguous CUDA spectra, both
    complex64 (the f32 tier) or both bf16 pairs (the bf16 tier)."""
    global launches
    from das_diff_veh_tpu_torch import kernels

    bf16 = is_bf16_pairs(src)
    want = "(n, nwin, nf, 2) bfloat16" if bf16 else "(n, nwin, nf) complex64"
    for name, x in (("source", src), ("receiver", rcv)):
        ok = is_bf16_pairs(x) if bf16 else (x.dtype == torch.complex64 and x.dim() == 3)
        if not x.is_cuda or not ok:
            raise ValueError(f"cross_spectra kernel takes {want} CUDA {name} spectra "
                             f"(both tiers alike), got {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"cross_spectra kernel needs contiguous {name} spectra")
    if rcv.device != src.device:
        raise ValueError(f"source spectra on {src.device}, receiver spectra on {rcv.device}")
    m, nw, nf = src.shape[:3]
    nall = rcv.shape[0]
    if nw != nwin or rcv.shape[1:3] != (nwin, nf) or nwin < 1:
        raise ValueError(f"spectra {tuple(src.shape)} x {tuple(rcv.shape)} do not share "
                         f"nwin={nwin} windows and one frequency axis")
    if not 1 <= win_block <= nwin:
        raise ValueError(f"win_block must be in [1, nwin={nwin}], got {win_block}")
    if nall * nf >= 2 ** 31:
        raise ValueError(f"cross_spectra kernel takes fewer than 2^31 receiver values a "
                         f"source row, got nall={nall} x nf={nf}")
    out = torch.empty((m, nall, nf), dtype=torch.complex64, device=src.device)
    fn = kernels.load("cross_spectra").cross_spectra
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(src.data_ptr(), rcv.data_ptr(), out.data_ptr(), m, nall, nwin, nf,
                win_block, _inv(nwin), int(bf16), stream)
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


def bytes_moved(m: int, nall: int, nwin: int, nf: int, precision: str = "f32") -> int:
    """Least bytes one launch must move: both spectra read once (8 bytes a
    value in f32, 4 in bf16) and the complex64 (m, nall, nf) output written
    once."""
    per_value = 4 if precision == "bf16" else 8
    return per_value * (m + nall) * nwin * nf + 8 * m * nall * nf


def flops(m: int, nall: int, nwin: int, nf: int) -> int:
    """Real float32 operations of one launch: 8 per complex multiply-add."""
    return 8 * m * nall * nwin * nf
