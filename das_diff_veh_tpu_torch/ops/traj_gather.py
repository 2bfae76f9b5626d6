"""Trajectory-following window cut: the counterpart of
``das_diff_veh_tpu/ops/pallas_gather.py`` (``traj_follow_windows``, whose
Pallas body is ``_pack_kernel``).

For every window slot b and output channel ``ch_indices[k]``, cut ``nwin``
overlapping windows of ``wlen`` samples at ``base + w*offset`` from that
channel and from the pivot channel of the same slot, zeroing every window
that does not fit the numpy-parity slice (``ops.xcorr.window_slice_avail``).
Valid windows are exact copies of the record.

:func:`traj_follow_windows` is the wrapper: for a CUDA tensor it launches the
hand-written kernel ``csrc/traj_gather.cu`` (all slots and channels in one
launch) or raises; for a CPU tensor it runs :func:`pack_windows_plain`, the
plain PyTorch version of the same function.  ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

launches = 0

FUSED_MAX_NWIN = 64     # default of GatherConfig.fused_max_nwin


def _cap(max_nwin: int | None) -> int:
    return FUSED_MAX_NWIN if max_nwin is None else int(max_nwin)


def fused_supported(nwin: int, max_nwin: int | None = None) -> bool:
    """Shape gate of ``traj_gather="auto"``."""
    return 1 <= nwin <= _cap(max_nwin)


def _check_nwin(nwin: int, max_nwin: int | None) -> None:
    cap = _cap(max_nwin)
    if nwin < 1:
        raise ValueError(f"the gather needs at least one window (nwin={nwin}: nsamp < wlen?)")
    if nwin > cap:
        raise ValueError(f"nwin={nwin} is past fused_max_nwin={cap}; use the "
                         f"serialized path (traj_gather='serialized')")


def traj_scalars(dt_idx: torch.Tensor, ch_indices: torch.Tensor, nch: int,
                 nt: int, nsamp: int, backward: bool) -> torch.Tensor:
    """Per-(slot, channel) int32 scalars ``(..., nk, 3)``: [base, avail, row].

    ``base`` is the slice start clamped to ``[0, nt]``, ``avail`` how many of
    its samples exist, ``row`` the channel row (clamped, as a JAX gather
    clamps an index)."""
    from das_diff_veh_tpu_torch.ops.xcorr import window_slice_avail

    s0, avail = window_slice_avail(dt_idx.long(), nt, nsamp, backward)
    row = ch_indices.long().clamp(0, nch - 1).expand_as(s0)
    return torch.stack([s0.clamp(0, nt), avail, row], dim=-1).to(torch.int32)


def pack_windows_plain(data: torch.Tensor, scal: torch.Tensor, pivot_idx: int,
                       nwin: int, wlen: int, offset: int):
    """Plain PyTorch version of the kernel: index arithmetic plus a masked
    gather.  ``data`` (B, nch, nt), ``scal`` (B, nk, 3) -> two (B, nk, nwin,
    wlen) window tensors."""
    nb, nch, nt = data.shape
    dev = data.device
    base, avail, row = (scal[..., i].long() for i in range(3))
    starts = torch.arange(nwin, device=dev) * offset               # (nwin,)
    ok = (starts + wlen) <= avail[..., None]                       # (B, nk, nwin)
    pos = (base[..., None, None] + starts[:, None]
           + torch.arange(wlen, device=dev))                       # (B, nk, nwin, wlen)
    pos = pos.clamp(max=nt - 1)      # only invalid windows reach past the record
    b = torch.arange(nb, device=dev)[:, None, None, None]
    wins_ch = data[b, row[..., None, None], pos]
    wins_pv = data[b, min(max(int(pivot_idx), 0), nch - 1), pos]
    keep = ok[..., None]
    return torch.where(keep, wins_ch, 0.0), torch.where(keep, wins_pv, 0.0)


def pack_windows_cuda(data: torch.Tensor, scal: torch.Tensor, pivot_idx: int,
                      nwin: int, wlen: int, offset: int):
    """Launch ``csrc/traj_gather.cu`` on PyTorch's current stream; same
    contract as :func:`pack_windows_plain`."""
    global launches
    from das_diff_veh_tpu_torch import kernels

    if not data.is_cuda or data.dtype != torch.float32 or data.dim() != 3:
        raise ValueError(f"traj_gather kernel takes a (B, nch, nt) float32 CUDA "
                         f"tensor, got {tuple(data.shape)} {data.dtype} on {data.device}")
    if not data.is_contiguous():
        raise ValueError("traj_gather kernel needs a contiguous record")
    nb, nch, nt = data.shape
    if (scal.device != data.device or scal.dtype != torch.int32
            or not scal.is_contiguous() or scal.shape[:1] != (nb,) or scal.shape[-1] != 3):
        raise ValueError(f"traj_gather scalars must be a contiguous (B, nk, 3) int32 "
                         f"tensor on {data.device}, got {tuple(scal.shape)} {scal.dtype}")
    nk = scal.shape[1]
    out_ch = torch.empty((nb, nk, nwin, wlen), dtype=torch.float32, device=data.device)
    out_pv = torch.empty_like(out_ch)
    fn = kernels.load("traj_gather").traj_gather_pack
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), scal.data_ptr(), out_ch.data_ptr(), out_pv.data_ptr(),
                nb * nk, nk, nch, nt, min(max(int(pivot_idx), 0), nch - 1),
                nwin, wlen, offset, stream)
    if rc != 0:
        raise RuntimeError(f"traj_gather kernel launch failed with CUDA error {rc}")
    launches += 1
    return out_ch, out_pv


def traj_follow_windows(data: torch.Tensor, pivot_idx: int,
                        ch_indices: torch.Tensor, dt_idx: torch.Tensor,
                        nsamp: int, wlen: int, offset: int,
                        backward: bool = False, max_nwin: int | None = None):
    """Packed ``(*lead, nk, nwin, wlen)`` channel and pivot window tensors of
    (*lead, nch, nt) ``data`` at starts ``dt_idx`` (*lead, nk), invalid
    windows zeroed, plus ``n_eff`` (*lead, nk) int32 valid windows each.
    One kernel launch covers every leading index and channel."""
    nwin = (nsamp - wlen) // offset + 1
    _check_nwin(nwin, max_nwin)
    lead, (nch, nt) = data.shape[:-2], data.shape[-2:]
    ch_indices = torch.as_tensor(ch_indices, device=data.device)
    nk = ch_indices.shape[0]
    if nk == 0:
        z = data.new_zeros((*lead, 0, nwin, wlen))
        return z, z, torch.zeros((*lead, 0), dtype=torch.int32, device=data.device)
    rec = data.reshape(-1, nch, nt)
    scal = traj_scalars(dt_idx.reshape(-1, nk), ch_indices, nch, nt, nsamp, backward)
    if data.is_cuda:
        wins_ch, wins_pv = pack_windows_cuda(rec.contiguous(), scal.contiguous(),
                                             pivot_idx, nwin, wlen, offset)
    else:
        wins_ch, wins_pv = pack_windows_plain(rec, scal, pivot_idx, nwin, wlen, offset)
    starts = torch.arange(nwin, device=data.device) * offset
    n_eff = ((starts + wlen) <= scal[..., 1:2]).sum(-1).to(torch.int32)
    shape = (*lead, nk, nwin, wlen)
    return wins_ch.reshape(shape), wins_pv.reshape(shape), n_eff.reshape(*lead, nk)


def bytes_moved(scal: torch.Tensor, nch: int, nt: int, pivot_idx: int,
                nwin: int, wlen: int, offset: int) -> int:
    """Least bytes one cut must move for these scalars: each record sample
    that a valid window copies, read once, plus both float32 outputs written
    once (and the scalars read)."""
    scal = scal.reshape(-1, scal.shape[-2], 3).cpu().long()
    nb, nk, _ = scal.shape
    need = torch.zeros((nb, nch, nt), dtype=torch.bool)
    starts = torch.arange(nwin) * offset
    for b in range(nb):
        for k in range(nk):
            base, avail, row = (int(v) for v in scal[b, k])
            n_ok = int(((starts + wlen) <= avail).sum())
            if n_ok:
                span = slice(base, base + (n_ok - 1) * offset + wlen)
                need[b, row, span] = True
                need[b, min(max(pivot_idx, 0), nch - 1), span] = True
    return 4 * (int(need.sum()) + 2 * nb * nk * nwin * wlen) + scal.numel() * 4
