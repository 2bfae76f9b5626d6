"""Trajectory-following window cut and its two finishes: the counterpart of
``das_diff_veh_tpu/ops/pallas_gather.py`` (``traj_follow_windows``, whose
Pallas body is ``_pack_kernel``, and ``traj_follow_correlate_dot``, whose
body is ``_dot_kernel``).

For every window slot b and output channel ``ch_indices[k]``, cut ``nwin``
overlapping windows of ``wlen`` samples at ``base + w*offset`` from that
channel and from the pivot channel of the same slot, zeroing every window
that does not fit the numpy-parity slice (``ops.xcorr.window_slice_avail``).
Valid windows are exact copies of the record.

- :func:`traj_follow_windows` returns the packed windows (the ``"rfft"``
  finish correlates them outside).  For a CUDA tensor it launches
  ``csrc/traj_gather.cu`` (all slots and channels in one launch) or raises;
  for a CPU tensor it runs :func:`pack_windows_plain`.  ``launches`` counts
  its kernel launches and nothing else.
- :func:`traj_follow_correlate_dot` (the ``"dot"`` finish) also correlates
  each window pair circularly, takes the mean over the valid windows and
  rolls zero lag to ``wlen//2``.  For a CUDA tensor it launches
  ``csrc/traj_dot.cu`` or raises; for a CPU tensor it runs
  :func:`correlate_dot_plain`.  ``dot_launches`` counts its launches.
  :func:`correlate_dot_gemm_plain` is the same function in the layout of
  the kernel's tensor-core tier (for the tests and ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes

import torch

from das_diff_veh_tpu_torch.ops.precision import bf16_round, check_precision

launches = 0        # csrc/traj_gather.cu
dot_launches = 0    # csrc/traj_dot.cu

# defaults of GatherConfig.fused_max_nwin / dot_max_wlen / dot_max_matrix_elems
FUSED_MAX_NWIN = 64
DOT_MAX_WLEN = 256
DOT_MAX_MATRIX_ELEMS = 1 << 20
# the longest window csrc/traj_dot.cu takes (its shared memory at one window a group)
DOT_KERNEL_MAX_WLEN = 3072


def _resolve_caps(max_nwin: int | None, dot_max_wlen: int | None,
                  dot_max_elems: int | None) -> tuple[int, int, int]:
    return (FUSED_MAX_NWIN if max_nwin is None else int(max_nwin),
            DOT_MAX_WLEN if dot_max_wlen is None else int(dot_max_wlen),
            DOT_MAX_MATRIX_ELEMS if dot_max_elems is None else int(dot_max_elems))


def fused_supported(nwin: int, wlen: int, finish: str,
                    max_nwin: int | None = None,
                    dot_max_wlen: int | None = None,
                    dot_max_elems: int | None = None) -> bool:
    """Shape gate of ``traj_gather="auto"``: the window count for both
    finishes, and jointly ``wlen`` and ``nwin*wlen^2`` for ``"dot"``."""
    cap_nwin, cap_wlen, cap_elems = _resolve_caps(max_nwin, dot_max_wlen, dot_max_elems)
    if nwin < 1 or nwin > cap_nwin:
        return False
    return not (finish == "dot" and (wlen > cap_wlen or nwin * wlen * wlen > cap_elems))


def _check_fused(nwin: int, wlen: int, finish: str | None,
                 max_nwin: int | None = None,
                 dot_max_wlen: int | None = None,
                 dot_max_elems: int | None = None) -> None:
    cap_nwin, cap_wlen, cap_elems = _resolve_caps(max_nwin, dot_max_wlen, dot_max_elems)
    if nwin < 1:
        raise ValueError(f"fused gather needs at least one window (nwin={nwin}: "
                         f"nsamp < wlen?)")
    if nwin > cap_nwin:
        raise ValueError(f"nwin={nwin} is past fused_max_nwin={cap_nwin}; use the "
                         f"serialized path (traj_gather='serialized')")
    if finish == "dot" and (wlen > cap_wlen or nwin * wlen * wlen > cap_elems):
        raise ValueError(f"the dot finish takes wlen <= dot_max_wlen={cap_wlen} and "
                         f"nwin*wlen^2 <= dot_max_matrix_elems={cap_elems}, got nwin={nwin}, "
                         f"wlen={wlen}; use the rfft finish (traj_gather_finish='rfft')")


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
    _check_fused(nwin, wlen, None, max_nwin=max_nwin)
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


def correlate_dot_plain(data: torch.Tensor, scal: torch.Tensor, pivot_idx: int,
                        nwin: int, wlen: int, offset: int, swap: bool = False,
                        precision: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of ``csrc/traj_dot.cu``: ``data`` (B, nch, nt),
    ``scal`` (B, nk, 3) -> (B, nk, wlen) rolled window-mean correlations.

    The same operations in the same order as the kernel: the lag sum over
    ascending ``n`` from zero, one rounding per product and per sum, then
    the window sum over ascending ``w`` and one division.  It never builds
    the (nwin, wlen, wlen) doubled-window matrix.  ``"bf16"`` rounds both
    operands through bfloat16, sums in float32 and casts the window
    correlations to the data's dtype before the window sum, as the Pallas
    kernel does."""
    wins_ch, wins_pv = pack_windows_plain(data, scal, pivot_idx, nwin, wlen, offset)
    src, rcv = (wins_pv, wins_ch) if swap else (wins_ch, wins_pv)
    if precision == "bf16":
        src, rcv = bf16_round(src), bf16_round(rcv)
    s2 = torch.cat([src, src], dim=-1)                          # (B, nk, nwin, 2*wlen)
    acc = torch.zeros_like(rcv)
    for n in range(wlen):
        acc = acc + s2[..., n:n + wlen] * rcv[..., n:n + 1]     # c[w, lag] += s2[n+lag] r[n]
    return _window_mean_rolled(acc.to(data.dtype), scal, nwin, wlen, offset)


def _window_mean_rolled(c: torch.Tensor, scal: torch.Tensor, nwin: int, wlen: int,
                        offset: int) -> torch.Tensor:
    """The dot finish's tail on window correlations ``c`` (B, nk, nwin,
    wlen): the sum over ascending ``w`` from zero, one division by
    ``max(n_eff, 1)``, the roll of zero lag to ``wlen//2``."""
    tot = torch.zeros_like(c[..., 0, :])
    for w in range(nwin):
        tot = tot + c[..., w, :]
    starts = torch.arange(nwin, device=c.device) * offset
    n_eff = ((starts + wlen) <= scal[..., 1:2]).sum(-1).to(c.dtype)
    return torch.roll(tot / n_eff.clamp(min=1)[..., None], wlen // 2, dims=-1)


def correlate_dot_gemm_plain(data: torch.Tensor, scal: torch.Tensor, pivot_idx: int,
                             nwin: int, wlen: int, offset: int, swap: bool = False,
                             precision: str = "f32") -> torch.Tensor:
    """The layout of ``csrc/traj_dot.cu``'s bf16 (tensor-core) tier in plain
    PyTorch, same contract as :func:`correlate_dot_plain`.

    With ``lag = 8u + q`` (``q < 8``), ``c[8u + q] = sum_k s2[k + 8u]
    r[k - q]`` is one matrix product per window, ``C = A @ B``:
    ``A[u, k] = s2[k + 8u]`` is the doubled source window, zero past
    ``2*wlen``, read with ``as_strided((M, K), (8, 1))``; ``B[k, q] =
    r[k - q]`` holds 8 shifted copies of the receiver window, zero outside
    ``[0, wlen)``; ``C[u, q]`` read row-major is ``c`` in lag order.  ``M``
    is 32 rows per 256-lag tile and ``K = roundup(wlen + 7, 16)``, the
    kernel's padding.  The products run in the data's dtype (``"bf16"``:
    bfloat16-rounded operands in float32, cast back before the window sum,
    as :func:`correlate_dot_plain` casts); the window sum, the division and
    the roll are the plain version's.  Only the tests and ``chip_smoke.py``
    call it."""
    check_precision(precision)
    wins_ch, wins_pv = pack_windows_plain(data, scal, pivot_idx, nwin, wlen, offset)
    src, rcv = (wins_pv, wins_ch) if swap else (wins_ch, wins_pv)
    if precision == "bf16":
        src, rcv = bf16_round(src), bf16_round(rcv)
    lead = src.shape[:-1]                                       # (B, nk, nwin)
    m = 32 * (-(-wlen // 256))
    k = -(-(wlen + 7) // 16) * 16
    s2 = src.new_zeros((*lead, 8 * (m - 1) + k))
    s2[..., :wlen] = src
    s2[..., wlen:2 * wlen] = src
    s2 = s2.contiguous()
    a = s2.as_strided((*lead, m, k), (*s2.stride()[:-1], 8, 1))
    r_pad = rcv.new_zeros((*lead, k + 8))
    r_pad[..., 8:8 + wlen] = rcv                                # r[i] at r_pad[i + 8]
    shift = (torch.arange(k, device=data.device)[:, None]
             - torch.arange(8, device=data.device)[None, :] + 8)
    b = r_pad[..., shift]                                       # (B, nk, nwin, K, 8)
    c = torch.matmul(a, b).reshape(*lead, 8 * m)[..., :wlen]
    return _window_mean_rolled(c.to(data.dtype), scal, nwin, wlen, offset)


def correlate_dot_cuda(data: torch.Tensor, scal: torch.Tensor, pivot_idx: int,
                       nwin: int, wlen: int, offset: int, swap: bool = False,
                       precision: str = "f32") -> torch.Tensor:
    """Launch ``csrc/traj_dot.cu`` on PyTorch's current stream; same contract
    as :func:`correlate_dot_plain` (float32 only).  The f32 tier equals the
    plain version bit for bit; the bf16 tier runs on the tensor cores, which
    sum the exact bfloat16 products in their own order (within 1e-5
    peak-relative of the plain version)."""
    global dot_launches
    from das_diff_veh_tpu_torch import kernels

    check_precision(precision)
    if not data.is_cuda or data.dtype != torch.float32 or data.dim() != 3:
        raise ValueError(f"traj_dot kernel takes a (B, nch, nt) float32 CUDA tensor, "
                         f"got {tuple(data.shape)} {data.dtype} on {data.device}")
    if not data.is_contiguous():
        raise ValueError("traj_dot kernel needs a contiguous record")
    nb, nch, nt = data.shape
    if (scal.device != data.device or scal.dtype != torch.int32 or scal.dim() != 3
            or not scal.is_contiguous() or scal.shape[0] != nb or scal.shape[-1] != 3):
        raise ValueError(f"traj_dot scalars must be a contiguous (B, nk, 3) int32 tensor "
                         f"on {data.device}, got {tuple(scal.shape)} {scal.dtype}")
    if not (1 <= wlen <= DOT_KERNEL_MAX_WLEN and offset >= 1):
        raise ValueError(f"traj_dot kernel takes 1 <= wlen <= {DOT_KERNEL_MAX_WLEN} and "
                         f"offset >= 1, got wlen={wlen}, offset={offset}")
    nk = scal.shape[1]
    out = torch.empty((nb, nk, wlen), dtype=torch.float32, device=data.device)
    fn = kernels.load("traj_dot").traj_dot_correlate
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), scal.data_ptr(), out.data_ptr(), nb * nk, nk, nch, nt,
                min(max(int(pivot_idx), 0), nch - 1), nwin, wlen, offset, int(bool(swap)),
                int(precision == "bf16"), stream)
    if rc != 0:
        raise RuntimeError(f"traj_dot kernel launch failed with CUDA error {rc}")
    dot_launches += 1
    return out


def traj_follow_correlate_dot(data: torch.Tensor, pivot_idx: int,
                              ch_indices: torch.Tensor, dt_idx: torch.Tensor,
                              nsamp: int, wlen: int, offset: int,
                              backward: bool = False, swap: bool = False,
                              max_nwin: int | None = None,
                              dot_max_wlen: int | None = None,
                              dot_max_elems: int | None = None,
                              precision: str = "f32") -> torch.Tensor:
    """The ``"dot"`` finish: the cut of :func:`traj_follow_windows` with each
    window pair correlated circularly, ``c[w, lag] = sum_n s2[w, n+lag]
    r[w, n]`` (``s2 = [s, s]``), averaged over the valid windows and rolled
    so that zero lag sits at ``wlen//2``.  ``swap=True`` correlates (source
    = pivot, receiver = channel).  Returns ``(*lead, nk, wlen)``; one kernel
    launch covers every leading index and channel."""
    nwin = (nsamp - wlen) // offset + 1
    _check_fused(nwin, wlen, "dot", max_nwin=max_nwin, dot_max_wlen=dot_max_wlen,
                 dot_max_elems=dot_max_elems)
    check_precision(precision)
    lead, (nch, nt) = data.shape[:-2], data.shape[-2:]
    ch_indices = torch.as_tensor(ch_indices, device=data.device)
    nk = ch_indices.shape[0]
    if nk == 0:
        return data.new_zeros((*lead, 0, wlen))
    rec = data.reshape(-1, nch, nt)
    scal = traj_scalars(dt_idx.reshape(-1, nk), ch_indices, nch, nt, nsamp, backward)
    if data.is_cuda:
        out = correlate_dot_cuda(rec.contiguous(), scal.contiguous(), pivot_idx, nwin,
                                 wlen, offset, swap, precision)
    else:
        out = correlate_dot_plain(rec, scal, pivot_idx, nwin, wlen, offset, swap, precision)
    return out.reshape(*lead, nk, wlen)


def dot_flops(scal: torch.Tensor, nwin: int, wlen: int, offset: int) -> int:
    """Operations the dot finish needs for these scalars: one multiply and
    one add per lag and sample of each valid window."""
    starts = torch.arange(nwin, device=scal.device) * offset
    n_valid = int(((starts + wlen) <= scal[..., 1:2]).sum())
    return 2 * n_valid * wlen * wlen


def bytes_moved(scal: torch.Tensor, nch: int, nt: int, pivot_idx: int,
                nwin: int, wlen: int, offset: int, out_elems: int | None = None) -> int:
    """Least bytes one call must move for these scalars: each record sample
    that a valid window reads, read once, plus the float32 outputs written
    once (``out_elems`` of them; default both packed window tensors of the
    cut) and the scalars read."""
    scal = scal.reshape(-1, scal.shape[-2], 3).cpu().long()
    nb, nk, _ = scal.shape
    if out_elems is None:
        out_elems = 2 * nb * nk * nwin * wlen
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
    return 4 * (int(need.sum()) + out_elems) + scal.numel() * 4
