"""Windowed circular cross-correlation: the virtual-shot-gather engine.

Mirrors ``das_diff_veh_tpu/ops/xcorr.py``.  The reference's "doubled source +
valid correlate" per 50%-overlap window is circular cross-correlation,

    c[k] = sum_n src[(n+k) mod W] * rcv[n] = irfft( rfft(src) * conj(rfft(rcv)) ),

so a gather is one batched rfft, one complex product and one irfft.

Every function takes leading batch dimensions: where JAX vmaps over the
window batch, the port carries a batch axis through, so the trajectory
gather kernel (``ops.traj_gather``) cuts all window slots in one launch.
Data-dependent starts are clamped like ``lax.dynamic_slice`` clamps them.
"""

from __future__ import annotations

import torch

from das_diff_veh_tpu_torch.ops import traj_gather as tg


def sliding_windows(trace_or_data: torch.Tensor, wlen: int, offset: int) -> torch.Tensor:
    """Cut (..., nt) data into ``nwin`` windows of ``wlen`` samples every
    ``offset`` samples: returns (..., nwin, wlen) (a strided view)."""
    nt = trace_or_data.shape[-1]
    if (nt - wlen) // offset + 1 <= 0:
        return trace_or_data.new_zeros((*trace_or_data.shape[:-1], 0, wlen))
    return trace_or_data.unfold(-1, wlen, offset)


def cut_windows_at(data: torch.Tensor, starts: torch.Tensor, wlen: int) -> torch.Tensor:
    """Cut (..., nt) data into windows of ``wlen`` at ``starts`` (nwin,),
    each start clamped to ``[0, nt - wlen]``: returns (..., nwin, wlen)."""
    nt = data.shape[-1]
    st = starts.long().clamp(0, nt - wlen)
    return data.unfold(-1, wlen, 1)[..., st, :]


def _circ_corr_freq(src_f: torch.Tensor, rcv_f: torch.Tensor, wlen: int) -> torch.Tensor:
    """irfft(src_f * conj(rcv_f)): circular correlation, zero lag at index 0."""
    return torch.fft.irfft(src_f * torch.conj(rcv_f), n=wlen, dim=-1)


def window_slice_avail(start: torch.Tensor, nt: int, nsamp: int, backward: bool):
    """``(s0, avail)``: the logical slice start and how many of its ``nsamp``
    samples exist.  ``backward=False``: ``[start, start+nsamp)``, truncated at
    the record end like a numpy slice.  ``backward=True``:
    ``[start-nsamp, start)``, empty whenever ``start < nsamp`` (numpy's
    negative-start slice), truncated at the record end for ``start > nt``.
    The serialized cut and the gather kernel's scalars both come from here."""
    if backward:
        s0 = start - nsamp
        avail = torch.where(s0 >= 0, torch.clamp(nt - s0, 0, nsamp), 0)
    else:
        s0 = start
        avail = torch.clamp(nt - start, 0, nsamp)
    return s0, avail


def _masked_window_specs(data: torch.Tensor, start: torch.Tensor, nsamp: int,
                         wlen: int, offset: int, backward: bool):
    """rfft of windows cut at absolute sample positions, with numpy-parity
    validity masks (see :func:`window_slice_avail`).

    ``data`` (*lead, R, nt) with one start per leading index ``start``
    (*lead,) shared by the R rows.  Returns ``(win_f (*lead, R, nwin, nf),
    valid (*lead, nwin), n_eff (*lead,))``."""
    nt = data.shape[-1]
    nwin = (nsamp - wlen) // offset + 1
    start = torch.as_tensor(start, device=data.device).long()
    s0, avail = window_slice_avail(start, nt, nsamp, backward)
    w = torch.arange(nwin, device=data.device)
    valid = (w * offset + wlen) <= avail[..., None]
    # one contiguous nsamp block per start, read from the zero-padded record:
    # every window reaching the pad (or the clamped backward empty slice) is
    # invalid by the avail bound, so valid windows are exact copies
    dpad = torch.nn.functional.pad(data, (0, nsamp))
    idx = s0.clamp(0, nt)[..., None, None] + torch.arange(nsamp, device=data.device)
    block = torch.gather(dpad, -1, idx.expand(*data.shape[:-1], nsamp))
    wins = block.unfold(-1, wlen, offset)[..., :nwin, :]
    return torch.fft.rfft(wins, dim=-1), valid, valid.sum(-1)


def xcorr_pair_at(tr_src: torch.Tensor, tr_rcv: torch.Tensor, start, nsamp: int,
                  wlen: int, overlap_ratio: float = 0.5,
                  backward: bool = False) -> torch.Tensor:
    """Windowed circular xcorr of the slice ``[start, start+nsamp)`` (or
    ``[start-nsamp, start)`` with ``backward=True``) of two traces (*lead, nt)
    with starts (*lead,): zero output when no window fits.  Returns
    (*lead, wlen), zero lag at ``wlen//2``."""
    offset = int(wlen * (1.0 - overlap_ratio))
    both = torch.stack([tr_src, tr_rcv], dim=-2)        # (*lead, 2, nt)
    bf, valid, n_eff = _masked_window_specs(both, start, nsamp, wlen, offset, backward)
    # contiguous operands: the CPU's complex product takes another (vector)
    # loop on strided views and rounds differently; contiguous, this path is
    # bit-identical to the gather kernel's rfft finish
    c = _circ_corr_freq(bf[..., 0, :, :].contiguous(), bf[..., 1, :, :].contiguous(),
                        wlen)                           # (*lead, nwin, wlen)
    out = torch.where(valid[..., None], c, 0.0).sum(-2) / n_eff.clamp(min=1)[..., None]
    return torch.roll(out, wlen // 2, dims=-1)


def xcorr_vshot_at(data: torch.Tensor, ivs: int, start, nsamp: int, wlen: int,
                   overlap_ratio: float = 0.5, reverse: bool = False,
                   backward: bool = False) -> torch.Tensor:
    """One virtual source (row ``ivs``) against every row of (*lead, nch, nt)
    data on the slice at ``start`` (*lead,).  ``reverse=True`` is the
    index-reversed circular correlation of the reference's swapped-operand
    call.  Returns (*lead, nch, wlen)."""
    offset = int(wlen * (1.0 - overlap_ratio))
    wf, valid, n_eff = _masked_window_specs(data, start, nsamp, wlen, offset, backward)
    src_f = wf[..., ivs:ivs + 1, :, :]                  # (*lead, 1, nwin, nf)
    c = _circ_corr_freq(src_f, wf, wlen)                # (*lead, nch, nwin, wlen)
    if reverse:
        c = c.flip(-1)
    out = (torch.where(valid[..., None, :, None], c, 0.0).sum(-2)
           / n_eff.clamp(min=1)[..., None, None])
    return torch.roll(out, wlen // 2, dims=-1)


def _decide_traj_gather(mode: str | None, nwin: int, wlen: int, finish: str, *,
                        max_nwin: int | None = None,
                        dot_max_wlen: int | None = None,
                        dot_max_elems: int | None = None) -> bool:
    """Resolve the gather-path knob to the gather kernels (True) or the
    serialized cut (False).  ``"auto"`` takes the kernel wrapper when the
    shape is inside the finish's caps (``tg.fused_supported``) and the
    serialized cut, which correlates with the rfft, otherwise; the wrapper
    launches the CUDA kernel for a CUDA tensor and runs its plain version
    for a CPU tensor."""
    if finish not in ("rfft", "dot"):
        raise ValueError(f"traj_gather_finish must be 'rfft' or 'dot', got {finish!r}")
    if mode in (None, "auto"):
        return tg.fused_supported(nwin, wlen, finish, max_nwin=max_nwin,
                                  dot_max_wlen=dot_max_wlen, dot_max_elems=dot_max_elems)
    if mode == "serialized":
        return False
    if mode == "fused":
        return True
    raise ValueError(f"traj_gather must be 'auto', 'fused' or 'serialized', got {mode!r}")


def xcorr_traj_follow(data: torch.Tensor, t_axis: torch.Tensor, pivot_idx: int,
                      ch_indices: torch.Tensor, t_at_ch: torch.Tensor,
                      nsamp: int, wlen: int, overlap_ratio: float = 0.5,
                      reverse: bool = False, *, mode: str | None = "auto",
                      finish: str = "rfft",
                      max_nwin: int | None = None,
                      dot_max_wlen: int | None = None,
                      dot_max_elems: int | None = None,
                      precision: str = "f32") -> torch.Tensor:
    """Trajectory-following pair correlations.

    ``data`` (*lead, nch, nt), ``t_axis`` (*lead, nt), ``ch_indices`` (nk,)
    shared, ``t_at_ch`` (*lead, nk).  For each channel ``ch_indices[k]`` a
    window of ``nsamp`` samples starts (forward) or ends (``reverse``) at
    ``argmax(t_axis >= t_at_ch[k])``; the pivot trace is cut with the same
    window and the pair runs through the masked windowed circular xcorr.
    Returns (*lead, nk, wlen).

    ``mode``: ``"serialized"`` cuts every pair with its own gather,
    ``"fused"``/``"auto"`` cut every channel and slot in one call of the
    trajectory gather (``ops.traj_gather``).  ``finish``: ``"rfft"``
    correlates the cut windows with batched rffts; ``"dot"`` correlates
    them in the gather itself (``tg.traj_follow_correlate_dot``), for
    ``wlen <= dot_max_wlen`` and ``nwin*wlen^2 <= dot_max_elems`` only.
    ``precision`` is the dot finish's tier (``"bf16"``: bfloat16 operands,
    float32 sums); the rfft and serialized routes ignore it."""
    ch_indices = torch.as_tensor(ch_indices, device=data.device).long()
    # argmax of a boolean is the first True (0 when none): cast before argmax
    ge = (t_axis[..., None, :] >= t_at_ch[..., :, None]).to(torch.int8)
    dt_idx = torch.argmax(ge, dim=-1)                   # (*lead, nk)
    offset = int(wlen * (1.0 - overlap_ratio))
    nwin = (nsamp - wlen) // offset + 1
    caps = dict(max_nwin=max_nwin, dot_max_wlen=dot_max_wlen, dot_max_elems=dot_max_elems)
    if _decide_traj_gather(mode, nwin, wlen, finish, **caps):
        if finish == "dot":
            return tg.traj_follow_correlate_dot(
                data, pivot_idx, ch_indices, dt_idx, nsamp, wlen, offset,
                backward=reverse, swap=reverse, precision=precision, **caps)
        wins_ch, wins_pv, n_eff = tg.traj_follow_windows(
            data, pivot_idx, ch_indices, dt_idx, nsamp, wlen, offset,
            backward=reverse, max_nwin=max_nwin)
        cf = torch.fft.rfft(wins_ch, dim=-1)            # (*lead, nk, nwin, nf)
        pf = torch.fft.rfft(wins_pv, dim=-1)
        src_f, rcv_f = (pf, cf) if reverse else (cf, pf)
        c = _circ_corr_freq(src_f, rcv_f, wlen)
        # invalid windows are zero in both operands, so their cross-spectra
        # are exactly zero: the plain window sum equals the masked sum
        out = c.sum(-2) / n_eff.clamp(min=1)[..., None]
        return torch.roll(out, wlen // 2, dims=-1)

    tr_ch = data[..., ch_indices, :]                    # (*lead, nk, nt)
    tr_pv = data[..., pivot_idx:pivot_idx + 1, :].expand_as(tr_ch)
    if reverse:
        # vs, vr = pivot, channel on the time-reversed side
        return xcorr_pair_at(tr_pv, tr_ch, dt_idx, nsamp, wlen, overlap_ratio,
                             backward=True)
    return xcorr_pair_at(tr_ch, tr_pv, dt_idx, nsamp, wlen, overlap_ratio,
                         backward=False)
