"""The all-pairs peak correlation as a ring over a device mesh.

The counterpart of ``das_diff_veh_tpu/parallel/allpairs.py`` (a
``shard_map`` ring that rotates receiver shards with ``lax.ppermute``).  The
record's rows are zero-padded to a multiple of the slot count D and cut
into D shards of ``shard_rows``; slot j keeps the window spectra of its own
rows as its sources (``ops.all_pairs._window_spectra`` on its device), and
no slot ever holds the full receiver set:

- step k: each slot correlates its sources against the receiver shard it
  holds (``ops.all_pairs.peak_from_spectra``: kernel B3 per source chunk,
  the fused irfft + B4 finish) and writes the block into its output columns
  ``((j + k) % D) * shard_rows``, since that shard started on slot
  ``(j + k) % D``;
- between steps the shards rotate one slot (``distributed.ring_perm``):
  slot j sends its shard to slot ``(j - 1) % D``.  Between cards of one
  process that is ``Tensor.to(device, non_blocking=True)`` on a copy stream
  of each card, and a slot's compute stream waits on the copy's event
  before it uses the shard; slots on one device (several slots of one
  card, or the CPU slots) hand shards on by reference; between ranks it is
  one ``distributed.exchange`` a rotation (NCCL on the cards, or gloo
  through pinned host buffers).  ``double_buffer`` issues step k+1's hops
  before step k's correlations; without it they are issued after them.

``"replicated"`` gives every slot the whole receiver set and runs no
rotation (across ranks, an all-gather of the slots' spectra).  On the
kernel path every mode and buffering choice equals the unsharded
``xcorr_all_pairs_peak`` bit for bit, because B3 sums one pair's windows in
a fixed order whatever the launch's shape.

Across processes (a mesh of ``make_mesh`` under a group) every rank passes
the same arguments and the same ``data``, windows only its own slots' rows,
and issues the same communication calls in the same order; the output row
blocks are gathered to rank 0 in slot order, which returns the matrix on
its first slot, and the other ranks return ``None``.  A failure on one rank
(the ``parallel.ring`` fault site fires before any communication) is
agreed on before the rotation and again before the gather, so every rank
raises together (``distributed.PeerFailure`` on the others) and none is
left waiting in a receive.  A kernel that fails raises through here: only
``resilience.degrade.resilient_all_pairs_peak`` falls back.
"""

from __future__ import annotations

import torch

from das_diff_veh_tpu_torch.config import RingConfig
from das_diff_veh_tpu_torch.obs.profiling import register_memory_gauges
from das_diff_veh_tpu_torch.obs.registry import MetricsRegistry, default_registry
from das_diff_veh_tpu_torch.ops.all_pairs import (_decide_kernel, _resolve_lagmax_block,
                                                  _resolve_win_block, _window_spectra,
                                                  peak_from_spectra)
from das_diff_veh_tpu_torch.ops.precision import check_precision
from das_diff_veh_tpu_torch.parallel import distributed as D
from das_diff_veh_tpu_torch.parallel.mesh import Mesh
from das_diff_veh_tpu_torch.resilience import faults


def _observe_ring_build(mesh: Mesh, ring: RingConfig,
                        registry: MetricsRegistry | None) -> None:
    """Count this call by mode (``das_ring_builds_total{mode}``), set the
    mesh size (``das_ring_devices``) and wire lazy memory gauges for this
    process's cards of the mesh."""
    reg = registry if registry is not None else default_registry()
    reg.counter("das_ring_builds_total", "all-pairs ring calls, by decomposition",
                labels=("mode",)).labels(mode=ring.mode).inc()
    reg.gauge("das_ring_devices", "mesh size of the last ring call").set(mesh.size)
    register_memory_gauges(reg, sorted({mesh.devices[j].index for j in mesh.local_slots
                                        if mesh.devices[j].type == "cuda"}))


class _Rotation:
    """The ring's shard hops of this process's slots: between its cards on a
    copy stream of each card, by reference on one device, and across ranks
    as one ``distributed.exchange`` a rotation (the rank's first slot sends
    to the previous rank, its last slot receives from the next)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.local = set(mesh.local_slots)
        self._copy = {mesh.devices[j]: torch.cuda.Stream(mesh.devices[j])
                      for j in self.local if mesh.devices[j].type == "cuda"}

    def issue(self, held: dict) -> dict:
        """Start one rotation of ``held`` (local slot -> shard): returns each
        local slot's entry, slot i receiving slot ``(i + 1) % D``'s shard."""
        nxt, send, recv = {}, None, None
        for src, dst in D.ring_perm(self.mesh.size):
            if src in held and dst not in self.local:
                send = (held[src], self.mesh.ranks[dst])
                continue
            if src not in held:
                if dst in self.local:
                    recv = (dst, self.mesh.ranks[src])
                continue
            shard, dev = held[src], self.mesh.devices[dst]
            if shard.device == dev:
                nxt[dst] = (shard, None)
                continue
            s_copy, d_copy = self._copy[shard.device], self._copy[dev]
            s_copy.wait_stream(torch.cuda.current_stream(shard.device))   # shard is written
            with torch.cuda.stream(s_copy), torch.cuda.stream(d_copy):
                moved = shard.to(dev, non_blocking=True)
                done = torch.cuda.Event()
                done.record(d_copy)
            shard.record_stream(s_copy)        # read by the copy until it ends
            nxt[dst] = (moved, done)
        if recv is not None:            # across ranks: one hop out, one in
            nxt[recv[0]] = D.exchange(send[0], send[1], send[0], recv[1],
                                      self.mesh.devices[recv[0]])
        return nxt

    @staticmethod
    def take(entry) -> torch.Tensor:
        """The shard of a slot, once its hop has landed (the slot's compute
        stream waits on the copy's event, or on the exchange)."""
        if isinstance(entry, D.Transfer):
            return entry.wait()
        shard, done = entry
        if done is not None:
            stream = torch.cuda.current_stream(shard.device)
            stream.wait_event(done)
            shard.record_stream(stream)
        return shard


def sharded_all_pairs_peak(data, wlen: int, mesh: Mesh, *, axis: str = "win",
                           overlap_ratio: float = 0.5, src_chunk: int = 64,
                           use_kernel: bool | None = None, win_block: int | None = None,
                           ring: RingConfig | None = None,
                           registry: MetricsRegistry | None = None) -> torch.Tensor | None:
    """Peak |xcorr| of every channel pair, (nch, nch) float32 on the first
    slot's device, computed as a ring over ``mesh`` (module docstring); on a
    mesh across processes rank 0 returns it and the other ranks ``None``.

    ``data``: the (nch, nt) record.  ``ring`` picks the decomposition and
    its knobs (:class:`RingConfig`); a per-call ``win_block`` wins over
    ``ring.win_block``.  ``use_kernel``: None = B3/B4 when a shard has at
    least ``PALLAS_MIN_CH`` rows on the card, True = the kernels (their
    plain versions on the CPU), False = the einsum.  Invalid knobs raise
    ``ValueError`` before any device work."""
    ring = RingConfig() if ring is None else ring
    if ring.mode not in ("ring", "replicated"):
        raise ValueError(f"RingConfig.mode must be 'ring' or 'replicated', got {ring.mode!r}")
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    local = mesh.local_slots
    home = mesh.devices[local[0]]
    data = torch.as_tensor(data)
    nch, n_dev = data.shape[0], mesh.size
    pad = (-nch) % n_dev
    shard_rows = (nch + pad) // n_dev
    wb = win_block if win_block is not None else ring.win_block

    def prologue():
        # chaos site: a failed ring, which resilient_all_pairs_peak turns
        # into a fallback to the replicated layout
        if ring.mode == "ring":
            faults.fire("parallel.ring")
        _observe_ring_build(mesh, ring, registry)
        _resolve_win_block(1, wb)
        _resolve_lagmax_block(1, False, ring.lagmax_block)
        check_precision(ring.precision)
        dpad = torch.nn.functional.pad(data, (0, 0, 0, pad))
        # each slot's spectra from its own rows on its own device: the full
        # set never lands on one slot
        return {j: _window_spectra(dpad[j * shard_rows:(j + 1) * shard_rows]
                                   .to(mesh.devices[j]), wlen, overlap_ratio)
                for j in local}

    wf = (D.agreed(prologue, "sharded_all_pairs_peak", home) if mesh.multiprocess
          else prologue())
    use_k = _decide_kernel(shard_rows, use_kernel, mesh.devices[0])
    kw = dict(win_block=wb, lagmax_block=ring.lagmax_block, precision=ring.precision)
    failed = None

    def correlate(j: int, rcv: torch.Tensor) -> torch.Tensor | None:
        nonlocal failed
        if failed is not None:
            return None
        try:
            return peak_from_spectra(wf[j], rcv, wlen, src_chunk, use_k,
                                     device=mesh.devices[j], **kw)
        except Exception as e:  # noqa: BLE001 - raised on every rank before the gather
            if not mesh.multiprocess:
                raise
            failed = e
            return None

    if ring.mode == "replicated":
        if mesh.multiprocess:
            full = torch.cat(D.all_gather(torch.cat([wf[j] for j in local]), home))
        else:
            full = None
        outs = {j: correlate(j, full.to(mesh.devices[j]) if full is not None else
                             torch.cat([w.to(mesh.devices[j]) for w in wf.values()]))
                for j in local}
    else:
        rot = _Rotation(mesh)
        outs = {j: torch.empty((shard_rows, n_dev * shard_rows), dtype=torch.float32,
                               device=mesh.devices[j]) for j in local}
        held = {j: (w, None) for j, w in wf.items()}
        for k in range(n_dev):
            last = k == n_dev - 1
            shards = {j: rot.take(e) for j, e in held.items()}
            if ring.double_buffer and not last:
                held = rot.issue(shards)
            for j in local:
                col = ((j + k) % n_dev) * shard_rows
                block = correlate(j, shards[j])
                if block is not None:
                    outs[j][:, col:col + shard_rows] = block
            if not ring.double_buffer and not last:
                held = rot.issue(shards)
    if not mesh.multiprocess:
        return torch.cat([outs[j].to(home) for j in local])[:nch, :nch]
    D.agree(failed, "sharded_all_pairs_peak", home)
    blocks = D.gather_to_root([outs[j] for j in local], home)
    return None if blocks is None else torch.cat(blocks)[:nch, :nch]

