"""Cluster bootstrap, the ring's rotation and the hops between ranks (the
counterpart of ``das_diff_veh_tpu/parallel/distributed.py``).

The JAX package connects one process per host through ``jax.distributed``,
after which ``jax.devices()`` spans every chip and every mesh user runs
unchanged across processes.  Here the counterpart is a
``torch.distributed`` process group (:func:`initialize_cluster`): each rank
drives its own slots of a global :class:`~.mesh.Mesh`, and what crosses
ranks goes through the helpers below, whose transport follows the group's
backend:

- ``"nccl"`` (a card for each rank): device tensors go through NCCL's
  ``send``/``recv`` on NCCL's own stream; ``Work.wait()`` makes the current
  stream wait for it;
- ``"gloo"`` (ranks that share a card, or CPU slots): gloo moves host memory
  only, so a card's tensor is copied into a pinned host buffer once the
  current stream has written it, sent, and copied onto the receiver's card
  on its current stream.

Every rank issues the same communication calls in the same order; the
sharded entries return their result on rank 0 and ``None`` elsewhere.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Optional

from das_diff_veh_tpu_torch.obs.registry import default_registry

log = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")
#: the environment variable a launcher sets to name the backend
BACKEND_ENV = "DAS_DIST_BACKEND"
#: the counter of the bytes this process sends to other ranks
SENT_BYTES = "das_dist_sent_bytes_total"
# what ``agree`` reduces over the ranks: the worst failure wins
_OK, _FAILED, _INVALID = 0, 1, 2


class PeerFailure(RuntimeError):
    """Another rank failed inside a collective entry; every rank raises
    together, so the ranks' next calls stay in step."""


class PeerInvalid(PeerFailure, ValueError):
    """Another rank refused its input (``ValueError`` or ``TypeError``):
    every rank raises a ``ValueError`` together, so no rank treats it as a
    failure to recover from while the others give up."""


def ring_perm(n_dev: int, shift: int = 1) -> list:
    """One ring rotation over ``n_dev`` mesh slots as ``(source, dest)``
    pairs: slot j sends to slot ``(j - shift) % n_dev``, so afterwards slot i
    holds the shard that started on slot ``(i + shift) % n_dev``.  Every
    step moves each shard one hop; slots dealt to ranks in contiguous
    blocks (``make_mesh``) leave one cross-rank hop at each rank boundary."""
    return [(j, (j - shift) % n_dev) for j in range(n_dev)]


def cluster_spec_from_env(env: Optional[dict] = None):
    """``(coordinator_address, num_processes, process_id)`` from the
    environment: ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` first, then ``MASTER_ADDR`` + ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK`` (the torch.distributed convention).
    ``(None, None, None)`` when nothing is set."""
    e = os.environ if env is None else env
    addr = e.get("JAX_COORDINATOR_ADDRESS")
    if addr is None and e.get("MASTER_ADDR"):
        addr = e["MASTER_ADDR"] + ":" + e.get("MASTER_PORT", "8476")
    nproc = e.get("JAX_NUM_PROCESSES", e.get("WORLD_SIZE"))
    pid = e.get("JAX_PROCESS_ID", e.get("RANK"))
    return (addr,
            int(nproc) if nproc is not None else None,
            int(pid) if pid is not None else None)


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None, *,
                       backend: Optional[str] = None,
                       timeout_s: float = 600.0) -> bool:
    """Join this process to a ``torch.distributed`` process group; a no-op
    for a single host.

    Explicit arguments win over the environment (``cluster_spec_from_env``).
    With nothing set this returns False without touching torch.distributed,
    so library code may call it unconditionally; with a spec that is only
    partly set (a stale ``MASTER_ADDR`` without ``WORLD_SIZE``/``RANK``) it
    warns and stays single-process instead of waiting on a coordinator that
    is not there.  ``coordinator_address`` is ``host:port`` (a TCP
    rendezvous) or a URL such as ``file:///path/store``.

    ``backend`` (else ``$DAS_DIST_BACKEND``) must be named: ``"nccl"`` when
    each rank has a card of its own (this rank's card is :func:`local_rank`,
    made the current device; ``make_mesh`` gives the rank one slot there),
    ``"gloo"`` otherwise (ranks sharing a card, several cards a rank, or the
    CPU).  NCCL without a card, or with fewer cards than ``LOCAL_RANK``
    needs, raises ``RuntimeError``; nothing falls back to gloo.  Every
    collective waits at most ``timeout_s``, so a rank that never arrives
    becomes an error rather than a hang.  Returns True when a process group
    was initialized."""
    env_addr, env_n, env_pid = cluster_spec_from_env()
    addr = coordinator_address or env_addr
    n = num_processes if num_processes is not None else env_n
    pid = process_id if process_id is not None else env_pid
    if addr is None and n is None and pid is None:
        return False
    if addr is None or n is None or pid is None:
        log.warning("incomplete cluster spec (address=%s num_processes=%s process_id=%s); "
                    "staying single-process", addr, n, pid)
        return False
    backend = backend or os.environ.get(BACKEND_ENV)
    if backend not in BACKENDS:
        raise ValueError(f"name the process group's backend, one of {BACKENDS} (argument "
                         f"or ${BACKEND_ENV}): 'nccl' when each rank has a card of its own, "
                         f"'gloo' otherwise; got {backend!r}")
    import torch
    import torch.distributed as dist

    if backend == "nccl":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        card = local_rank()
        if card >= count:
            raise RuntimeError(f"NCCL needs a card for each rank: LOCAL_RANK {card} on a "
                               f"machine with {count} card(s); ranks that share a card use "
                               f"gloo")
        torch.cuda.set_device(card)
    url = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=url, world_size=n, rank=pid,
                            timeout=timedelta(seconds=timeout_s))
    return True


def _group():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    d = _group()
    return d.get_rank() if d else 0


def world_size() -> int:
    """The default group's size (1 without one)."""
    d = _group()
    return d.get_world_size() if d else 1


def local_rank() -> int:
    """This rank's index on its host: ``$LOCAL_RANK`` as a launcher (or
    ``torchrun``) sets it, else 0, one process a host as the JAX package
    runs.  Never the global rank: a rank's cards are counted on its host."""
    return int(os.environ.get("LOCAL_RANK", 0))


def backend() -> Optional[str]:
    """The default group's backend, or None without a group."""
    d = _group()
    return d.get_backend() if d else None


def _wire(t):
    """The tensor as it goes on the wire: complex as its real pairs."""
    import torch

    return torch.view_as_real(t) if t.is_complex() else t


def _on_host(t):
    """``t`` on the host for gloo: a card's tensor through a pinned buffer
    (the copy waits for the current stream's writes and is waited for)."""
    import torch

    if not t.is_cuda:
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.device(t.device):
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream().synchronize()
    return host


class Transfer:
    """A started exchange: :meth:`wait` gives the received tensor on its
    device, ready for the current stream."""

    def __init__(self, works, buf, device, keep=None):
        self._works, self._buf, self._device = works, buf, device
        self._keep = keep           # a host buffer being sent: alive until the wait

    def wait(self):
        import torch

        for w in self._works:
            w.wait()
        self._keep = None
        buf = self._buf
        if buf is None or buf.device == self._device:
            return buf
        with torch.cuda.device(self._device):
            return buf.to(self._device, non_blocking=True)


def _count_sent(nbytes: int) -> None:
    default_registry().counter(SENT_BYTES, "bytes of tensors sent to other ranks").inc(nbytes)


def exchange(send, dst: Optional[int], recv_like, src: Optional[int], device) -> Transfer:
    """Start sending ``send`` to rank ``dst`` and receiving a tensor shaped
    and typed like ``recv_like`` from rank ``src`` onto ``device`` (either
    side may be None), as one batch of point-to-point calls."""
    import torch
    import torch.distributed as dist

    nccl = backend() == "nccl"
    ops, buf = [], None
    if send is not None:
        send = send.contiguous() if nccl else _on_host(send)
        ops.append(dist.P2POp(dist.isend, _wire(send), dst))
        _count_sent(send.numel() * send.element_size())
    if src is not None:
        on = torch.device(device) if nccl else torch.device("cpu")
        buf = torch.empty(recv_like.shape, dtype=recv_like.dtype, device=on,
                          pin_memory=(not nccl and torch.device(device).type == "cuda"))
        ops.append(dist.P2POp(dist.irecv, _wire(buf), src))
    works = dist.batch_isend_irecv(ops) if ops else []
    return Transfer(works, buf, torch.device(device), keep=send)


def _max_over_ranks(value: int, device=None) -> int:
    """The largest ``value`` of any rank, on every rank (an all-reduce of one
    integer; ``device``: a card of this rank, needed under NCCL)."""
    import torch
    import torch.distributed as dist

    if world_size() == 1:
        return value
    on = "cpu"
    if backend() == "nccl":
        on = device if device is not None else torch.cuda.current_device()
    t = torch.tensor([value], dtype=torch.int32, device=on)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def any_rank(flag: bool, device=None) -> bool:
    """True on every rank when ``flag`` is True on any rank."""
    return _max_over_ranks(int(bool(flag)), device) > 0


def agree(error: Optional[BaseException], what: str, device=None) -> None:
    """Raise on every rank when ``error`` is set on any, and the same kind on
    every rank: when any rank's error is a ``ValueError`` or ``TypeError``
    (its input was refused), every rank raises a ``ValueError`` (its own, or
    :class:`PeerInvalid`); otherwise this rank's own error, or
    :class:`PeerFailure` on the ranks that did not fail."""
    mine = (_OK if error is None else
            _INVALID if isinstance(error, (ValueError, TypeError)) else _FAILED)
    worst = _max_over_ranks(mine, device)
    if worst == _INVALID and mine != _INVALID:
        raise PeerInvalid(f"{what}: another rank refused its input") from error
    if worst != _OK:
        if error is not None:
            raise error
        raise PeerFailure(f"{what}: another rank failed")


def agreed(fn, what: str, device=None):
    """``fn()`` on every rank of the group; when it raised on any rank, every
    rank raises (its own error, else :class:`PeerFailure`), so no rank goes
    on to wait for one that is not coming."""
    error, out = None, None
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 - raised again by agree, on every rank
        error = e
    agree(error, what, device)
    return out


def gather_to_root(tensors: list, device) -> Optional[list]:
    """Rank 0 receives every other rank's ``tensors`` (as many as its own,
    each shaped and typed like them: ``make_mesh`` deals every rank as many
    slots) in rank order and returns all of them, its own first, on
    ``device``; the other ranks send theirs and return None."""
    if rank() != 0:
        for t in tensors:
            exchange(t, 0, None, None, device).wait()
        return None
    out = [t.to(device) for t in tensors]
    for r in range(1, world_size()):
        out += [exchange(None, None, tensors[0], r, device).wait() for _ in tensors]
    return out


def gather_objects(obj) -> Optional[list]:
    """Rank 0 gets every rank's picklable ``obj`` in rank order (CPU tensors
    inside keep their bits); the other ranks get None."""
    import torch.distributed as dist

    me, w = rank(), world_size()
    out = [None] * w if me == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def all_gather(t, device) -> list:
    """Every rank's ``t`` (same shape and type on every rank), in rank
    order, on ``device``."""
    import torch
    import torch.distributed as dist

    nccl = backend() == "nccl"
    src = t.contiguous() if nccl else _on_host(t)
    parts = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather([_wire(p) for p in parts], _wire(src))
    _count_sent(src.numel() * src.element_size() * (world_size() - 1))
    return [p.to(device) for p in parts]
