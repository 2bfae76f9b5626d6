"""Device meshes: the counterpart of ``das_diff_veh_tpu/parallel/mesh.py``.

A :class:`Mesh` is the tuple of its slots' devices, the name of its one
axis (``"win"``) and, across processes, each slot's owning rank.

Without a ``torch.distributed`` group (or with a group of one rank) one
process drives every slot, as the JAX package's single controller drives
every device of a ``jax.sharding.Mesh``:

- ``make_mesh(n)``: the first ``n`` cards (raises without one, or with
  fewer than ``n``);
- ``make_mesh(n, device="cuda")``: ``n`` slots dealt round the cards, so
  several slots may share one card (one H100 runs a ring of 4);
- ``make_mesh(n, device="cpu")``: ``n`` CPU slots, the counterpart of the 8
  virtual CPU devices that the JAX tests run on.

With a group of W ranks (``distributed.initialize_cluster``) ``make_mesh``
is collective: every rank calls it with the same arguments and gets the
same global mesh of ``n`` slots, dealt to the ranks in contiguous blocks of
``n / W`` in rank order, as ``jax.devices()`` orders the chips by process.
A rank drives only its own block (:attr:`Mesh.local_slots`), on its own
devices: ``device=None`` takes the rank's cards from ``LOCAL_RANK * n / W``
on (``distributed.local_rank``), ``"cuda"`` deals its slots round the cards
from there (ranks that share one card), ``"cpu"`` gives CPU slots.  Under
NCCL a rank drives one slot, on the card ``initialize_cluster`` made
current (``LOCAL_RANK``); anything else raises.  A slot's device is named
as its owning rank names it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from das_diff_veh_tpu_torch.core.section import WindowBatch
from das_diff_veh_tpu_torch.device import resolve_device
from das_diff_veh_tpu_torch.parallel import distributed as D


@dataclass(frozen=True)
class Mesh:
    """The slots of a one-axis mesh, in ring order; ``ranks`` holds each
    slot's owning rank (empty: this process owns every slot)."""

    devices: tuple          # torch.device per slot, as its owner names it
    axis: str = "win"
    ranks: tuple = ()

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def multiprocess(self) -> bool:
        """True when the slots span more than one rank."""
        return len(set(self.ranks)) > 1

    @property
    def local_slots(self) -> tuple:
        """The slots this process drives, in slot order."""
        if not self.multiprocess:
            return tuple(range(self.size))
        me = D.rank()
        return tuple(j for j, r in enumerate(self.ranks) if r == me)


def _slot_devices(n: int, device, first: int) -> tuple:
    """``n`` slot devices of this process, its cards counted from ``first``."""
    if device is None:
        resolve_device("cuda")
        count = torch.cuda.device_count()
        if first + n > count:
            raise ValueError(f"requested {n} devices from card {first}, have {count}")
        return tuple(torch.device("cuda", first + i) for i in range(n))
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        return tuple(torch.device("cuda", (first + i) % count) for i in range(n))
    return (dev,) * n


def _rank_devices(per: int, device) -> tuple:
    """This rank's ``per`` slot devices under a group: its cards counted from
    ``LOCAL_RANK * per``; under NCCL one slot, on the card that
    ``initialize_cluster`` made current, so both name the same card."""
    if D.backend() != "nccl":
        return _slot_devices(per, device, D.local_rank() * per)
    if per != 1:
        raise ValueError(f"an NCCL rank drives one card, not {per} slots: make as many slots "
                         f"as ranks, or use gloo")
    devs = _slot_devices(1, device, D.local_rank())
    current = torch.device("cuda", torch.cuda.current_device())
    if devs[0] != current:
        raise ValueError(f"an NCCL rank's slot is its own card {current}, not {devs[0]}")
    return devs


def make_mesh(n_devices: int | None = None, axis: str = "win", device=None) -> Mesh:
    """A mesh of ``n_devices`` slots (module docstring); ``None`` slots =
    every card, or one CPU slot (one slot a rank under a group)."""
    world = D.world_size()
    if world == 1:
        if device is None:
            resolve_device("cuda")
            n = n_devices or torch.cuda.device_count()
        else:
            n = n_devices or 1
        if n < 1:
            raise ValueError(f"a mesh needs at least one slot, got {n}")
        return Mesh(_slot_devices(n, device, 0), axis)
    import torch.distributed as dist

    n = n_devices or world
    args = (n, axis, str(device))
    seen = [None] * world
    dist.all_gather_object(seen, args)
    if any(a != args for a in seen):
        raise ValueError(f"make_mesh is collective: every rank passes the same arguments, "
                         f"got {seen}")
    if n < 1 or n % world:
        raise ValueError(f"{n} slots cannot be dealt evenly to {world} ranks")
    per = n // world
    try:
        mine = [str(d) for d in _rank_devices(per, device)]
    except (ValueError, RuntimeError) as e:        # every rank raises below
        mine = f"rank {D.rank()}: {e}"
    names = [None] * world
    dist.all_gather_object(names, mine)
    failed = [m for m in names if isinstance(m, str)]
    if failed:
        raise ValueError(f"make_mesh({n}, device={device!r}) failed on {failed}")
    return Mesh(tuple(torch.device(d) for block in names for d in block), axis,
                tuple(r for r in range(world) for _ in range(per)))


def pad_batch(batch: WindowBatch, multiple: int) -> WindowBatch:
    """Pad the window axis to a multiple of ``multiple`` with invalid, all-zero
    slots.  The masked stack ignores them, so results are unchanged."""
    pad = (-batch.max_windows) % multiple
    if pad == 0:
        return batch

    def pad0(a):
        return torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])

    return dataclasses.replace(batch, data=pad0(batch.data), t=pad0(batch.t),
                               traj_x=pad0(batch.traj_x), traj_t=pad0(batch.traj_t),
                               valid=pad0(batch.valid))
