"""The window-sharded stack: windows -> gathers -> stacked dispersion image.

The counterpart of ``das_diff_veh_tpu/parallel/stack.py``, where the window
axis of the batch is sharded over a mesh and XLA turns the masked-mean stack
into an all-reduce.  Here the batch is padded to a multiple of the slot
count and cut into one shard of windows per slot (:func:`shard_windows`).
Each slot builds its own gathers with ``models.vsg.build_gather_batch`` on
its device (two launches of the gather kernel B1 on the card) and reduces
them to its masked window sum and valid count; the host side adds the sums
in slot order on the first slot, divides by the total count and makes the
dispersion image once.  With one slot this is ``stack_gathers`` bit for
bit; with more, the sum runs in another order (float rounding only).

Across processes each rank shards and gathers only its own slots, and
sends their sums and counts to rank 0, which adds them in slot order (not
an ``all_reduce``, whose order belongs to the backend): the result equals
the single-process stack over as many slots bit for bit, on rank 0; the
other ranks return ``None``.  Nothing is cached between calls: the
per-geometry constants come from ``core.constants`` as on the chunk path.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from das_diff_veh_tpu_torch.config import DispersionConfig, GatherConfig
from das_diff_veh_tpu_torch.core.section import WindowBatch
from das_diff_veh_tpu_torch.models import vsg as V
from das_diff_veh_tpu_torch.parallel import distributed as D
from das_diff_veh_tpu_torch.parallel.mesh import Mesh, pad_batch


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")


def shard_windows(batch: WindowBatch, mesh: Mesh, axis: str = "win") -> tuple:
    """Pad the batch to the slot count and cut its window axis into one
    :class:`WindowBatch` per slot of this process (every slot without a
    group), each on its slot's device (the shared x axis goes to every
    slot)."""
    _check_axis(mesh, axis)
    batch = pad_batch(batch, mesh.size)
    per = batch.max_windows // mesh.size
    shards = []
    for j in mesh.local_slots:
        dev = mesh.devices[j]
        sl = slice(j * per, (j + 1) * per)
        shards.append(WindowBatch(data=batch.data[sl].to(dev), x=batch.x.to(dev),
                                  t=batch.t[sl].to(dev), traj_x=batch.traj_x[sl].to(dev),
                                  traj_t=batch.traj_t[sl].to(dev),
                                  valid=batch.valid[sl].to(dev)))
    return tuple(shards)


def _masked_sum(gathers: torch.Tensor, valid: torch.Tensor):
    """The numerator and the count of ``vsg.stack_gathers``."""
    mask = valid.reshape(valid.shape + (1,) * (gathers.ndim - 1))
    return (torch.sum(torch.where(mask, gathers, 0.0), dim=0),
            valid.to(gathers.dtype).sum())


def sharded_stack_pipeline(batch, g: V.VsgGeometry, offsets, mesh: Mesh,
                           gather_cfg: GatherConfig = GatherConfig(),
                           disp_cfg: DispersionConfig = DispersionConfig(),
                           disp_start_x: float = -150.0, disp_end_x: float = 0.0,
                           dx: float = 8.16, axis: str = "win"):
    """Build every slot's gathers, stack them and image the stack.

    ``batch``: the shards of :func:`shard_windows`, or a whole
    :class:`WindowBatch`, which is sharded first.  Returns
    ``(stacked_gather (nch_out, wlen), disp_image (nvel, nfreq))`` on the
    first slot's device; across processes on rank 0, and ``None`` on the
    other ranks."""
    _check_axis(mesh, axis)
    shards: Sequence[WindowBatch] = (shard_windows(batch, mesh, axis)
                                     if isinstance(batch, WindowBatch) else batch)
    local = mesh.local_slots
    if len(shards) != len(local):
        raise ValueError(f"{len(shards)} shards for {len(local)} slots of a mesh of "
                         f"{mesh.size}")
    home = mesh.devices[local[0]]

    def local_sums():
        return [_masked_sum(V.build_gather_batch(s, g, gather_cfg), s.valid) for s in shards]

    if not mesh.multiprocess:
        parts = local_sums()
    else:
        parts = D.agreed(local_sums, "sharded_stack_pipeline", home)
        # each slot's sum and count as one tensor, to rank 0 in slot order
        shape = parts[0][0].shape
        packed = [torch.cat([n.reshape(-1), c.reshape(1)]) for n, c in parts]
        got = D.gather_to_root(packed, home)
        if got is None:
            return None
        parts = [(p[:-1].reshape(shape), p[-1]) for p in got]
    num, count = parts[0]
    for n, c in parts[1:]:
        num, count = num + n.to(home), count + c.to(home)
    stack = num / torch.clamp(count, min=1.0)
    img = V.gather_disp_image(stack, np.asarray(offsets), g.dt, dx, disp_cfg,
                              disp_start_x, disp_end_x)
    return stack, img
