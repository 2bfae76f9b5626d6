"""Work spread over a mesh of devices: the window-sharded stack and the
all-pairs ring (the counterpart of ``das_diff_veh_tpu/parallel``).

A :class:`~.mesh.Mesh` (``make_mesh``) is driven by one process (several
cards, several slots on one card, or CPU slots for the tests) or, under a
``torch.distributed`` group (``initialize_cluster``), by every rank of the
group, each driving its own block of slots.

The contract across processes: every rank calls ``make_mesh`` and then each
sharded entry (``sharded_all_pairs_peak``, ``sharded_stack_pipeline``,
``inversion.invert_multirun(mesh=)``, ``inversion.invert_fleet(mesh=)``)
with the same arguments and the same data, as the JAX package's
multi-controller callers do.  Each rank computes its own slots; partial
results reach rank 0 in slot order, so rank 0's result equals the
single-process call over as many slots bit for bit, and the other ranks get
``None``.  A failure on one rank raises on every rank
(``distributed.PeerFailure`` on the others; ``distributed.PeerInvalid``, a
``ValueError``, when the failing rank refused its input), and
``resilience.degrade.resilient_all_pairs_peak`` demotes every rank's ladder
together, or none.  ``serve.mesh.MeshServingEngine`` serves from one process only.
"""

from das_diff_veh_tpu_torch.parallel.allpairs import sharded_all_pairs_peak
from das_diff_veh_tpu_torch.parallel.distributed import (PeerFailure, PeerInvalid,
                                                         cluster_spec_from_env,
                                                         initialize_cluster, local_rank, rank,
                                                         ring_perm, world_size)
from das_diff_veh_tpu_torch.parallel.mesh import Mesh, make_mesh, pad_batch
from das_diff_veh_tpu_torch.parallel.stack import shard_windows, sharded_stack_pipeline

__all__ = ["Mesh", "make_mesh", "pad_batch", "shard_windows", "sharded_stack_pipeline",
           "sharded_all_pairs_peak", "ring_perm", "cluster_spec_from_env",
           "initialize_cluster", "rank", "world_size", "local_rank", "PeerFailure",
           "PeerInvalid"]
