"""Multi-process training and decode on ``torch.distributed``.

Port of :mod:`tfkaldi_tpu.parallel`: the ``(data, model)`` grid of ranks
and the split rules of the training state (:mod:`.mesh`), the process
group from torchrun's environment and the local batch (:mod:`.multihost`),
and the collectives the models and the trainer run under the grid
(:mod:`.comm`). ``python -m tfkaldi_tpu_torch.parallel.dryrun`` runs every
family and the controller on a grid of gloo ranks against one process.
"""

from tfkaldi_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    full_state_dict,
    grid_shape,
    local_state_dict,
    make_mesh,
    shard_batch,
    shard_state,
    split_dims,
    state_shardings,
)
from tfkaldi_tpu_torch.parallel.multihost import barrier, global_batch_from_local, initialize, shutdown

__all__ = [
    "Mesh",
    "barrier",
    "batch_sharding",
    "full_state_dict",
    "global_batch_from_local",
    "grid_shape",
    "initialize",
    "local_state_dict",
    "make_mesh",
    "shard_batch",
    "shard_state",
    "shutdown",
    "split_dims",
    "state_shardings",
]
