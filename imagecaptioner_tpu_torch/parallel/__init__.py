"""Parallelism over a ``torch.distributed`` world
(``imagecaptioner_tpu/parallel/__init__.py``).

One process per card; ``core.mesh`` is a process's place in a (data,
model) world and holds the collectives, ``parallel.multihost`` joins and
starts the processes.  A step on d data blocks of B rows computes what one
process computes on the global batch of d·B rows: the gradients, the batch
norms' statistics and the losses' normalizers are reduced over the data
axis (``train/steps.py``, ``core/modules.batch_norm``,
``distill/losses.py``).  The model axis carries the frozen teacher's
tensor parallelism (``parallel.tp``: ``place_teacher_tp``) and sequence
parallelism (``parallel.sp``: ``sequence_sharding``, ``shard_seq``), with
explicit collectives over the model group where JAX lets GSPMD insert
them.
"""

from imagecaptioner_tpu_torch.core.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, Mesh, create_mesh, data_size, local_device_count,
    pmax_over_data, psum_over_data, replicate, shard_batch, shard_time_major,
    world)
from imagecaptioner_tpu_torch.parallel import multihost, sp, tp  # noqa: F401

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "create_mesh", "data_size",
    "local_device_count", "multihost", "pmax_over_data", "psum_over_data",
    "replicate", "shard_batch", "shard_time_major", "sp", "tp", "world",
]
