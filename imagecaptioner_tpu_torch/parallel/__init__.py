"""Data parallelism over a ``torch.distributed`` world
(``imagecaptioner_tpu/parallel/__init__.py``).

One process per card; ``core.mesh`` is a process's place in the world and
holds the global reductions, ``parallel.multihost`` joins and starts the
processes.  A step on W ranks of B rows computes what one process computes
on the global batch of W·B rows: the gradients, the batch norms'
statistics and the losses' normalizers are reduced over the world
(``train/steps.py``, ``core/modules.batch_norm``, ``distill/losses.py``).
Tensor and sequence parallelism (the JAX package's ``parallel/tp.py`` and
``parallel/sp.py``) are not ported yet.
"""

from imagecaptioner_tpu_torch.core.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, Mesh, create_mesh, data_size, local_device_count,
    pmax_over_data, psum_over_data, replicate, shard_batch, shard_time_major,
    world)
from imagecaptioner_tpu_torch.parallel import multihost  # noqa: F401

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "create_mesh", "data_size",
    "local_device_count", "multihost", "pmax_over_data", "psum_over_data",
    "replicate", "shard_batch", "shard_time_major", "world",
]
