"""Data parallelism over ``torch.distributed`` (port of
``xfmamba_tpu/parallel``): the mesh and its steps (`mesh`), and the
multi-process set-up (`distributed`)."""

from xfmamba_tpu_torch.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated,
    shard_batch,
    make_parallel_train_step,
    make_parallel_infer,
)
from xfmamba_tpu_torch.parallel.distributed import (
    ensure_initialized,
    is_primary,
    make_global_mesh,
    process_batch_slice,
    host_local_batch_to_global,
)
