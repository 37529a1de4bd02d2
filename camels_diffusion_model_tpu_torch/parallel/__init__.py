"""Data parallelism over ``torch.distributed`` (counterpart of ``camels_diffusion_model_tpu.parallel``)."""

from .mesh import (
    Mesh,
    all_reduce,
    all_reduce_sum,
    gather_batch,
    init_distributed,
    local_rows,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
    world_size,
)

__all__ = [
    "Mesh",
    "all_reduce",
    "all_reduce_sum",
    "gather_batch",
    "init_distributed",
    "local_rows",
    "make_mesh",
    "pad_to_multiple",
    "replicate",
    "shard_batch",
    "world_size",
]
