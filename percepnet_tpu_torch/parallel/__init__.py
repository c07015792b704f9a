from percepnet_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, Mesh, make_mesh, batch_sharding, replicated_sharding,
    shard_batch, replicate, init_distributed, process_index, process_count,
    all_reduce_mean_, broadcast_,
)
