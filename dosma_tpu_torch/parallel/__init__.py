"""Several cards for the port (counterpart of ``dosma_tpu/parallel/``)."""

from dosma_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    NamedSharding,
    PartitionSpec,
    get_mesh,
    make_mesh,
    shard_voxels,
    sharded_lm_fit,
    sharded_register_chain_batch,
    sharded_unet_inference,
)
