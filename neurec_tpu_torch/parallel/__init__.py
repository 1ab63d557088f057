from neurec_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    batch_sharding,
    replicated,
    row_sharded,
    col_sharded,
    shard_params,
)
