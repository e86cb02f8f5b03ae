from ccdm_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads,
    batch_sharded,
    constrain_batch,
    create_mesh,
    init_distributed,
    replicated,
    shard_batch,
    sharded_apply,
)
