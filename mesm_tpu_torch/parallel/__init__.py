from .mesh import (
    SEQ_AXIS_KEYS,
    batch_sharding,
    make_mesh,
    replicated_sharding,
    seq_batch_sharding,
    shard_batch,
    shard_batch_seq,
)
