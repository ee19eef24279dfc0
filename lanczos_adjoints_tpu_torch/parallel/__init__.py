"""Row-partitioned operators over a mesh of partitions on one card."""

from lanczos_adjoints_tpu_torch.parallel.fused_halo import (  # noqa: F401
    sharded_dia_operator_fused,
)
from lanczos_adjoints_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh,
    NamedSharding,
    device_mesh,
    make_mesh,
    replicate,
    sharded_dense_operator,
    sharded_dia_operator,
    sharded_gram_matvec,
    sharded_gram_policy,
    shard_rows,
)
