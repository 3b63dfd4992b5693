"""Data parallelism over ``torch.distributed`` ranks (``tpugan/parallel/``)."""

from tpugan_torch.parallel.mesh import (  # noqa: F401
    DataParallel,
    auto_sharding,
    gather_rows,
    global_mean,
    global_means,
    local_rows,
    replicate_for,
)
