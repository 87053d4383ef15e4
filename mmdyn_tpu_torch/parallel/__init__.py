"""Data parallelism over processes, one per device (port of
``mmdyn_tpu/parallel``): ``make_mesh`` and its collectives
(``parallel/mesh.py``)."""

from mmdyn_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads,
    all_reduce_sum,
    cli_mesh,
    gather_rows,
    launched,
    make_mesh,
    reduce_metrics,
    replicate,
    shard_batch,
    sharded,
    spawn,
    spawn_cli,
)
