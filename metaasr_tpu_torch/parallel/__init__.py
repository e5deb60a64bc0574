"""More than one process (counterpart of ``metaasr_tpu/parallel/``).

``distributed.py`` holds the task-axis data-parallel meta-step's pieces:
``initialize`` (the process group, from torchrun's environment or from
arguments), ``task_rows`` (the meta-batch rows a rank owns) and
``reduce_outer`` (the one fp32 all-reduce of the outer gradient a step).
The reference's ``mesh.py`` has no counterpart: the port has no data axis,
so a group shards the task axis only.
"""

from metaasr_tpu_torch.parallel.distributed import (
    barrier,
    from_rank0,
    initialize,
    rank,
    reduce_outer,
    task_rows,
    world_size,
)

__all__ = ["barrier", "from_rank0", "initialize", "rank", "reduce_outer",
           "task_rows", "world_size"]
