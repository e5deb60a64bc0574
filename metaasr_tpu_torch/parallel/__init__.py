"""More than one process (counterpart of ``metaasr_tpu/parallel/``).

``distributed.py`` holds the task-axis data-parallel meta-step's pieces:
``initialize`` (the process group, from torchrun's environment or from
arguments), ``task_rows`` (the meta-batch rows a rank owns),
``reduce_outer`` (the one fp32 all-reduce of the outer gradient a step)
and ``broadcast_state`` (rank 0's restored train state to every rank).
The reference's ``mesh.py`` has no counterpart: the port has no data axis,
so a group shards the task axis only.
"""

from metaasr_tpu_torch.parallel.distributed import (
    barrier,
    broadcast_state,
    from_rank0,
    initialize,
    launched_world_size,
    rank,
    rank_device,
    reduce_outer,
    task_rows,
    world_size,
)

__all__ = ["barrier", "broadcast_state", "from_rank0", "initialize",
           "launched_world_size", "rank", "rank_device", "reduce_outer",
           "task_rows", "world_size"]
