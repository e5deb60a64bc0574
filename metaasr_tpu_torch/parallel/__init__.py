"""More than one process (counterpart of ``metaasr_tpu/parallel/``).

``distributed.py`` holds the data-parallel meta-step's pieces:
``initialize`` (the process group, from torchrun's environment or from
arguments), ``make_mesh`` (the reference's ``mesh.py``: N task groups of
D ranks, and a rank's ``DataAxis``), ``task_rows`` (the meta-batch rows a
rank owns), ``reduce_inner`` (the one fp32 all-reduce of an inner step's
gradient over a task group's D ranks), ``reduce_outer`` (the one fp32
all-reduce of the outer gradient a step) and ``broadcast_state`` (rank
0's restored train state to every rank).
"""

from metaasr_tpu_torch.parallel.distributed import (
    DataAxis,
    Mesh,
    barrier,
    broadcast_state,
    from_rank0,
    initialize,
    launched_world_size,
    make_mesh,
    rank,
    rank_device,
    reduce_inner,
    reduce_outer,
    task_rows,
    world_size,
)

__all__ = ["DataAxis", "Mesh", "barrier", "broadcast_state", "from_rank0",
           "initialize", "launched_world_size", "make_mesh", "rank",
           "rank_device", "reduce_inner", "reduce_outer", "task_rows",
           "world_size"]
