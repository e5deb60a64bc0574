"""Process groups for the task-axis data-parallel meta-step (counterpart of
``metaasr_tpu/parallel/distributed.py``).

W processes each run M / W of a meta-batch's M tasks on replicated state.
Each process makes one call before it builds a trainer:

    from metaasr_tpu_torch.parallel import initialize
    group = initialize()   # None in one process; torchrun's env otherwise

and hands the group to ``MetaASRTrainer(..., group=group)``. A meta-step
then has one collective of its outer gradient: ``reduce_outer`` sums the
ranks' fp32 accumulators (each task's query loss already divided by the
global M) in one ``all_reduce``, and all-gathers the per-task losses, so
the gradient and the metrics are those of one process running all M tasks,
up to the order of the fp32 sums.

``task_rows`` is ``host_local_slice``: the draw of a step stays global and
each rank collates only its rows (``TaskSampler.sample(step, rows=)``).
``broadcast_state`` hands rank 0's restored train state to every rank when
a group's run resumes: only rank 0 writes and reads the workdir.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from metaasr_tpu_torch.utils.tree import flatten, unflatten_like


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "").strip()
    return int(value) if value else default


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def launched_world_size() -> int:
    """The number of processes this one was started among: the existing
    group's, else torchrun's ``WORLD_SIZE`` (1 where it is unset)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return _env_int("WORLD_SIZE", 1)


def rank_device(device, group):
    """The device a rank trains on: under a group on CUDA the rank's own
    card with its index (the current device, which ``initialize`` set),
    so that the trainer and the task compare equal; otherwise ``device``
    as given."""
    dev = torch.device("cuda" if device is None else device)
    if group is None or dev.type != "cuda" or dev.index is not None:
        return device
    return torch.device("cuda", torch.cuda.current_device())


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               device=None, timeout: float | None = None):
    """The run's process group -> ``None`` in one process, else the default
    group. Idempotent: once a group exists, it is returned.

    Arguments left ``None`` come from torchrun's environment: ``WORLD_SIZE``,
    ``RANK`` and ``LOCAL_RANK``, with ``MASTER_ADDR`` / ``MASTER_PORT`` read
    through ``env://``. With no argument and ``WORLD_SIZE`` unset or 1 this
    is one process and nothing starts. ``device`` defaults to
    ``cuda:LOCAL_RANK``, which becomes the current CUDA device; the backend
    defaults to ``nccl`` for a CUDA device and ``gloo`` for the CPU (an
    explicit ``backend`` wins: two ranks on one card need ``gloo``).
    ``timeout`` (seconds) bounds the rendezvous and every collective.

    Where the arguments or the environment name a multi-process run, a
    rendezvous that fails raises ``RuntimeError``: going on would train W
    divergent replicas, each taking itself for the whole run."""
    if dist.is_initialized():
        return dist.group.WORLD
    env_world = _env_int("WORLD_SIZE", 1)
    asked = any(a is not None for a in (init_method, world_size, rank))
    if not asked and env_world <= 1:
        return None
    local = _env_int("LOCAL_RANK", 0)
    dev = torch.device(f"cuda:{local}" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    extra = ({} if timeout is None
             else {"timeout": datetime.timedelta(seconds=timeout)})
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=env_world if world_size is None else world_size,
            rank=_env_int("RANK", 0) if rank is None else rank, **extra)
    except Exception as e:
        raise RuntimeError(
            "multi-process environment (WORLD_SIZE="
            f"{os.environ.get('WORLD_SIZE')!r}, init_method={init_method!r}, "
            f"world_size={world_size!r}, rank={rank!r}) but the {backend} "
            "rendezvous failed; refusing to continue as divergent "
            "single-process replicas") from e
    return dist.group.WORLD


def task_rows(num_tasks: int, group) -> slice:
    """The rows of the meta-batch's task axis this rank runs: the r-th of W
    equal slices, all of them without a group. Raises where W does not
    divide ``num_tasks`` (the reference drops the remainder rows)."""
    w, r = world_size(group), rank(group)
    if num_tasks % w:
        raise ValueError(f"{num_tasks} tasks a meta-batch do not split over "
                         f"{w} processes; make meta.tasks_per_batch a "
                         "multiple of the world size")
    per = num_tasks // w
    return slice(r * per, (r + 1) * per)


def reduce_outer(acc: dict, per_task: dict, group) -> tuple[dict, dict]:
    """The one collective of a data-parallel meta-step -> ({name: summed
    accumulator}, {name: [M] per-task values of every rank}).

    ``acc``: the rank's fp32 outer-gradient accumulators, flattened into one
    contiguous buffer for one ``all_reduce(SUM)`` and unflattened again.
    ``per_task``: [M / W] tensors (the per-task losses), stacked for one
    ``all_gather`` and concatenated in rank order, so they list the tasks
    as one process does; each comes back in its own dtype.
    ``reduce_outer.all_reduces`` counts the gradient all-reduces."""
    keys = list(acc)
    flat = torch.cat([acc[k].reshape(-1) for k in keys])
    if flat.dtype != torch.float32:
        raise TypeError(f"outer-gradient accumulators must be fp32, got "
                        f"{flat.dtype}")
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    reduce_outer.all_reduces += 1
    parts = flat.split([acc[k].numel() for k in keys])
    summed = {k: p.view_as(acc[k]) for k, p in zip(keys, parts)}
    names = list(per_task)
    local = torch.stack([per_task[n] for n in names])   # [L, M / W]
    gathered = [torch.empty_like(local) for _ in range(world_size(group))]
    dist.all_gather(gathered, local, group=group)
    every = torch.cat(gathered, dim=1)
    return summed, {n: every[i].to(per_task[n].dtype)
                    for i, n in enumerate(names)}


reduce_outer.all_reduces = 0


def barrier(group) -> None:
    """Wait for every rank (nothing without a group)."""
    if group is None:
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def from_rank0(obj, group):
    """Rank 0's ``obj`` on every rank (``obj`` itself without a group)."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def broadcast_state(state: dict, group) -> dict:
    """Rank 0's train state on every rank -> ``state`` holding rank 0's
    values (``state`` itself without a group).

    ``state`` is a nested dict (``MetaASRTrainer``'s: params, opt_state,
    step, seed, best_metric, stale_evals; a Meta-SGD tree too): rank 0's
    restored checkpoint there, each other rank's ``init_state()``. Its
    tensors travel as one flat buffer per dtype, in key order, broadcast
    from rank 0 and copied into the other ranks' tensors in place; its
    other leaves (Python numbers) go through ``from_rank0`` with rank 0's
    tensor layout. Every rank checks that layout against its own and the
    ranks agree on the outcome before any tensor moves, so a mismatch
    raises ``ValueError`` on every rank, rank 0 included, instead of
    leaving rank 0 blocked in a broadcast.
    ``broadcast_state.calls`` counts the calls with a group."""
    if group is None:
        return state
    flat = flatten(state)
    tensors = {k: v for k, v in flat.items() if torch.is_tensor(v)}
    layout = [(k, tuple(v.shape), v.dtype) for k, v in tensors.items()]
    src = rank(group) == 0
    head = from_rank0({"layout": layout, "other": {
        k: v for k, v in flat.items() if k not in tensors}} if src else None,
        group)
    same = [None] * world_size(group)
    dist.all_gather_object(same, head["layout"] == layout, group=group)
    if not all(same):
        raise ValueError(
            f"rank(s) {[r for r, ok in enumerate(same) if not ok]} hold a "
            "train state that differs from rank 0's in its tensors' names, "
            "shapes or dtypes")
    by_dtype: dict = {}
    for k, v in tensors.items():
        by_dtype.setdefault(v.dtype, []).append(v)
    for dtype, parts in by_dtype.items():
        sizes = [p.numel() for p in parts]
        buf = (torch.cat([p.reshape(-1) for p in parts]) if src else
               torch.empty(sum(sizes), dtype=dtype, device=parts[0].device))
        dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
        if not src:
            for p, piece in zip(parts, buf.split(sizes)):
                p.copy_(piece.view_as(p))
    broadcast_state.calls += 1
    return unflatten_like(state, {**tensors, **head["other"]})


broadcast_state.calls = 0
