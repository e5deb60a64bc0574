"""Process groups for the data-parallel meta-step (counterpart of
``metaasr_tpu/parallel/distributed.py`` and ``mesh.py``).

W processes run a meta-batch of M tasks on replicated state, laid out as
the reference's ``make_mesh(num_task=N)`` lays out its devices: N task
groups of D = W / N ranks (``Mesh``). Rank r is in task group r // D, which
runs M / N of the tasks, at data index r % D. Each process makes one call
before it builds a trainer:

    from metaasr_tpu_torch.parallel import initialize
    group = initialize()   # None in one process; torchrun's env otherwise

and hands the group to ``MetaASRTrainer(..., group=group, mesh_tasks=N)``
(N = W when not given: the task axis alone). A meta-step then has one
collective of its outer gradient: ``reduce_outer`` sums the ranks' fp32
accumulators (each task's query loss already divided by the global M) in
one ``all_reduce``, and all-gathers the per-task losses, so the gradient
and the metrics are those of one process running all M tasks, up to the
order of the fp32 sums.

With D > 1 (the data axis) under first order each rank of a group runs
k / D of every task's k support and query shots: each inner step's
gradient is the sum of the group's partial gradients, taken by one fp32
``all_reduce`` over the group's ``DataAxis`` (``reduce_inner``), so the D
ranks take the same inner update and hold bit-equal adapted parameters.
Second order runs the task's whole shots on each of the D ranks, as the
reference shards its task axis alone there.

``task_rows`` is ``host_local_slice``: the draw of a step stays global and
each rank collates only its rows (``TaskSampler.sample(step, rows=,
shots=)``). ``broadcast_state`` hands rank 0's restored train state to
every rank when a group's run resumes: only rank 0 writes and reads the
workdir.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from metaasr_tpu_torch.utils.rows import Rows
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


def task_rows(num_tasks: int, group, num_task: int | None = None) -> slice:
    """The rows of the meta-batch's task axis this rank runs: those of its
    task group, the (r // D)-th of ``num_task`` = N equal slices (N = W by
    default, one rank a group), all of them without a group. Raises where
    N does not divide ``num_tasks`` (the reference drops the remainder
    rows)."""
    w, r = world_size(group), rank(group)
    n = w if num_task is None else num_task
    if num_tasks % n:
        axis = ("the world size" if n == w
                else f"the task axis (--mesh-tasks {n})")
        raise ValueError(f"{num_tasks} tasks a meta-batch do not split over "
                         f"{n} task groups; make meta.tasks_per_batch a "
                         f"multiple of {axis}")
    per, g = num_tasks // n, r // (w // n)
    return slice(g * per, (g + 1) * per)


@dataclass(frozen=True)
class DataAxis:
    """A rank's place on the data axis: ``group`` holds the ``size`` ranks
    of its task group, which split each task's shots, and ``index`` is its
    place among them."""

    group: object
    size: int
    index: int

    def rows(self, count: int) -> Rows:
        """This rank's rows of a whole batch of which it holds ``count``."""
        return Rows.part(self.index, self.size, count * self.size)


@dataclass(frozen=True)
class Mesh:
    """The ('task', 'data') layout of a run: ``group`` (the world's; None
    in one process) split into ``num_task`` task groups; ``data`` is this
    rank's ``DataAxis``, None where a group is one rank."""

    group: object
    num_task: int
    data: DataAxis | None

    def task_rows(self, num_tasks: int) -> slice:
        return task_rows(num_tasks, self.group, self.num_task)

    def local_batch(self, meta_batch: dict, split_shots: bool = True) -> dict:
        """This rank's part of a whole meta-batch ``{"support": {...},
        "query": {...}}`` of [M, k, ...] arrays or tensors, as
        ``TaskSampler.sample(rows=, shots=)`` collates it: its task group's
        tasks and, on the data axis with ``split_shots`` (first order), its
        shots of each, with every shot's ``whole_token_lens`` beside them."""
        rows = self.task_rows(next(iter(meta_batch["support"].values()))
                              .shape[0])
        out = {}
        for part, batch in meta_batch.items():
            local = {k: v[rows] for k, v in batch.items()}
            if self.data is not None and split_shots:
                k = local["token_lens"].shape[1]
                shots = Rows.part(self.data.index, self.data.size, k)
                (lo, hi), = shots.spans
                local = {n: v[:, lo:hi] for n, v in local.items()}
                local["whole_token_lens"] = batch["token_lens"][rows]
            out[part] = local
        return out


def make_mesh(group, num_task: int | None = None) -> Mesh:
    """The reference's ``make_mesh(num_task)`` over the W ranks of
    ``group``: ``np.arange(W).reshape(num_task, W // num_task)``, N = W by
    default (no data axis). With D = W / N > 1 every rank calls
    ``dist.new_group`` for each task group's ranks, in the same order, and
    keeps its own. Raises where N does not divide W."""
    w, r = world_size(group), rank(group)
    n = w if num_task is None else int(num_task)
    if n < 1 or w % n:
        raise ValueError(f"a task axis of {n} does not divide the world "
                         f"size {w}")
    d = w // n
    data = None
    if d > 1:
        groups = [dist.new_group(list(range(g * d, (g + 1) * d)))
                  for g in range(n)]
        data = DataAxis(groups[r // d], d, r % d)
    return Mesh(group, n, data)


def reduce_inner(tensors: list, data: DataAxis) -> list:
    """The one collective of an inner step on the data axis -> each of
    ``tensors`` summed over the task group's ranks, in fp32: they travel
    cast to fp32 in one contiguous buffer, one ``all_reduce(SUM)``, and
    come back as fp32 views of it (the caller casts once to its working
    dtype). Every rank gets the same bits, so the group's ranks take the
    same update. ``reduce_inner.all_reduces`` counts the calls."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=data.group)
    reduce_inner.all_reduces += 1
    return [p.view(t.shape) for p, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]


reduce_inner.all_reduces = 0


def reduce_outer(acc: dict, per_task: dict, group,
                 data_size: int = 1) -> tuple[dict, dict]:
    """The one collective of a data-parallel meta-step -> ({name: summed
    accumulator}, {name: [M] per-task values}).

    ``acc``: the rank's fp32 outer-gradient accumulators, flattened into one
    contiguous buffer for one ``all_reduce(SUM)`` and unflattened again.
    ``per_task``: [M / N] tensors (the per-task losses), stacked for one
    ``all_gather``; each task group's ``data_size`` = D values of a task
    are summed (a data axis's ranks hold partial losses, or the whole on
    data index 0 and zeros elsewhere), then the groups are concatenated in
    rank order, so they list each task once, as one process does; each
    comes back in its own dtype. ``reduce_outer.all_reduces`` counts the
    gradient all-reduces."""
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
    local = torch.stack([per_task[n] for n in names])   # [L, M / N]
    w = world_size(group)
    gathered = [torch.empty_like(local) for _ in range(w)]
    dist.all_gather(gathered, local, group=group)
    every = torch.stack(gathered).view(w // data_size, data_size,
                                       *local.shape).sum(1)
    every = every.transpose(0, 1).reshape(len(names), -1)
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
