"""MAML, FOMAML and Reptile meta-gradients over parameter dicts (counterpart
of ``metaasr_tpu/meta/maml.py``).

Everything here is generic over ``loss_fn(params, batch, generator, train)
-> (scalar, aux)`` with ``params`` a dict of tensors (the model's parameter
names; with Meta-SGD the tree ``{"model": ..., "inner_lr": ...}``), so the
meta-gradient math is tested on the analytic quadratic family and reused
verbatim by the ASR task.

- The inner loop is a Python loop of functional SGD updates
  ``p_{i+1} = p_i - lr * grad(loss)(p_i, support)``.
- FOMAML detaches the inner gradient's INPUT: ``grad`` is taken at a
  detached copy of ``p_i``, so the adapted parameters depend on the
  originals with identity Jacobian (the first-order approximation) and the
  outer backward never differentiates the inner gradient.
- Full MAML (``first_order=False``) is the same code without the detach:
  the inner gradient is taken at the live parameters with
  ``create_graph=True``, and the outer backward differentiates it
  (grad-over-grad). Every op of the loss must then be twice differentiable:
  the CTC term is (K2's Function routes its posterior through K2b,
  ``ops/ctc_kernel.py``); K3/K3b are not, so the trainer switches the BLSTM
  to the autograd loop (``ASRTask.require_full_autodiff``).
- ``remat_inner`` (on by default, as in the reference, which wraps the step
  in ``jax.checkpoint``): under second order each inner step is one
  ``_Recomputed`` Function. Its forward takes the step with a plain
  first-order gradient and keeps only the step's inputs; its backward runs
  the same step again with ``create_graph=True`` and returns the VJP. One
  recompute a step, and no step's activations outlive it: memory, never
  values. The recompute rebuilds its dropout generator from the step's
  integer seed (a generator object would have moved on by then).
- The task axis is a loop: batches carry a leading task axis [M, k, ...],
  each task runs and back-propagates its query loss / M in turn (one task's
  graph alive at a time) into fp32 accumulators, and the outer gradient is
  the mean over tasks. ``torch.func.vmap`` is not used: the kernels are
  ctypes calls that cannot see batched tensors.
- Data parallel over tasks (``group``, ``task_offset``): each of W
  processes gets its M / W rows of the meta-batch, seeds them by their
  GLOBAL task index, divides each query loss by the global M, and
  ``parallel.reduce_outer`` sums the fp32 accumulators across processes
  (one all-reduce a step) before the cast to the parameters' dtype; the
  metrics come from every rank's per-task losses. The result is one
  process's over all M tasks.
- The data axis (``data``, a ``parallel.DataAxis``): a task group of D
  ranks shares each task. Under first order each rank holds k / D of the
  task's support and query shots; its loss divides by the whole task's
  counts (the batch's ``whole_token_lens``), its generators carry its rows
  (``utils.rows``), so its draws are one process's at those rows, and each
  inner step sums the group's partial gradients and support losses in one
  fp32 ``parallel.reduce_inner`` before the clip and the update, so the D
  ranks hold bit-equal adapted parameters. The query loss a rank
  back-propagates is its partial; ``reduce_outer`` sums the partials.
  Second order runs the whole shots on every rank of the group, as the
  reference shards the task axis alone there; data index 0 alone adds its
  accumulators and losses to the outer sum, the others add zeros.
- ``preprocess_fn`` (front-end + SpecAugment) runs once per task batch,
  outside the inner loop.
- Meta-SGD needs no flag here: a ``{"model", "inner_lr"}`` tree updates
  each leaf with its own learned rate, which is not detached, so FOMAML's
  outer gradient reaches it.
- Randomness: the meta functions take an integer ``seed``; each consumer
  gets its own ``torch.Generator`` on the batch's device, seeded from
  ``fold_in(seed, ...)``, so a step is a pure function of its seed.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from metaasr_tpu_torch.parallel.distributed import (
    reduce_inner,
    reduce_outer,
    world_size,
)
from metaasr_tpu_torch.utils.rows import make_generator
from metaasr_tpu_torch.utils.tree import flatten, unflatten_like
from metaasr_tpu_torch.weights import flax_path


@dataclass(frozen=True)
class MetaAlgoConfig:
    inner_lr: float = 1e-2
    inner_steps: int = 3
    first_order: bool = True
    # recompute each second-order inner step in the outer backward instead
    # of keeping its activations (first order never recomputes)
    remat_inner: bool = True
    # low-precision meta-step: cast the fp32 masters once on entry, run the
    # inner loop and the outer backward in this dtype, cast the gradients
    # back to each master leaf's dtype on exit
    grad_dtype: str | None = None
    # global-norm clip of the inner gradient over the ADAPTED leaves
    # (0 = off); the scale is a constant to the outer gradient
    inner_clip: float = 0.0
    # ANIL: the inner loop updates only leaves whose Flax path contains one
    # of these substrings; the outer optimizer trains every leaf
    adapt_filter: tuple[str, ...] | None = None


LossFn = Callable  # (params, batch, generator, train) -> (scalar, aux)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def fold_in(seed: int, *data: int) -> int:
    """A new 63-bit seed from ``seed`` and integers (numpy SeedSequence)."""
    ss = np.random.SeedSequence([int(seed) & (2**63 - 1),
                                 *(int(d) for d in data)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def split_lr(params):
    """Meta-SGD tree -> (model, lr_tree); any other dict -> (params, None)."""
    if isinstance(params, dict) and set(params) == {"model", "inner_lr"}:
        return params["model"], params["inner_lr"]
    return params, None


def wrap_lr(model_params: dict, init_lr: float) -> dict:
    """Attach Meta-SGD inner rates: one fp32 scalar per model leaf."""
    return {"model": model_params,
            "inner_lr": {k: torch.tensor(init_lr, dtype=torch.float32,
                                         device=v.device)
                         for k, v in model_params.items()}}


def adapt_mask(model: dict, patterns: tuple[str, ...]) -> dict[str, bool]:
    """{leaf: adapted?}: a leaf adapts iff its Flax path (``encoder/layer_0
    /self_attn/qkv/kernel``, the reference's naming) contains a pattern."""
    mask = {k: any(p in flax_path(k) for p in patterns) for k in model}
    if not any(mask.values()):
        roots = sorted({flax_path(k).split("/")[0] for k in model})
        raise ValueError(
            f"adapt_filter {patterns} matches no parameter leaf; the inner "
            f"loop would be a no-op. Param path roots: {roots}")
    return mask


def _task(batch: dict, m: int) -> dict:
    return {k: v[m] for k, v in batch.items()}


def _num_tasks(meta_batch: dict) -> int:
    return next(iter(meta_batch["support"].values())).shape[0]


def _device(batch: dict):
    return next(iter(batch.values())).device


def _batch_rows(batch: dict) -> int:
    return next(iter(batch.values())).shape[0]


def _rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float: multiplying a tensor
    by it equals the reference's weak-typed scalar product in that dtype,
    with no host-to-device copy."""
    return float(torch.tensor(float(x), dtype=dtype))


def make_inner_adapt(loss_fn: LossFn, cfg: MetaAlgoConfig,
                     train: bool = True) -> Callable:
    """Returns ``inner_adapt(params, support_batch, seed, inner_scale=None,
    widen_scale=None, data=None, rows=None) -> (adapted_params, support
    losses [inner_steps])``.

    ``inner_scale`` (0/1 gate of every inner update) and ``widen_scale``
    (0/1 gate of the updates of leaves outside ``adapt_filter``) are host
    numbers, constants to the outer gradient, as is the clip scale.
    ``data`` (first order): ``support_batch`` is this rank's ``rows`` of
    the task's, and each step's gradient and loss are the data axis's sums
    (``reduce_inner``), taken before the clip.

    With ``cfg.first_order`` false the adapted parameters keep their graph
    back to ``params`` through every inner gradient (second-order MAML).
    With ``cfg.remat_inner`` too (the default), that graph holds each step
    as one ``_Recomputed`` node that saved only the step's inputs: the
    step's activations are freed in the forward and rebuilt once, by the
    same ``one_step`` with ``create_graph=True``, when the outer backward
    reaches it. Every model leaf and Meta-SGD rate is an input of the node
    (a frozen ANIL leaf still shapes the inner gradient); only the updated
    leaves are its outputs, the others are handed on outside it. The clip scale
    and the gates are constants in the recompute as in the forward, and the
    support loss returned is the forward's. ``chip_smoke.py``'s
    ``maml_step`` phase reports the peak device memory of the config4 step
    with and without it (PERF.md)."""
    second_order = not cfg.first_order

    def masks(model, widen_scale):
        """(the adapt filter's mask, the leaves an inner step updates)."""
        mask = (adapt_mask(model, cfg.adapt_filter) if cfg.adapt_filter
                else dict.fromkeys(model, True))
        return mask, [k for k in model if mask[k] or widen_scale is not None]

    def one_step(params, step_seed, batch, inner_scale, widen_scale,
                 create_graph, data=None, rows=None):
        model, lr = split_lr(params)
        mask, wrt = masks(model, widen_scale)
        generator = make_generator(step_seed, _device(batch), rows)
        with torch.enable_grad():
            # FOMAML detaches the INPUT of the inner gradient; MAML takes it
            # at the live tensors (a leaf the caller holds without
            # requires_grad carries no outer gradient either way)
            at = {k: (v if create_graph and v.requires_grad
                      else v.detach().requires_grad_(k in wrt))
                  for k, v in model.items()}
            loss, _ = loss_fn(at, batch, generator, train)
            gs = torch.autograd.grad(loss, [at[k] for k in wrt],
                                     create_graph=create_graph,
                                     allow_unused=True)
        grads = {k: torch.zeros_like(at[k]) if g is None else g
                 for k, g in zip(wrt, gs)}
        loss = loss.detach()
        if data is not None:
            # the whole task's gradient and loss: the group's partials
            # summed in fp32, cast once to the working dtype
            *summed, loss = reduce_inner([*grads.values(), loss], data)
            grads = {k: g.to(grads[k].dtype) for k, g in zip(grads, summed)}
        if cfg.inner_clip:
            gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                for k, g in grads.items() if mask[k]))
            scale = torch.clamp_max(cfg.inner_clip / (gn + 1e-12),
                                    1.0).detach()
            grads = {k: g * scale.to(g.dtype) for k, g in grads.items()}
        if inner_scale is not None:
            grads = {k: g * float(inner_scale) for k, g in grads.items()}
        new_model = {}
        for k, p in model.items():
            if k not in grads:
                new_model[k] = p
                continue
            g = grads[k]
            rate = (_rounded(cfg.inner_lr, p.dtype) if lr is None
                    else lr[k].to(p.dtype))
            if not mask[k]:
                rate = rate * float(widen_scale)
            new_model[k] = p - rate * g
        if lr is None:
            return new_model, loss
        return {"model": new_model, "inner_lr": lr}, loss

    def recomputed_step(params, step_seed, batch, inner_scale, widen_scale,
                        data=None, rows=None):
        """``one_step`` of second order as one ``_Recomputed`` node (no
        data axis: second order runs a task's whole shots)."""
        if data is not None or rows is not None:
            raise ValueError("second order takes a task's whole shots: no "
                             "data axis in its inner steps")
        flat = flatten(params)
        model, lr = split_lr(params)
        keys = masks(model, widen_scale)[1]

        def run(leaves, create_graph):
            tree = unflatten_like(params, dict(zip(flat, leaves)))
            new, loss = one_step(tree, step_seed, batch, inner_scale,
                                 widen_scale, create_graph)
            new_model = split_lr(new)[0]
            return [new_model[k] for k in keys], loss

        *outs, loss = _Recomputed.apply(run, *flat.values())
        new_model = {**model, **dict(zip(keys, outs))}
        if lr is None:
            return new_model, loss
        return {"model": new_model, "inner_lr": lr}, loss

    step_fn = (recomputed_step if second_order and cfg.remat_inner
               else functools.partial(one_step, create_graph=second_order))

    def inner_adapt(params, support_batch, seed: int, inner_scale=None,
                    widen_scale=None, data=None, rows=None):
        losses = []
        for i in range(cfg.inner_steps):
            params, loss = step_fn(params, fold_in(seed, i), support_batch,
                                   inner_scale, widen_scale, data=data,
                                   rows=rows)
            losses.append(loss)
        return params, torch.stack(losses)

    return inner_adapt


class _Recomputed(torch.autograd.Function):
    """One inner step that keeps only its inputs (the reference's
    ``jax.checkpoint`` of ``one_step``). ``run(leaves, create_graph) ->
    (updated leaves, support loss)`` is the step: the forward runs it with
    a first-order gradient and no graph; the backward runs it again on
    fresh leaves with ``create_graph=True`` and returns the VJP of its
    updated leaves, which differentiates the inner gradient (K2 launches
    once more there, and K2b once in the VJP)."""

    @staticmethod
    def forward(ctx, run, *leaves):
        outs, loss = run(leaves, False)
        ctx.run = run
        ctx.save_for_backward(*leaves)
        ctx.mark_non_differentiable(loss)
        ctx.set_materialize_grads(False)
        return (*outs, loss)

    @staticmethod
    @once_differentiable
    def backward(ctx, *cotangents):
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            live = [x.detach().requires_grad_(need)
                    for x, need in zip(ctx.saved_tensors, needs)]
            outs, _ = ctx.run(live, True)
        pairs = [(o, c) for o, c in zip(outs, cotangents[:-1])
                 if c is not None and o.requires_grad]
        wrt = [x for x in live if x.requires_grad]
        if not (pairs and wrt):
            return (None,) * (1 + len(live))
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                         [c for _, c in pairs],
                                         allow_unused=True))
        return (None, *(next(grads) if x.requires_grad else None
                        for x in live))


def _shot_rows(data, support: dict, query: dict):
    """This rank's rows of a task's support and query shots on the data
    axis (None, None without one)."""
    if data is None:
        return None, None
    return data.rows(_batch_rows(support)), data.rows(_batch_rows(query))


def _preprocess(preprocess_fn, support, query, seed, dev, rows=(None, None)):
    if preprocess_fn is None:
        return support, query
    with torch.no_grad():
        return (preprocess_fn(support, make_generator(fold_in(seed, 2), dev,
                                                      rows[0]), True),
                preprocess_fn(query, make_generator(fold_in(seed, 3), dev,
                                                    rows[1]), True))


def _leaf_copies(params: dict, dtype: torch.dtype | None,
                 requires_grad: bool) -> dict:
    """Detached working copies of the masters (cast once to ``dtype``)."""
    flat = {k: (v.detach().to(dtype) if dtype is not None
                and v.is_floating_point() else v.detach())
            for k, v in flatten(params).items()}
    if requires_grad:
        for v in flat.values():
            if v.is_floating_point():
                v.requires_grad_(True)
    return unflatten_like(params, flat)


def _grad_dtype(cfg: MetaAlgoConfig):
    return None if cfg.grad_dtype is None else _DTYPES[cfg.grad_dtype]


def _task_losses(loss_fn, inner_adapt, preprocess_fn, params, meta_batch,
                 seed: int, inner_scale, widen_scale, task_offset: int = 0,
                 data=None):
    """Per task, in turn: (query loss at the adapted parameters, with its
    graph back to ``params``; support loss at inner step 0). Row m is
    global task ``task_offset + m``, and seeded so. With ``data`` the rows
    hold this rank's shots: the query loss is its partial, the support
    loss the whole task's."""
    dev = _device(meta_batch["support"])
    for m in range(_num_tasks(meta_batch)):
        task_seed = fold_in(seed, task_offset + m)
        support, query = _task(meta_batch["support"], m), \
            _task(meta_batch["query"], m)
        rows = _shot_rows(data, support, query)
        support, query = _preprocess(preprocess_fn, support, query,
                                     task_seed, dev, rows)
        adapted, s_loss = inner_adapt(params, support, fold_in(task_seed, 0),
                                      inner_scale, widen_scale, data,
                                      rows[0])
        with torch.enable_grad():
            q_loss, _ = loss_fn(split_lr(adapted)[0], query,
                                make_generator(fold_in(task_seed, 1), dev,
                                               rows[1]), True)
        yield q_loss, s_loss[0]


def make_meta_loss(loss_fn: LossFn, cfg: MetaAlgoConfig,
                   preprocess_fn: Callable | None = None) -> Callable:
    """Returns ``meta_loss(params, meta_batch, seed, inner_scale=None,
    widen_scale=None) -> (scalar, aux)``: the mean over tasks of the query
    loss after the inner steps, differentiable w.r.t. ``params`` (first
    order under FOMAML, through the inner gradients under MAML), with
    per-task query and support losses in ``aux``. It keeps every task's
    graph; ``maml_grads`` back-propagates task by task instead."""
    inner_adapt = make_inner_adapt(loss_fn, cfg, train=True)

    def meta_loss(params, meta_batch, seed: int, inner_scale=None,
                  widen_scale=None):
        q, s = zip(*_task_losses(loss_fn, inner_adapt, preprocess_fn, params,
                                 meta_batch, seed, inner_scale, widen_scale))
        q = torch.stack(q)
        return q.mean(), {"task_query_losses": q,
                          "task_support_losses": torch.stack(s)}

    return meta_loss


def maml_grads(loss_fn: LossFn, cfg: MetaAlgoConfig,
               preprocess_fn: Callable | None = None):
    """Returns ``grad_fn(params, meta_batch, seed, inner_scale=None,
    widen_scale=None, group=None, task_offset=0, data=None) -> (grads,
    metrics)``, the outer gradient (FOMAML's, or MAML's with
    ``cfg.first_order`` false): the gradient of ``make_meta_loss``'s loss,
    accumulated in fp32 one task at a time so that one task's graph is
    alive at once. ``meta_batch = {"support": {...}, "query": {...}}``
    with a leading task axis; ``grads`` has the structure and dtypes of
    ``params``. Under a process ``group`` the batch holds this rank's task
    group's rows, the first of them global task ``task_offset``, and
    ``grads`` and ``metrics`` cover every task. With ``data`` (a
    ``parallel.DataAxis``) under first order the rows hold this rank's
    shots of each task; under second order the whole shots."""
    inner_adapt = make_inner_adapt(loss_fn, cfg, train=True)
    dtype = _grad_dtype(cfg)

    def grad_fn(params, meta_batch, seed: int, inner_scale=None,
                widen_scale=None, group=None, task_offset: int = 0,
                data=None):
        work = _leaf_copies(params, dtype, requires_grad=True)
        leaves = flatten(work)
        keys = [k for k, v in leaves.items() if v.requires_grad]
        acc = {k: torch.zeros_like(leaves[k], dtype=torch.float32)
               for k in keys}
        d = 1 if data is None else data.size
        m_tasks = _num_tasks(meta_batch) * world_size(group) // d
        shards = data if cfg.first_order else None
        q_losses, s_losses = [], []
        for q_loss, s_loss in _task_losses(loss_fn, inner_adapt,
                                           preprocess_fn, work, meta_batch,
                                           seed, inner_scale, widen_scale,
                                           task_offset, shards):
            gs = torch.autograd.grad(q_loss / m_tasks,
                                     [leaves[k] for k in keys],
                                     allow_unused=True)
            for k, g in zip(keys, gs):
                if g is not None:
                    acc[k] += g.float()
            q_losses.append(q_loss.detach())
            s_losses.append(s_loss)
        q, s = torch.stack(q_losses), torch.stack(s_losses)
        if data is not None and data.index:
            # what each rank of the group holds whole counts once: the
            # support losses (summed in the inner steps), and under second
            # order every value (each rank ran the whole task)
            s = torch.zeros_like(s)
            if shards is None:
                q = torch.zeros_like(q)
                acc = {k: torch.zeros_like(v) for k, v in acc.items()}
        if group is not None:
            acc, every = reduce_outer(acc, {"query": q, "support": s}, group,
                                      d)
            q, s = every["query"], every["support"]
        flat_p = flatten(params)
        grads = unflatten_like(params, {
            k: (acc[k].to(flat_p[k].dtype) if k in acc
                else torch.zeros_like(flat_p[k])) for k in flat_p})
        metrics = {"meta_loss": q.mean(), "query_loss_mean": q.mean(),
                   "query_loss_max": q.max(), "support_loss_mean": s.mean()}
        return grads, metrics

    return grad_fn


def reptile_grads(loss_fn: LossFn, cfg: MetaAlgoConfig,
                  preprocess_fn: Callable | None = None):
    """Reptile (Nichol et al. 2018) in ``maml_grads``'s shape: per task, the
    inner steps run on support and query concatenated, and the outer
    "gradient" is the mean over tasks of ``params - adapted``. No query
    backward. The last inner-step loss is reported under the query keys.
    ``group``, ``task_offset`` and ``data`` as in ``maml_grads``: under a
    group the ranks' deltas are summed in fp32 across processes and the
    mean, rounded to the deltas' dtype as one process's mean is, covers
    every task. On the data axis a rank's rows of the concatenation are
    its support rows, then its query rows after the whole support set,
    where one process's concatenation puts them; its D ranks hold the same
    delta, which data index 0 alone adds."""
    inner_adapt = make_inner_adapt(loss_fn, cfg, train=True)
    dtype = _grad_dtype(cfg)

    def grad_fn(params, meta_batch, seed: int, inner_scale=None,
                widen_scale=None, group=None, task_offset: int = 0,
                data=None):
        del inner_scale, widen_scale   # rejected for Reptile by algo_config
        work = _leaf_copies(params, dtype, requires_grad=False)
        m_tasks = _num_tasks(meta_batch)
        dev = _device(meta_batch["support"])
        deltas, first, last = [], [], []
        for m in range(m_tasks):
            task_seed = fold_in(seed, task_offset + m)
            support, query = _task(meta_batch["support"], m), \
                _task(meta_batch["query"], m)
            rows = _shot_rows(data, support, query)
            support, query = _preprocess(preprocess_fn, support, query,
                                         task_seed, dev, rows)
            both = {k: torch.cat([support[k], query[k]], dim=0)
                    for k in support}
            adapted, losses = inner_adapt(
                work, both, fold_in(task_seed, 0), data=data,
                rows=None if data is None else rows[0] + rows[1])
            fw, fa = flatten(work), flatten(adapted)
            deltas.append({k: fw[k] - fa[k] for k in fw})
            first.append(losses[0])
            last.append(losses[-1])
        flat_p = flatten(params)
        first_t, last_t = torch.stack(first), torch.stack(last)
        if group is None:
            mean = {k: torch.stack([d[k] for d in deltas]).mean(0)
                    for k in flat_p}
        else:
            acc = {k: sum(d[k].float() for d in deltas) for k in flat_p}
            size = 1 if data is None else data.size
            if data is not None and data.index:
                acc = {k: torch.zeros_like(v) for k, v in acc.items()}
                first_t, last_t = (torch.zeros_like(first_t),
                                   torch.zeros_like(last_t))
            acc, every = reduce_outer(acc, {"first": first_t,
                                            "last": last_t}, group, size)
            m_all = m_tasks * world_size(group) // size
            mean = {k: (acc[k] / m_all).to(deltas[0][k].dtype)
                    for k in flat_p}
            first_t, last_t = every["first"], every["last"]
        grads = unflatten_like(params, {k: mean[k].to(flat_p[k].dtype)
                                        for k in flat_p})
        metrics = {"meta_loss": last_t.mean(),
                   "query_loss_mean": last_t.mean(),
                   "query_loss_max": last_t.max(),
                   "support_loss_mean": first_t.mean()}
        return grads, metrics

    return grad_fn
