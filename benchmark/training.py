"""The run of a training cell, shared by its job kinds.

Set-up builds one trainer and its state from the seed's weights, and drives
that same object through its first ``CHECK_STEPS`` steps, each on its own
batch of the cell's pool, through the call and feed the window uses. It
records each step's loss, the per-leaf norm of the first step's clipped
gradient (worked out from the optimizer's state after that step) and the
per-leaf norm of the parameters' change over those steps. Then the window:
back-to-back steps over the pool until ``--seconds`` have passed, ended by
a synchronise. After it the program's state is freed and the reference runs
the same steps from the same weights and batches; the three gaps below
decide ``correct``.

- ``loss_gap``: the largest |program - reference| / |reference| over the
  steps' losses; ``first_loss_gap`` the first step's alone.
- ``grad_gap``: the largest, over leaves, of | |g_p| - |g_r| | over the
  larger of |g_r| and the median leaf's |g_r|.
- ``change_gap``: the same of the change's norms, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's (a
  leaf the loss does not reach moves under Adam by round-off alone).
- ``flip_share``: the share of parameter elements whose first update has
  another sign than the reference's first update (Adam's and Adadelta's
  first updates move each element by the sign of its gradient), over the
  elements the reference moves.
- ``support_gap`` (meta-training): the largest relative gap of a step's
  mean support loss before the inner steps, the forward pass at the
  meta-parameters.

A workload file's ``limits`` name the numbers that decide ``correct``.
"""

from __future__ import annotations

import math
import statistics
import time

from benchmark import program

CHECK_STEPS = 3


def leaf_norms(tree: dict, scale: float = 1.0) -> dict:
    import torch

    return {k: float(torch.linalg.vector_norm(v.double())) * scale
            for k, v in tree.items()}


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers above, from the program's and the reference's readings
    ({losses, grad_norms, change_norms, signs, support_losses} each)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                    ref["losses"]))
    rg, pg = ref["grad_norms"], prog["grad_norms"]
    gm = statistics.median(rg.values())
    grad = max(abs(pg[k] - rg[k]) / max(rg[k], gm) for k in rg)
    kept = [k for k in rg if rg[k] >= 1e-3 * gm]
    rc, pc = ref["change_norms"], prog["change_norms"]
    cm = statistics.median(rc[k] for k in kept)
    change = max(abs(pc[k] - rc[k]) / max(rc[k], cm) for k in kept)
    out = {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
           "first_loss_gap": abs(prog["losses"][0] - ref["losses"][0])
           / abs(ref["losses"][0])}
    flips = total = 0
    for k, r in ref["signs"].items():
        live = r != 0
        flips += int(((prog["signs"][k] != r) & live).sum())
        total += int(live.sum())
    out["flip_share"] = flips / max(total, 1)
    if "support_losses" in prog:
        out["support_gap"] = max(
            abs(p - r) / abs(r) for p, r in zip(prog["support_losses"],
                                                ref["support_losses"]))
    return out


def finite(x: float) -> float:
    return x if math.isfinite(x) else 1e308


def compared(ctx, found: dict) -> list:
    """The numbers the workload's ``limits`` name, each beside its limit."""
    return [{"name": k, "value": finite(found[k]), "limit": v}
            for k, v in ctx.cell.workload["limits"].items()]


def first_steps(cell) -> dict:
    """Drive the cell's trainer through its first steps -> the program's
    readings, with the trainer and its state for the window."""
    import torch

    state = cell.state
    start = {k: v.detach().clone() for k, v in state["params"].items()}
    losses, grads, support, signs = [], None, [], None
    for i in range(CHECK_STEPS):
        state, metrics = cell.trainer.step(state, cell.pool[i])
        losses.append(float(metrics[cell.loss_key]))
        if "support_loss_mean" in metrics:
            support.append(float(metrics["support_loss_mean"]))
        if grads is None:
            grads = cell.first_grad_norms(state["opt_state"])
            signs = {k: (state["params"][k] - start[k]).sign().to(torch.int8)
                     for k in start}
    change = {k: float((state["params"][k] - start[k]).double().norm())
              for k in start}
    cell.state = state
    out = {"losses": losses, "grad_norms": grads, "change_norms": change,
           "signs": signs}
    if support:
        out["support_losses"] = support
    return out


def run(ctx, cell_cls) -> dict:
    """The whole run of a training cell (``cell_cls(ctx, device)`` builds
    the trainer: see ``jobs/meta_train.py``)."""
    import torch

    from benchmark.yardstick.trace import traced

    dev = torch.device(ctx.device)
    cell = cell_cls(ctx, dev)
    prog = first_steps(cell)
    program.synchronize(dev)
    n = len(cell.pool)
    t0 = ctx.window_opens()
    end, steps = t0 + ctx.seconds, 0
    while time.perf_counter() < end:
        cell.state, _ = cell.trainer.step(
            cell.state, cell.pool[(CHECK_STEPS + steps) % n])
        steps += 1
    program.synchronize(dev)
    window = time.perf_counter() - t0
    trace = None
    if ctx.trace:
        traced_steps = cell.traced_steps

        def span():
            for i in range(traced_steps):
                cell.state, _ = cell.trainer.step(cell.state,
                                                  cell.pool[i % n])

        trace, _ = traced(torch, span)
    peak = program.memory_peak(dev)
    facts = dict(cell.facts, steps=steps, window_s=window,
                 device_kind=program.device_kind(dev), trace=trace,
                 traced_steps=cell.traced_steps if ctx.trace else 0,
                 chips=ctx.cell.chips)
    shapes, specs = cell.shapes, cell.reference_spec()
    cell.close()
    del cell
    program.release(dev)
    ref = reference_readings(ctx, dev, shapes, specs, "fp32")
    checks = compared(ctx, gaps(prog, ref))
    return dict(facts, end_to_end={
        ctx.cell.workload["metric"]: steps * facts["utts_per_step"] / window},
        attempted=steps, failed=0, memory_peak_bytes=peak, checks=checks)


def reference_readings(ctx, dev, shapes: dict, spec: dict,
                       precision: str) -> dict:
    """The reference's readings over the same first steps, from the seed's
    weights and batches, with every product in ``precision``."""
    import torch

    from benchmark import inputs
    from benchmark.reference import numerics, training

    numerics.strict_fp32()
    params = inputs.make_weights(shapes, ctx.seed, dev)
    batches = spec["batches"](CHECK_STEPS)
    prec = numerics.Precision(precision)
    with torch.no_grad():
        out = training.run_steps(
            spec["kind"], lambda p: spec["model"](p, prec), params, batches,
            ctx.seed, spec["optimizer"](), **spec["kw"])
    return out
