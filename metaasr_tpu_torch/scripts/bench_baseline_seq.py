"""Reference-style SEQUENTIAL FOMAML on the same card, with the port's own
compute (counterpart of the reference's ``bench_baseline_seq.py``).

Keeps the compute stack constant (the same flagship ``ASRTask`` model and
loss, K1 and K2 on the same card) and reproduces the REFERENCE's
orchestration (SURVEY.md section 3.1):

  - a Python loop over tasks, SEQUENTIAL;
  - an explicit full copy of the parameters per task (the
    ``copy.deepcopy`` analogue);
  - the preprocess per task, then one inner forward/backward + SGD update
    at a time;
  - the query gradient, and the outer gradient summed across tasks on the
    host side, then Adam 1e-3.

The port's ``maml_grads`` is itself a per-task loop (no vmap), so the
ratio ``vs_samechip_sequential`` of the bench measures what the functional
meta-step adds or saves over copy-the-model orchestration of the same
compute on the same card. Same workload constants as the bench.

Run standalone: python -m metaasr_tpu_torch.scripts.bench_baseline_seq
-> prints JSON {utts_per_sec} (CUDA; no CPU fallback).
"""

from __future__ import annotations

import json
import time

import numpy as np

# Bench workload (must match bench.py)
M_TASKS = 4
K_SUPPORT = 4
K_QUERY = 4
INNER_STEPS = 3
NUM_SAMPLES = 64000
NUM_TOKENS = 32
VOCAB = 30
INNER_LR = 1e-2


def draw_tasks(device) -> list[tuple[dict, dict]]:
    """One (support, query) pair per task, numpy seed 0, the same data
    volume as the bench (bench_baseline_seq.py:82-95)."""
    import torch

    rng = np.random.default_rng(0)
    num_samples, num_tokens = NUM_SAMPLES, NUM_TOKENS

    def one_batch(bsz):
        return {
            "audio": torch.from_numpy(
                0.1 * rng.standard_normal((bsz, num_samples)).astype(
                    np.float32)).to(device),
            "audio_lens": torch.full((bsz,), num_samples, dtype=torch.int32,
                                     device=device),
            "tokens": torch.from_numpy(
                rng.integers(1, VOCAB - 1, (bsz, num_tokens)).astype(
                    np.int32)).to(device),
            "token_lens": torch.full((bsz,), num_tokens, dtype=torch.int32,
                                     device=device),
        }

    return [(one_batch(K_SUPPORT), one_batch(K_QUERY))
            for _ in range(M_TASKS)]


def _grad(task, params: dict, feats: dict, seed: int) -> dict:
    """One forward + backward of the joint loss at ``params``."""
    import torch

    from metaasr_tpu_torch.meta.maml import make_generator

    with torch.enable_grad():
        at = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, _ = task.loss_fn(at, feats,
                               make_generator(seed, task.device), True)
        gs = torch.autograd.grad(loss, list(at.values()))
    return dict(zip(at, gs))


def outer_grads(task, params: dict, tasks, seed: int) -> dict:
    """The reference's per-task loop (bench_baseline_seq.py:130-140): a copy
    of the parameters, the preprocess, INNER_STEPS separate inner steps,
    the query gradient; -> the SUM over tasks of the query gradients."""
    import torch

    from metaasr_tpu_torch.meta.maml import fold_in, make_generator

    outer = None
    for m, (support, query) in enumerate(tasks):
        kt = fold_in(seed, m)
        fast = {k: v.clone() for k, v in params.items()}  # the deepcopy
        with torch.no_grad():
            sfeats = task.preprocess(support, make_generator(kt, task.device),
                                     True)
        for i in range(INNER_STEPS):
            g = _grad(task, fast, sfeats, fold_in(kt, i))
            fast = {k: fast[k] - INNER_LR * g[k] for k in fast}
        with torch.no_grad():
            qfeats = task.preprocess(query, make_generator(kt, task.device),
                                     True)
        g = _grad(task, fast, qfeats, fold_in(kt, 99))
        outer = g if outer is None else {k: outer[k] + g[k] for k in outer}
    return outer


def meta_step(task, opt, state: dict, tasks, seed: int) -> None:
    """One meta-step: the summed outer gradient over M, Adam, applied;
    ``state`` holds ``params`` and ``opt``."""
    from metaasr_tpu_torch.train.optimizer import apply_updates

    outer = outer_grads(task, state["params"], tasks, seed)
    grads = {k: g / len(tasks) for k, g in outer.items()}
    updates, state["opt"] = opt.update(grads, state["opt"], state["params"])
    state["params"] = apply_updates(state["params"], updates)


def measure(steps: int = 8, *, cfg=None, device="cuda") -> float:
    """Presentations/s: 1 first and 1 warm-up meta-step, then three passes
    of ``steps``, each ended by a read of a parameter element; the
    second-fastest pass (bench_baseline_seq.py:124-145)."""
    from metaasr_tpu_torch.device import resolve_device
    from metaasr_tpu_torch.meta.maml import fold_in
    from metaasr_tpu_torch.scripts.bench import adam_config
    from metaasr_tpu_torch.task import ASRTask
    from metaasr_tpu_torch.train.optimizer import Optimizer

    dev = resolve_device(device)
    if cfg is None:
        from metaasr_tpu_torch.config import Config

        cfg = Config()
        cfg.model.arch = "transformer"
        cfg.model.vocab_size = VOCAB
        cfg.model.dtype = "bfloat16"
    task = ASRTask(cfg, device=dev)
    tasks = draw_tasks(dev)
    opt = Optimizer(adam_config())
    state = {"params": task.init_params(0)}
    state["opt"] = opt.init(state["params"])

    def read():
        return float(next(iter(state["params"].values())).ravel()[0])

    meta_step(task, opt, state, tasks, 0)  # first call: lazy set-up
    read()
    meta_step(task, opt, state, tasks, 0)  # warmup
    read()
    dts = []
    for p in range(3):
        t0 = time.perf_counter()
        for i in range(steps):
            meta_step(task, opt, state, tasks, fold_in(0, 10 * p + i))
        read()
        dts.append((time.perf_counter() - t0) / steps)
    dt = sorted(dts)[1]
    utts = M_TASKS * (K_SUPPORT * INNER_STEPS + K_QUERY)
    return utts / dt


if __name__ == "__main__":
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"utts_per_sec": None,
                          "error": "no CUDA device: the baseline runs on "
                                   "the card only"}))
        raise SystemExit(1)
    ups = measure()
    print(json.dumps({
        "utts_per_sec": round(ups, 2),
        "hardware": torch.cuda.get_device_name(0),
        "style": "reference sequential copy-the-model FOMAML, the port's "
                 "compute, same card",
    }))
