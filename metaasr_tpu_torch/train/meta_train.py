"""Meta-training: ``meta_train`` and ``meta_adapt`` (counterpart of
``metaasr_tpu/train/meta_train.py``).

- ``meta_train``: the outer loop over meta-batches of accent tasks. One
  step: per task, the front-end once, the inner SGD steps on the support
  set, the query loss and its backward (FOMAML; under MAML that backward
  also runs through the inner gradients), or the inner steps on support +
  query and the parameter delta (Reptile); then the outer Adam update of
  the mean over tasks.
- ``meta_adapt``: a fresh copy of the meta parameters and ``adapt_steps``
  inner SGD steps on a held-out accent's k-shot support set; its result
  feeds ``ServingDecoder``'s hot-swapped parameters.

The train state is a dict {params, opt_state, step, seed, best_metric,
stale_evals}; batches are drawn by a producer thread and moved to the
device on the main thread. Not in this slice (ROADMAP.md): the
device-resident corpus (``data.resident``) and the mesh paths, the meta
trainer's held-out evaluation (``decode``, ``eval_heldout``;
``train.eval_every`` is not acted on here, checkpoints follow
``train.ckpt_every``) and ``average_checkpoints``. The baseline trainers
with their dev evaluation are in ``train/mono.py``.
"""

from __future__ import annotations

import math
import queue
import threading
import time

import numpy as np
import torch

from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.data.sampler import TaskSampler, support_query_split
from metaasr_tpu_torch.device import resolve_device
from metaasr_tpu_torch.meta.maml import (
    MetaAlgoConfig,
    fold_in,
    make_generator,
    make_inner_adapt,
    maml_grads,
    reptile_grads,
    split_lr,
    wrap_lr,
)
from metaasr_tpu_torch.train.checkpoint import CheckpointManager
from metaasr_tpu_torch.train.logging import MetricLogger
from metaasr_tpu_torch.train.optimizer import (
    apply_updates,
    global_norm,
    make_optimizer,
)


def algo_config(cfg: Config) -> MetaAlgoConfig:
    algo = cfg.meta.algo
    if algo not in ("fomaml", "maml", "reptile"):
        raise ValueError(f"meta algo must be fomaml|maml|reptile, got {algo}")
    if cfg.meta.learn_inner_lr and algo == "reptile":
        raise ValueError(
            "meta.learn_inner_lr needs a query gradient to train the rates; "
            "Reptile's outer update is a parameter delta (no rate signal) — "
            "use fomaml or maml")
    if _adapt_filter(cfg) and algo == "reptile":
        raise ValueError(
            "meta.adapt_filter is incompatible with Reptile: its outer "
            "gradient IS the inner delta, so filtered (frozen) leaves would "
            "never train at all — use fomaml or maml")
    if cfg.meta.inner_start_step and algo == "reptile":
        raise ValueError(
            "meta.inner_start_step is incompatible with Reptile: gating the "
            "inner loop to 0 zeroes its outer update entirely — use fomaml "
            "or maml")
    if cfg.meta.adapt_widen_step and not _adapt_filter(cfg):
        raise ValueError(
            "meta.adapt_widen_step stages the inner loop from adapt_filter "
            "leaves to all leaves — it requires meta.adapt_filter to be set "
            "(otherwise every leaf already adapts from step 0)")
    return MetaAlgoConfig(inner_lr=cfg.meta.inner_lr,
                          inner_steps=cfg.meta.inner_steps,
                          first_order=(algo != "maml"),
                          grad_dtype=(None if cfg.meta.grad_dtype == "float32"
                                      else cfg.meta.grad_dtype),
                          inner_clip=cfg.meta.inner_clip,
                          adapt_filter=_adapt_filter(cfg))


def _adapt_filter(cfg: Config) -> tuple[str, ...] | None:
    """meta.adapt_filter "a,b" -> ("a", "b"); "" -> None (adapt all)."""
    pats = tuple(s.strip() for s in cfg.meta.adapt_filter.split(",")
                 if s.strip())
    return pats or None


def to_device(batch: dict, device) -> dict:
    """numpy batch (nested, 'texts' dropped) -> tensors on ``device``."""
    return {k: (to_device(v, device) if isinstance(v, dict)
                else torch.from_numpy(np.ascontiguousarray(v)).to(device))
            for k, v in batch.items() if k not in ("texts", "accents")}


class MetaASRTrainer:
    def __init__(self, cfg: Config, task, accent_datasets: dict,
                 heldout_datasets: dict, tokenizer, workdir: str,
                 device=None):
        self.device = resolve_device(device)
        if task.device != self.device:
            raise ValueError(f"task runs on {task.device}, trainer on "
                             f"{self.device}")
        self.cfg = cfg
        self.task = task
        self.tokenizer = tokenizer
        self.accent_datasets = accent_datasets
        self.heldout_datasets = heldout_datasets
        if cfg.meta.algo == "maml":
            # second order: every op of the loss must be twice
            # differentiable. The CTC Functions are (K2b); K3/K3b are not,
            # so the BLSTM switches to the autograd loop.
            task.require_full_autodiff()
        self.optimizer = make_optimizer(cfg.optimizer, cfg.model.d_model)
        self.ckpt = CheckpointManager(f"{workdir}/ckpts",
                                      keep=cfg.train.keep_ckpts)
        self.logger = MetricLogger(f"{workdir}/logs",
                                   print_every=cfg.train.log_every)
        m, d = cfg.meta, cfg.data
        cap = self._num_samples_cap()
        s_buckets, u_buckets = (), ()
        if d.meta_buckets:
            s_buckets = tuple(sorted(
                {min(f * 160 + 240, cap) for f in d.frame_buckets} | {cap}))
            u_buckets = tuple(sorted(
                {min(u, d.max_tokens) for u in d.token_buckets}
                | {d.max_tokens}))
        # an adapt-only trainer (too few accents) never draws meta-batches
        self.sampler = None
        if accent_datasets and m.tasks_per_batch <= len(accent_datasets):
            self.sampler = TaskSampler(
                accent_datasets, k_support=m.k_support, k_query=m.k_query,
                tasks_per_batch=m.tasks_per_batch, num_samples=cap,
                num_tokens=d.max_tokens, seed=d.seed,
                sample_buckets=s_buckets, token_buckets=u_buckets)
        make_grads = reptile_grads if m.algo == "reptile" else maml_grads
        self._grad_fn = make_grads(task.loss_fn, algo_config(cfg),
                                   preprocess_fn=task.preprocess)

    def _num_samples_cap(self) -> int:
        return self.cfg.data.max_frames * 160 + 240   # frames -> samples

    def _inner_scale(self, step: int):
        """meta.inner_start_step gate: None when off, else 0.0/1.0."""
        start = self.cfg.meta.inner_start_step
        return None if not start else float(step >= start)

    def _widen_scale(self, step: int):
        """meta.adapt_widen_step gate (staged ANIL): None when off, else
        0.0/1.0 for the inner updates of leaves outside adapt_filter."""
        start = self.cfg.meta.adapt_widen_step
        return None if not start else float(step >= start)

    # ---------- state and one step ----------

    def init_state(self) -> dict:
        params = self.task.init_params(self.cfg.train.seed)
        if self.cfg.meta.learn_inner_lr:
            params = wrap_lr(params, self.cfg.meta.inner_lr)
        return {"params": params, "opt_state": self.optimizer.init(params),
                "step": 0, "seed": int(self.cfg.train.seed),
                "best_metric": math.inf, "stale_evals": 0}

    def step(self, state: dict, meta_batch: dict):
        """One meta-step on a device batch -> (new state, metrics as
        device tensors)."""
        step = state["step"]
        grads, metrics = self._grad_fn(
            state["params"], meta_batch, fold_in(state["seed"], step),
            inner_scale=self._inner_scale(step),
            widen_scale=self._widen_scale(step))
        updates, opt_state = self.optimizer.update(grads, state["opt_state"],
                                                   state["params"])
        params = apply_updates(state["params"], updates)
        metrics = dict(metrics, grad_norm=global_norm(grads))
        return dict(state, params=params, opt_state=opt_state,
                    step=step + 1), metrics

    def _batch_feed(self, start_step: int, max_steps: int):
        """Meta-batches for steps [start_step, max_steps): a producer thread
        reads and collates the next ones (a pure function of (seed, step))
        while the device runs the current step; the copy to the device
        happens on the main thread."""
        q: queue.Queue = queue.Queue(maxsize=2)

        def produce():
            for step in range(start_step, max_steps):
                q.put(self.sampler.sample(step))
            q.put(None)

        threading.Thread(target=produce, daemon=True).start()
        while (batch := q.get()) is not None:
            yield to_device(batch, self.device)

    def meta_train(self, max_steps: int | None = None) -> dict:
        if self.sampler is None:
            raise ValueError(
                "meta_train needs meta.tasks_per_batch <= number of "
                f"training accents ({len(self.accent_datasets)} loaded); "
                "this trainer was built adapt-only")
        cfg = self.cfg.train
        max_steps = max_steps or cfg.max_steps
        state, _ = self.ckpt.restore(self.init_state(),
                                     map_location=self.device)
        m = self.cfg.meta
        per_step = m.tasks_per_batch * (m.k_support * m.inner_steps
                                        + m.k_query)
        t0, utts = time.time(), 0
        step = state["step"]
        for batch in self._batch_feed(step, max_steps):
            state, metrics = self.step(state, batch)
            utts += per_step
            step += 1
            if step % cfg.log_every == 0:
                out = {k: float(v) for k, v in metrics.items()}
                out["utts_per_sec"] = utts / max(time.time() - t0, 1e-6)
                self.logger.log(step, out)
                t0, utts = time.time(), 0
            if step % cfg.ckpt_every == 0:
                self.ckpt.save(step, state)
        self.ckpt.save(state["step"], state)
        return state

    def meta_adapt(self, params: dict, accent_dataset,
                   adapt_steps: int | None = None,
                   k_support: int | None = None, seed: int = 0):
        """k-shot adaptation on a held-out accent -> (adapted model
        parameters, detached, and the test utterance indices)."""
        m = self.cfg.meta
        support, test_idx = support_query_split(
            accent_dataset, k_support or m.k_support,
            self._num_samples_cap(), self.cfg.data.max_tokens, seed=seed)
        inner = make_inner_adapt(
            self.task.loss_fn,
            MetaAlgoConfig(inner_lr=m.inner_lr,
                           inner_steps=adapt_steps or m.adapt_steps,
                           inner_clip=m.inner_clip,
                           # staged ANIL trains toward full-body adaptation;
                           # meta-test adapts every leaf
                           adapt_filter=(None if m.adapt_widen_step
                                         else _adapt_filter(self.cfg))),
            train=True)
        with torch.no_grad():
            batch = self.task.preprocess(
                to_device(support, self.device),
                make_generator(fold_in(seed, 0), self.device), True)
        adapted, _ = inner(params, batch, fold_in(seed, 1))
        model = split_lr(adapted)[0]
        return {k: v.detach() for k, v in model.items()}, test_idx
