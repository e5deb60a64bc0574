"""Mono (single-accent) and multitask (pooled multi-accent) trainers
(counterpart of ``metaasr_tpu/train/mono.py``).

The standard loop: bucketed batch -> front-end (K1 + CMVN + SpecAugment) ->
model -> loss (K2) -> backward -> clipped optimizer step; every
``train.eval_every`` steps a greedy-CTC evaluation of the dev set (CER/WER)
with best-checkpoint tracking and early stopping
(``train.early_stop_patience``). For the VGG-BLSTM the model's recurrences
run in K3 (forward) and K3b (backward).

The train state is a dict {params, opt_state, step, seed, best_metric,
stale_evals}; the best-metric tracking lives in the checkpointed state, so
a resumed run never overwrites ``best`` with a worse model. The data order
is a pure function of (seed, epoch, batch index), so resuming at
``state["step"]`` replays the same stream. Not ported: the grain loader
(``data.loader: grain``, ROADMAP.md port queue).
"""

from __future__ import annotations

import math
import time

import torch

from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.data.sampler import BucketBatcher, collate, item_samples
from metaasr_tpu_torch.decode.greedy import greedy_to_texts
from metaasr_tpu_torch.device import resolve_device
from metaasr_tpu_torch.meta.maml import fold_in, make_generator
from metaasr_tpu_torch.train.checkpoint import CheckpointManager
from metaasr_tpu_torch.train.logging import MetricLogger
from metaasr_tpu_torch.train.meta_train import to_device
from metaasr_tpu_torch.train.metrics import compute_cer, compute_wer
from metaasr_tpu_torch.train.optimizer import (
    apply_updates,
    global_norm,
    make_optimizer,
)
from metaasr_tpu_torch.utils.padding import bucket_length


class MonoASRTrainer:
    """Single- or pooled-accent supervised trainer."""

    def __init__(self, cfg: Config, task, train_datasets, dev_dataset,
                 tokenizer, workdir: str, device=None):
        self.device = resolve_device(device)
        if task.device != self.device:
            raise ValueError(f"task runs on {task.device}, trainer on "
                             f"{self.device}")
        if cfg.data.loader != "buckets":
            raise NotImplementedError(
                f"data.loader={cfg.data.loader!r} (the grain loader) is not "
                "ported yet (ROADMAP.md, port queue); use data.loader: "
                "buckets")
        self.cfg = cfg
        self.task = task
        self.tokenizer = tokenizer
        self.train_datasets = (train_datasets
                               if isinstance(train_datasets, list)
                               else [train_datasets])
        self.dev_dataset = dev_dataset
        self.heldout_datasets: dict = {}
        self.optimizer = make_optimizer(cfg.optimizer, cfg.model.d_model)
        self.ckpt = CheckpointManager(f"{workdir}/ckpts",
                                      keep=cfg.train.keep_ckpts)
        self.logger = MetricLogger(f"{workdir}/logs",
                                   print_every=cfg.train.log_every)
        self.batcher = BucketBatcher(
            self.train_datasets, cfg.data.batch_size, seed=cfg.data.seed,
            tokenizer=tokenizer)

    def init_state(self) -> dict:
        params = self.task.init_params(self.cfg.train.seed)
        return {"params": params, "opt_state": self.optimizer.init(params),
                "step": 0, "seed": int(self.cfg.train.seed),
                "best_metric": math.inf, "stale_evals": 0}

    def step(self, state: dict, batch: dict):
        """One training step on a device batch -> (new state, metrics as
        device tensors). The front-end (with its augmentation) runs outside
        the differentiated part, for either payload mode."""
        seed = fold_in(state["seed"], state["step"])
        with torch.no_grad():
            fb = self.task.preprocess(
                batch, make_generator(fold_in(seed, 0), self.device), True)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state["params"].items()}
        loss, metrics = self.task.loss_fn(
            params, fb, make_generator(fold_in(seed, 1), self.device), True)
        leaves = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, leaves))
        with torch.no_grad():
            updates, opt_state = self.optimizer.update(
                grads, state["opt_state"], state["params"])
            new_params = apply_updates(state["params"], updates)
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["grad_norm"] = global_norm(grads)
        return dict(state, params=new_params, opt_state=opt_state,
                    step=state["step"] + 1), metrics

    def train(self, max_steps: int | None = None) -> dict:
        cfg = self.cfg.train
        max_steps = max_steps or cfg.max_steps
        state, _ = self.ckpt.restore(self.init_state(),
                                     map_location=self.device)
        # best checkpointing tracks train.keep_best_metric (dev_wer/dev_cer)
        metric_key = cfg.keep_best_metric.removeprefix("dev_")
        t0, utts = time.time(), 0
        step = state["step"]
        feed = self.batcher.iter_from(step)
        while step < max_steps:
            batch = next(feed)
            state, metrics = self.step(state, to_device(batch, self.device))
            utts += len(batch["texts"])
            step += 1
            if step % cfg.log_every == 0:
                out = {k: float(v) for k, v in metrics.items()}
                out["utts_per_sec"] = utts / max(time.time() - t0, 1e-6)
                self.logger.log(step, out)
                t0, utts = time.time(), 0
            if (cfg.eval_every > 0 and step % cfg.eval_every == 0
                    and self.dev_dataset is not None):
                dev = self.evaluate(state["params"], self.dev_dataset)
                self.logger.log(step, {f"dev_{k}": v for k, v in dev.items()})
                cur = dev.get(metric_key, dev["wer"])
                is_best = cur < state["best_metric"]
                stale = 0 if is_best else state["stale_evals"] + 1
                state = dict(state, stale_evals=stale,
                             best_metric=min(cur, state["best_metric"]))
                self.ckpt.save(step, state, dev, is_best=is_best)
                if cfg.early_stop_patience and \
                        stale >= cfg.early_stop_patience:
                    self.logger.log(step, {"early_stop": 1.0})
                    break
            elif step % cfg.ckpt_every == 0:
                self.ckpt.save(step, state)
        self.ckpt.save(state["step"], state)
        return state

    def evaluate(self, params: dict, dataset, max_utts: int = 200) -> dict:
        """Greedy-CTC scoring of ``dataset`` -> {"wer", "cer"}. Batch shapes
        snap to the training bucket set; every batch is dispatched before
        any result is read back."""
        hyps, refs = [], []
        bsz = self.cfg.data.batch_size
        idx = list(range(min(len(dataset), max_utts)))
        pending = []
        for i in range(0, len(idx), bsz):
            items = [dataset[j] for j in idx[i: i + bsz]]
            smax = bucket_length(max(item_samples(it) for it in items),
                                 self.batcher.sample_buckets)
            umax = bucket_length(max(len(it["tokens"]) for it in items),
                                 self.batcher.token_buckets)
            batch = collate(items, smax, umax)
            pending.append(self.task.greedy_batch(
                params, to_device(batch, self.device)))
            refs.extend(batch["texts"])
        for packed, out_lens in pending:
            hyps.extend(greedy_to_texts(packed, out_lens, self.tokenizer))
        for s in range(min(self.cfg.train.log_text_samples, len(hyps))):
            self.logger.log_text(0, f"sample_{s}",
                                 f"hyp: {hyps[s]} | ref: {refs[s]}")
        return {"wer": compute_wer(hyps, refs), "cer": compute_cer(hyps, refs)}


class MultitaskASRTrainer(MonoASRTrainer):
    """Multi-accent joint training without meta-learning: the accents'
    utterances are pooled, which samples accents in proportion to their
    size."""

    def __init__(self, cfg: Config, task, accent_datasets: dict, dev_dataset,
                 tokenizer, workdir: str, device=None):
        super().__init__(cfg, task, list(accent_datasets.values()),
                         dev_dataset, tokenizer, workdir, device=device)
        self.accents = sorted(accent_datasets)
