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
a resumed run never overwrites ``best`` with a worse model.

Two feeds (``data.loader``). ``buckets``: ``BucketBatcher``, bucketed
shapes, an order that is a pure function of (seed, epoch, batch index), so
resuming at ``state["step"]`` replays the same stream. ``grain``:
``data/grain_loader.py`` at the fixed caps (``max_frames·160 + 240``
samples, ``max_tokens`` tokens) on ``data.num_workers`` worker processes;
its iterator state is written beside each checkpoint
(``grain_state_<step>.bin``) and restored with it, so a resumed run replays
the same stream too.
"""

from __future__ import annotations

import glob
import math
import os
import pickle
import re
import time

import torch

from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.data.grain_loader import (
    make_grain_loader,
    restore_iterator_state,
    save_iterator_state,
)
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
        if cfg.data.loader not in ("buckets", "grain"):
            raise ValueError(f"data.loader={cfg.data.loader!r}: 'buckets' "
                             "or 'grain'")
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
        self._grain_it = None

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

    def _make_feed(self, start_step: int):
        """The training batches from batch ``start_step`` on: the bucketed
        stream, or the grain loader at the caps, restored from
        ``grain_state_<start_step>.bin`` where that file exists (without
        it the stream starts at batch 0, as the reference's does)."""
        if self.cfg.data.loader != "grain":
            return self.batcher.iter_from(start_step)
        d = self.cfg.data
        self._grain_it = make_grain_loader(
            self.train_datasets, d.batch_size, d.max_frames * 160 + 240,
            d.max_tokens, seed=d.seed, num_workers=d.num_workers)
        path = self._grain_state_path(start_step)
        if start_step > 0 and os.path.exists(path):
            with open(path, "rb") as f:
                restore_iterator_state(self._grain_it, pickle.load(f))
        return self._grain_it

    def _grain_state_path(self, step: int) -> str:
        return os.path.join(self.ckpt.ckpt_dir, f"grain_state_{step}.bin")

    def _save_ckpt(self, step: int, state: dict, metrics=None,
                   is_best: bool = False) -> None:
        """Checkpoint the train state and, under the grain loader, the
        iterator state beside it (written to ``.tmp``, then renamed); prune
        the states older than ``keep_ckpts · ckpt_every`` steps."""
        self.ckpt.save(step, state, metrics, is_best=is_best)
        blob = save_iterator_state(self._grain_it)
        if blob is None:
            return
        path = self._grain_state_path(step)
        with open(path + ".tmp", "wb") as f:
            pickle.dump(blob, f)
        os.replace(path + ".tmp", path)
        t = self.cfg.train
        oldest = step - t.keep_ckpts * max(t.ckpt_every, 1)
        for p in glob.glob(os.path.join(self.ckpt.ckpt_dir,
                                        "grain_state_*.bin")):
            m = re.search(r"grain_state_(\d+)\.bin$", p)
            if m and int(m.group(1)) < oldest:
                os.remove(p)

    def train(self, max_steps: int | None = None) -> dict:
        cfg = self.cfg.train
        max_steps = max_steps or cfg.max_steps
        state, _ = self.ckpt.restore(self.init_state(),
                                     map_location=self.device)
        # best checkpointing tracks train.keep_best_metric (dev_wer/dev_cer)
        metric_key = cfg.keep_best_metric.removeprefix("dev_")
        t0, utts = time.time(), 0
        step = state["step"]
        feed = self._make_feed(step)
        try:
            while step < max_steps:
                # the bound is checked before the fetch: the saved iterator
                # state never counts a batch that was not trained on
                batch = next(feed, None)
                if batch is None:
                    break
                state, metrics = self.step(state,
                                           to_device(batch, self.device))
                utts += len(batch["texts"])
                step += 1
                if step % cfg.log_every == 0:
                    out = {k: float(v) for k, v in metrics.items()}
                    out["utts_per_sec"] = utts / max(time.time() - t0,
                                                     1e-6)
                    self.logger.log(step, out)
                    t0, utts = time.time(), 0
                if (cfg.eval_every > 0 and step % cfg.eval_every == 0
                        and self.dev_dataset is not None):
                    dev = self.evaluate(state["params"], self.dev_dataset)
                    self.logger.log(step, {f"dev_{k}": v
                                           for k, v in dev.items()})
                    cur = dev.get(metric_key, dev["wer"])
                    is_best = cur < state["best_metric"]
                    stale = 0 if is_best else state["stale_evals"] + 1
                    state = dict(state, stale_evals=stale, best_metric=min(
                        cur, state["best_metric"]))
                    self._save_ckpt(step, state, dev, is_best=is_best)
                    if cfg.early_stop_patience and \
                            stale >= cfg.early_stop_patience:
                        self.logger.log(step, {"early_stop": 1.0})
                        break
                elif step % cfg.ckpt_every == 0:
                    self._save_ckpt(step, state)
            self._save_ckpt(state["step"], state)
        finally:
            if self._grain_it is not None:
                self._grain_it.close()    # its workers; the state is kept
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
