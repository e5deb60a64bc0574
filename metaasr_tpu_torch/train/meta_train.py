"""Meta-training and the meta-test: ``meta_train``, ``meta_adapt``,
``decode`` and ``eval_heldout`` (counterpart of
``metaasr_tpu/train/meta_train.py``).

- ``meta_train``: the outer loop over meta-batches of accent tasks. One
  step: per task, the front-end once, the inner SGD steps on the support
  set, the query loss and its backward (FOMAML; under MAML that backward
  also runs through the inner gradients), or the inner steps on support +
  query and the parameter delta (Reptile); then the outer Adam update of
  the mean over tasks. Every ``train.eval_every`` steps, when there are
  held-out accents, ``eval_heldout`` scores the parameters; the best by
  ``heldout_wer_mean`` is saved as ``best`` and ``train.early_stop_patience``
  evaluations without a gain stop the run. Otherwise a checkpoint is saved
  every ``train.ckpt_every`` steps.
- ``meta_adapt``: a fresh copy of the meta parameters and ``adapt_steps``
  inner SGD steps on a held-out accent's k-shot support set; its result
  feeds ``decode`` and ``ServingDecoder``'s hot-swapped parameters.
- ``decode``: greedy CTC or the joint CTC/attention beam search over a
  dataset -> WER/CER, optionally dumping hypotheses (and n-best lists) as
  JSONL. The beam search and its read-back are serving's own
  (``serve/export.py::decode_features``, ``read_decoded``); with
  ``train.lm_ckpt`` set and ``train.lm_weight`` not 0 the search fuses that
  LM (loaded once, onto the trainer's device).
- ``eval_heldout``: ``meta_adapt`` + ``decode`` on every held-out accent,
  averaged over ``train.eval_support_draws`` support draws: the headline
  metric, WER after k-shot adaptation on an unseen accent.

The train state is a dict {params, opt_state, step, seed, best_metric,
stale_evals}; the best-metric tracking lives in the checkpointed state, so
a resumed run never overwrites ``best`` with a worse model.

Two feeds give ``meta_train`` its batches, the same batch for a step
either way. The device-resident corpus (``data.resident``: ``on``, or
``auto`` while ``resident_store_bytes`` is within ``resident_max_gb``)
collates the training corpus once at the caps onto the trainer's device;
each step then copies only its [M, ks + kq] utterance indices and gathers
support and query there, each key cut to the step's bucket first. Otherwise
(``off``, or ``auto`` over the budget) a producer thread reads and collates
each step's utterances, and the main thread copies them to the device.

Data parallel over tasks (``group``, from ``parallel.initialize``): each of
W processes holds the whole state, collates its M / W task rows of every
step (``parallel.task_rows``; the draw and the bucket shape stay global)
from the streaming feed (no resident store under a group, as the
reference has none under a mesh), and ``maml_grads`` / ``reptile_grads``
sum the outer gradient across processes once a step, so every rank takes
the same Adam update and the state stays replicated. Only rank 0 writes
checkpoints and metric logs, and only rank 0 runs ``eval_heldout``: its
scores are broadcast, so every rank takes the same best, stale and
early-stop decision. A group's run resumes in fresh processes: rank 0
restores the latest checkpoint and ``broadcast_state`` hands the whole
state (parameters, optimizer state, step, seed, best metric, stale count)
to every rank, so no rank but rank 0 reads the workdir; the feed goes on
at the restored step. The CLI's ``--mesh-tasks N`` runs such a group under
torchrun.

``mesh_tasks`` = N below W adds the reference's data axis
(``parallel.make_mesh``): N task groups of D = W / N ranks, a group
running M / N tasks (its rows start at global task ``task_offset``).
Under first order each rank collates and runs k / D of every task's
support and query shots (``TaskSampler.sample(step, rows=, shots=)``)
and each inner step sums the group's partial gradients; under second
order each rank of a group runs the whole shots. The numbers are one
process's either way. The baseline trainers with their dev evaluation
are in ``train/mono.py``.
"""

from __future__ import annotations

import json
import math
import queue
import threading
import time

import numpy as np
import torch

from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.data.sampler import (
    DEFAULT_SAMPLE_BUCKETS,
    TaskSampler,
    build_resident_store,
    collate,
    item_samples,
    resident_store_bytes,
    support_query_split,
)
from metaasr_tpu_torch.decode.greedy import greedy_to_texts
from metaasr_tpu_torch.device import resolve_device
from metaasr_tpu_torch.frontend.fbank import num_frames
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
from metaasr_tpu_torch.models.lm import lm_from_flax
from metaasr_tpu_torch.parallel.distributed import (
    barrier,
    broadcast_state,
    from_rank0,
    make_mesh,
    rank,
)
from metaasr_tpu_torch.serve.export import (
    beam_config_from_train,
    decode_features,
    read_decoded,
)
from metaasr_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_params_npz,
)
from metaasr_tpu_torch.train.logging import MetricLogger
from metaasr_tpu_torch.train.metrics import compute_cer, compute_wer
from metaasr_tpu_torch.train.optimizer import (
    apply_updates,
    global_norm,
    make_optimizer,
)
from metaasr_tpu_torch.utils.padding import bucket_length


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
                          remat_inner=cfg.meta.remat_inner,
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
                 device=None, group=None, mesh_tasks: int | None = None):
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
        # under a process group the rank's task group's rows and, on the
        # data axis under first order, its part of each task's shots; only
        # rank 0 writes
        self.group = group
        self.mesh = make_mesh(group, mesh_tasks)
        self.rows = self.mesh.task_rows(cfg.meta.tasks_per_batch)
        data = self.mesh.data
        self.shots = None
        if data is not None and cfg.meta.algo != "maml":
            for knob in ("k_support", "k_query"):
                k = getattr(cfg.meta, knob)
                if k % data.size:
                    raise ValueError(
                        f"meta.{knob} = {k} does not split over a data axis "
                        f"of {data.size} ranks (--mesh-tasks "
                        f"{self.mesh.num_task}); make it a multiple of "
                        f"{data.size}")
            self.shots = (data.index, data.size)
        self.rank0 = rank(group) == 0
        self.ckpt = self.logger = None
        if self.rank0:
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
        self._decode_model = None   # built at the first beam decode
        self._lm = None             # the fusion LM, loaded at first use
        self._store = None          # the resident corpus, built by meta_train
        self._resident_ready = False

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
            widen_scale=self._widen_scale(step), group=self.group,
            task_offset=self.rows.start, data=self.mesh.data)
        updates, opt_state = self.optimizer.update(grads, state["opt_state"],
                                                   state["params"])
        params = apply_updates(state["params"], updates)
        metrics = dict(metrics, grad_norm=global_norm(grads))
        return dict(state, params=params, opt_state=opt_state,
                    step=step + 1), metrics

    def _batch_feed(self, start_step: int, max_steps: int):
        """Meta-batches for steps [start_step, max_steps) (this rank's task
        rows): a producer thread reads and collates the next ones (a pure
        function of (seed, step)) while the device runs the current step;
        the copy to the device, like every collective, happens on the main
        thread."""
        q: queue.Queue = queue.Queue(maxsize=2)

        def produce():
            for step in range(start_step, max_steps):
                q.put(self.sampler.sample(step, rows=self.rows,
                                          shots=self.shots))
            q.put(None)

        threading.Thread(target=produce, daemon=True).start()
        while (batch := q.get()) is not None:
            yield to_device(batch, self.device)

    # ---------- the device-resident corpus (data.resident) ----------

    def _setup_resident(self) -> None:
        """Place the training corpus on the device once, as ``data.resident``
        says: ``off`` never, ``on`` always, ``auto`` when its reckoned size
        is within ``resident_max_gb``; never under a process group, whose
        ranks stream their own rows. Lazy, so adapt- and test-only sessions
        read no corpus; a store that cannot be built or placed raises."""
        if self._resident_ready:
            return
        self._resident_ready = True
        if self.group is not None:
            return
        d = self.cfg.data
        # YAML reads an unquoted on / off as a boolean
        mode = ({True: "on", False: "off"}[d.resident]
                if isinstance(d.resident, bool) else d.resident)
        if mode not in ("auto", "on", "off"):
            raise ValueError(
                f"data.resident must be auto|on|off, got {d.resident!r}")
        cap = self._num_samples_cap()
        if mode == "off" or (
                mode == "auto"
                and resident_store_bytes(self.accent_datasets, cap,
                                         d.max_tokens)
                > d.resident_max_gb * 1e9):
            return
        store, self._offsets = build_resident_store(
            self.accent_datasets, cap, d.max_tokens)
        self._store = {k: torch.from_numpy(v).to(self.device)
                       for k, v in store.items()}

    def _resident_indices(self, step: int):
        """(support rows [M, ks], query rows [M, kq] of the store, both
        int32, and the step's (num_samples, num_tokens) bucket)."""
        accents, sup, qry = self.sampler.sample_indices(step)
        shape = self.sampler.step_shape(accents, sup, qry)
        off = np.asarray([self._offsets[a] for a in accents],
                         dtype=np.int32)[:, None]
        return sup + off, qry + off, shape

    def _resident_batch(self, step: int) -> dict:
        """The meta-batch of ``step`` gathered from the store: equal, key for
        key, to the streaming feed's ``to_device(sampler.sample(step))``.
        Waveforms (or feature frames) and tokens are cut to the step's
        bucket before the gather, and the gather writes new contiguous
        tensors, so the step sees a streaming batch's layout. On CUDA the
        indices go through pinned memory without a stream sync."""
        sup, qry, (n_samples, n_tokens) = self._resident_indices(step)
        idx = torch.from_numpy(np.concatenate([sup, qry], 1).astype(np.int64))
        if self.device.type == "cuda":
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        width = {"audio": n_samples, "feats": max(1, num_frames(n_samples)),
                 "tokens": n_tokens}
        ks = sup.shape[1]
        parts = {"support": idx[:, :ks], "query": idx[:, ks:]}
        out = {p: {} for p in parts}
        for k, v in self._store.items():
            if k in width:
                v = v[:, : width[k]]
            for p, rows in parts.items():
                out[p][k] = v[rows]
        return out

    def _feed(self, start_step: int, max_steps: int):
        """Device batches for steps [start_step, max_steps): gathered from
        the resident store where ``data.resident`` places one, else
        streamed by ``_batch_feed``."""
        self._setup_resident()
        if self._store is not None:
            return map(self._resident_batch, range(start_step, max_steps))
        return self._batch_feed(start_step, max_steps)

    def meta_train(self, max_steps: int | None = None) -> dict:
        if self.sampler is None:
            raise ValueError(
                "meta_train needs meta.tasks_per_batch <= number of "
                f"training accents ({len(self.accent_datasets)} loaded); "
                "this trainer was built adapt-only")
        cfg = self.cfg.train
        max_steps = max_steps or cfg.max_steps
        state = self.init_state()
        if self.rank0:
            state, _ = self.ckpt.restore(state, map_location=self.device)
        if self.group is not None and from_rank0(state["step"], self.group):
            state = broadcast_state(state, self.group)
        m = self.cfg.meta
        # every rank's tasks: the group's rate, as one process counts it
        per_step = m.tasks_per_batch * (m.k_support * m.inner_steps
                                        + m.k_query)
        step = state["step"]
        feed = self._feed(step, max_steps)
        t0, utts = time.time(), 0
        for batch in feed:
            state, metrics = self.step(state, batch)
            utts += per_step
            step += 1
            if step % cfg.log_every == 0 and self.rank0:
                out = {k: float(v) for k, v in metrics.items()}
                out["utts_per_sec"] = utts / max(time.time() - t0, 1e-6)
                self.logger.log(step, out)
                t0, utts = time.time(), 0
            if (cfg.eval_every > 0 and step % cfg.eval_every == 0
                    and self.heldout_datasets):
                scores = from_rank0(self.eval_heldout(state["params"])
                                    if self.rank0 else None, self.group)
                self._log(step, scores)
                cur = scores["heldout_wer_mean"]
                is_best = cur < state["best_metric"]
                stale = 0 if is_best else state["stale_evals"] + 1
                state = dict(state, stale_evals=stale,
                             best_metric=min(cur, state["best_metric"]))
                self._save(step, state, scores, is_best=is_best)
                if cfg.early_stop_patience and \
                        stale >= cfg.early_stop_patience:
                    self._log(step, {"early_stop": 1.0})
                    break
            elif step % cfg.ckpt_every == 0:
                self._save(step, state)
        self._save(state["step"], state)
        return state

    def _log(self, step: int, scalars: dict) -> None:
        if self.rank0:
            self.logger.log(step, scalars)

    def _save(self, step: int, state: dict, *args, **kwargs) -> None:
        """Rank 0 writes the checkpoint; every rank then waits for it."""
        if self.rank0:
            self.ckpt.save(step, state, *args, **kwargs)
        barrier(self.group)

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
                           first_order=True, remat_inner=False,
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

    # ---------- the meta-test: decode and held-out evaluation ----------

    def decode(self, params, dataset, indices=None, max_utts: int = 100,
               mode: str = "greedy", dump_path: str | None = None,
               dump_nbest: int = 1) -> dict:
        """Decode ``dataset`` (or its ``indices``, at most ``max_utts``) ->
        {"wer", "cer"}.

        ``mode="greedy"``: greedy CTC. ``mode="beam"``: the batched joint
        CTC/attention beam search (transformer only; a VGG-BLSTM decodes
        greedily). Batches of ``data.batch_size`` pad to the smallest of the
        reference's waveform buckets (1, 2, 4, 8, 16 s) that fits, and every
        batch is dispatched before any result is read back. ``dump_path``
        writes one JSONL record {"hyp", "ref"} per utterance; beam mode adds
        the top hypothesis' "score", and ``dump_nbest`` > 1 an "nbest" list
        of {"hyp", "score"} (the search's joint scores, after the final
        ranking)."""
        params = split_lr(params)[0]   # zero-shot decode of a Meta-SGD tree
        indices = list(indices if indices is not None
                       else range(len(dataset)))[:max_utts]
        buckets = tuple(sorted({bucket_length(item_samples(dataset[j]),
                                              DEFAULT_SAMPLE_BUCKETS)
                                for j in indices}))
        use_beam = mode == "beam" and self.task.arch == "transformer"
        model = self._model_with(params) if use_beam else None
        bsz = self.cfg.data.batch_size
        pending, refs = [], []     # device outputs, read after the loop
        for i in range(0, len(indices), bsz):
            chunk = [dataset[j] for j in indices[i: i + bsz]]
            smax = bucket_length(max(item_samples(it) for it in chunk),
                                 buckets)
            batch = collate(chunk, smax, self.cfg.data.max_tokens)
            refs.extend(batch["texts"])
            batch = to_device(batch, self.device)
            pending.append(self._beam_dispatch_batch(model, batch)
                           if use_beam
                           else self.task.greedy_batch(params, batch))
        hyps, details = [], []      # details: per-utterance beam extras
        for out in pending:
            if use_beam:
                texts, extras = self._beam_read(out, nbest=dump_nbest)
                hyps.extend(texts)
                details.extend(extras)
            else:
                hyps.extend(greedy_to_texts(*out, self.tokenizer))
        if dump_path:
            with open(dump_path, "w") as f:
                for i, (h, r) in enumerate(zip(hyps, refs)):
                    rec = {"hyp": h, "ref": r}
                    if i < len(details):
                        rec.update(details[i])
                    f.write(json.dumps(rec) + "\n")
        return {"wer": compute_wer(hyps, refs), "cer": compute_cer(hyps, refs)}

    def _model_with(self, params: dict):
        """The trainer's decode module holding ``params`` (the beam search
        calls the model's methods, so it runs on a module, not through
        ``functional_call``)."""
        if self._decode_model is None:
            self._decode_model = self.task.build_model()
        self._decode_model.load_state_dict(params)
        return self._decode_model

    def _beam_dispatch_batch(self, model, batch: dict) -> dict:
        """The beam search on one device batch (features from ``feats`` or
        from K1 + CMVN on the audio) -> serving's packed outputs."""
        with torch.inference_mode():
            if "feats" in batch:
                feats, feat_lens = batch["feats"], batch["feat_lens"]
            else:
                feats, feat_lens = self.task.features(
                    batch["audio"], batch["audio_lens"],
                    batch.get("cmvn_mean"), batch.get("cmvn_std"))
            t = self.cfg.train
            return decode_features(
                self.task, model, feats, feat_lens, "beam",
                beam_config_from_train(self.cfg, lm_active=bool(t.lm_ckpt)),
                self._fusion_lm())

    def _fusion_lm(self):
        """The shallow-fusion LM of ``train.lm_ckpt`` (an npz of
        ``scripts/train_lm.py``; dims from its shapes) on the trainer's
        device, loaded once; None unless ``train.lm_weight`` is not 0 and
        ``train.lm_ckpt`` is set."""
        t = self.cfg.train
        if t.lm_weight == 0.0 or not t.lm_ckpt:
            return None
        if self._lm is None:
            self._lm = lm_from_flax(load_params_npz(t.lm_ckpt), self.device)
        return self._lm

    def _beam_read(self, out: dict, nbest: int = 1):
        """Read back one beam batch -> (top hypothesis per utterance, the
        dump's extras per utterance: {"score"} and, for nbest > 1,
        {"nbest": [...]})."""
        results = read_decoded(out, out["tokens"].shape[0], self.tokenizer,
                               nbest)
        return ([r.pop("text") for r in results], results)

    def eval_heldout(self, params, max_utts: int | None = None,
                     support_draws: int | None = None) -> dict:
        """k-shot adaptation + decode on every held-out accent: the headline
        metric. Decode follows ``train.eval_decode_mode``. Each accent's
        WER/CER is the mean over ``train.eval_support_draws`` support draws
        (split seeds 0, 1, ...), with the WER's standard deviation across
        draws beside it when there are several; ``heldout_wer_mean`` is
        the mean over accents (1.0 without held-out accents)."""
        t = self.cfg.train
        max_utts = max_utts or t.eval_max_utts
        draws = max(1, support_draws if support_draws is not None
                    else t.eval_support_draws)
        out, wers = {}, []
        for name, ds in self.heldout_datasets.items():
            draw_wer, draw_cer = [], []
            for seed in range(draws):
                adapted, test_idx = self.meta_adapt(params, ds, seed=seed)
                scores = self.decode(adapted, ds, test_idx,
                                     max_utts=max_utts,
                                     mode=t.eval_decode_mode)
                draw_wer.append(scores["wer"])
                draw_cer.append(scores["cer"])
            out[f"heldout_{name}_wer"] = float(np.mean(draw_wer))
            out[f"heldout_{name}_cer"] = float(np.mean(draw_cer))
            if draws > 1:
                out[f"heldout_{name}_wer_std"] = float(np.std(draw_wer))
            wers.append(float(np.mean(draw_wer)))
        out["heldout_wer_mean"] = float(np.mean(wers)) if wers else 1.0
        return out
