"""Job kind ``meta_train``: ``MetaASRTrainer.step`` back to back on one card.

The traffic file gives the meta-batch (tasks, support and query shots,
samples and tokens an utterance) and the pool of distinct meta-batches
made on the device from the seed and cycled, as a resident corpus feeds
them. The reported rate counts unique utterances, tasks x (support +
query) a step.
"""

from __future__ import annotations

from benchmark import inputs, program, training
from benchmark.yardstick import flops


class MetaCell:
    """The trainer, its state and its pool of meta-batches on one card. With
    a process ``group`` of W ranks (``jobs/meta_train_dp.py``) each rank
    runs its task group's share of the traffic's tasks, and ``batches``
    gives the whole meta-batches the reference runs."""

    loss_key = "meta_loss"

    def __init__(self, ctx, dev, group=None):
        import tempfile

        from metaasr_tpu_torch.parallel.distributed import world_size
        from metaasr_tpu_torch.task import ASRTask
        from metaasr_tpu_torch.train.meta_train import MetaASRTrainer

        conf, t = ctx.cell.config, ctx.cell.traffic
        self.conf, self.traffic, self.seed, self.dev = conf, t, ctx.seed, dev
        self.world = world_size(group)
        cfg = program.config(conf)
        cfg.train.seed = ctx.seed
        cfg.meta.tasks_per_batch = t["tasks"]
        self.cfg = cfg
        self._dir = tempfile.TemporaryDirectory()
        self.task = ASRTask(cfg, device=dev)
        self.trainer = MetaASRTrainer(
            cfg, self.task, {}, {}, None, self._dir.name, device=dev,
            group=group, mesh_tasks=None if group is None else self.world)
        self.shapes = program.parameter_shapes(self.task)
        params = inputs.make_weights(self.shapes, ctx.seed, dev)
        self.state = {"params": params,
                      "opt_state": self.trainer.optimizer.init(params),
                      "step": 0, "seed": ctx.seed, "best_metric": float("inf"),
                      "stale_evals": 0}
        self.pool = [self.local(b) for b in self.batches(t["pool"])]
        m = cfg.model
        fwd = flops.transformer_forward(
            1 + (t["samples"] - 400) // 160, t["tokens"] + 1, m.d_model,
            m.d_ff, m.num_encoder_layers, m.num_decoder_layers, m.vocab_size)
        inner = cfg.meta.inner_steps
        frames = 1 + (t["samples"] - 400) // 160
        tasks = t["tasks"]
        self.traced_steps = ctx.cell.workload.get("traced_steps", 2)
        self.facts = {
            "utts_per_step": tasks * (t["k_support"] + t["k_query"]),
            "flops_per_step": flops.train_step(
                fwd, tasks * (t["k_support"] * inner + t["k_query"])),
            "peak_key": "bf16" if m.dtype == "bfloat16" else "tf32",
            # every K1 launch: one task's support or query set; every K2
            # launch: one loss of one task's set, at the encoder's length
            "k1": {"shape": (t["k_support"], t["samples"]),
                   "frames": [frames] * t["k_support"]},
            "k2": {"shape": (t["k_support"],
                             ((frames - 1) // 2 - 1) // 2,
                             2 * t["tokens"] + 1)},
        }

    def batches(self, n: int) -> list:
        """``n`` whole meta-batches, every rank's tasks."""
        t = self.traffic
        return inputs.meta_batches(n, t["tasks"], t["k_support"],
                                   t["k_query"], t["samples"], t["tokens"],
                                   self.cfg.model.vocab_size, self.seed,
                                   self.dev)

    def local(self, batch: dict) -> dict:
        """This rank's tasks of a whole meta-batch, as its own tensors."""
        if self.world == 1:
            return batch
        return {part: {k: v.clone() for k, v in rows.items()}
                for part, rows in self.trainer.mesh.local_batch(batch)
                .items()}

    def first_grad_norms(self, opt_state) -> dict:
        """Step 1's clipped gradient, from Adam's first moment after it."""
        return training.leaf_norms(opt_state["mu"],
                                   1.0 / (1.0 - self.cfg.optimizer.adam_b1))

    def reference_spec(self) -> dict:
        from benchmark.reference.training import Adam
        from benchmark.reference.transformer import Transformer

        m, meta, o = self.conf["model"], self.conf["meta"], \
            self.conf["optimizer"]
        return {
            "kind": "fomaml",
            "model": lambda p, prec: Transformer(
                p, heads=m["num_heads"], enc_layers=m["num_encoder_layers"],
                dec_layers=m["num_decoder_layers"], dropout=m["dropout"],
                precision=prec),
            "optimizer": lambda: Adam(o["lr"], m["d_model"],
                                      o["warmup_steps"], o["adam_b1"],
                                      o["adam_b2"], o["adam_eps"],
                                      o["grad_clip"]),
            "batches": self.batches,
            "kw": {"inner_steps": meta["inner_steps"],
                   "inner_lr": meta["inner_lr"],
                   "specaug": specaug_args(self.conf)},
        }

    def close(self):
        if self.trainer.logger is not None:
            self.trainer.logger.close()
        self.trainer = self.state = self.pool = self.task = None
        self._dir.cleanup()


def specaug_args(conf: dict) -> dict | None:
    """The configuration's SpecAugment for the reference (None when off).
    The reference neither dithers nor time-warps: a configuration that
    does is refused."""
    s = conf["specaug"]
    if conf["frontend"]["dither"] or s["time_warp"]:
        raise ValueError("the reference has no dither and no time warp")
    if not s["enabled"]:
        return None
    return {"freq_masks": s["num_freq_masks"],
            "freq_width": s["freq_mask_width"],
            "time_masks": s["num_time_masks"],
            "time_width": s["time_mask_width"],
            "time_ratio": s["time_mask_max_ratio"]}


CELL = MetaCell


def run(ctx) -> dict:
    return training.run(ctx, CELL)
