"""Job kind ``mono_train``: ``MonoASRTrainer.step`` back to back on one
card, the supervised baseline's step.

The traffic file gives the batch (utterances, samples and tokens an
utterance) and the pool of distinct batches made on the device from the
seed and cycled. The reported rate counts utterances, the batch a step.
"""

from __future__ import annotations

from benchmark import inputs, program, training
from benchmark.jobs.meta_train import specaug_args
from benchmark.yardstick import flops


class MonoCell:
    loss_key = "loss"

    def __init__(self, ctx, dev):
        import tempfile

        from metaasr_tpu_torch.task import ASRTask
        from metaasr_tpu_torch.train.mono import MonoASRTrainer

        conf, t = ctx.cell.config, ctx.cell.traffic
        self.conf, self.traffic, self.seed, self.dev = conf, t, ctx.seed, dev
        cfg = program.config(conf)
        cfg.train.seed = ctx.seed
        self.cfg = cfg
        self._dir = tempfile.TemporaryDirectory()
        self.task = ASRTask(cfg, device=dev)
        self.trainer = MonoASRTrainer(cfg, self.task, [], None, None,
                                      self._dir.name, device=dev)
        self.shapes = program.parameter_shapes(self.task)
        params = inputs.make_weights(self.shapes, ctx.seed, dev)
        self.state = {"params": params,
                      "opt_state": self.trainer.optimizer.init(params),
                      "step": 0, "seed": ctx.seed, "best_metric": float("inf"),
                      "stale_evals": 0}
        self.pool = self.batches(t["pool"])
        m = cfg.model
        frames = 1 + (t["samples"] - 400) // 160
        steps = frames // 2 // 2
        self.traced_steps = ctx.cell.workload.get("traced_steps", 20)
        self.facts = {
            "utts_per_step": t["batch"],
            "flops_per_step": flops.train_step(flops.vgg_blstm_forward(
                frames, m.blstm_hidden, m.blstm_layers, m.vgg_channels,
                m.vocab_size), t["batch"]),
            "peak_key": "tf32",
            "k1": {"shape": (t["batch"], t["samples"]),
                   "frames": [frames] * t["batch"]},
            "k2": {"shape": (t["batch"], steps, 2 * t["tokens"] + 1)},
            # each K3 / K3b launch: one direction of one layer
            "k3": {"shape": (steps, t["batch"], m.blstm_hidden)},
        }

    def batches(self, n: int) -> list:
        t = self.traffic
        return inputs.batches(n, t["batch"], t["samples"], t["tokens"],
                              self.cfg.model.vocab_size, self.seed, self.dev)

    def first_grad_norms(self, opt_state) -> dict:
        """Step 1's clipped gradient g, from Adadelta's running mean of g^2
        after it: (1 - rho) g^2."""
        return {k: float((v.double() / 0.1).sum().sqrt())
                for k, v in opt_state["e_g"].items()}

    def reference_spec(self) -> dict:
        from benchmark.reference.training import Adadelta
        from benchmark.reference.vgg_blstm import VGGBLSTM

        m, o = self.conf["model"], self.conf["optimizer"]
        return {
            "kind": "supervised",
            "model": lambda p, prec: VGGBLSTM(p, layers=m["blstm_layers"],
                                              precision=prec),
            "optimizer": lambda: Adadelta(o["lr"], max_norm=o["grad_clip"]),
            "batches": self.batches,
            "kw": {"specaug": specaug_args(self.conf)},
        }

    def close(self):
        self.trainer.logger.close()
        self.trainer = self.state = self.pool = self.task = None
        self._dir.cleanup()


CELL = MonoCell


def run(ctx) -> dict:
    return training.run(ctx, CELL)
