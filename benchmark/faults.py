"""Faults planted in the program's timed path, to show that the comparison
catches them: each patches a method of the program's class for the life of
a ``with plant(name):`` block.

- ``unchanged``: a training step that returns its state unchanged.
- ``half_batch``: a training step that leaves out the second half of its
  batch's rows and takes the mean over the rest.
- ``altered_token``: a served answer whose best hypothesis has its first
  symbol replaced where the read-back produces it.
- ``no_exchange``: a data-parallel meta-step whose all-reduce of the outer
  gradient is left out: each rank updates from its own tasks.

A block also names its fault in ``BENCHMARK_FAULT`` for the processes it
starts (the ranks of ``jobs/meta_train_dp.py`` plant it themselves).
"""

from __future__ import annotations

import contextlib
import os


def _trainers():
    from metaasr_tpu_torch.train.meta_train import MetaASRTrainer
    from metaasr_tpu_torch.train.mono import MonoASRTrainer

    return MetaASRTrainer, MonoASRTrainer


def _halve(batch: dict) -> dict:
    """The first half of each batch's rows (of each task's, for a
    meta-batch)."""
    if "support" in batch:
        return {part: {k: v[:, : v.shape[1] // 2] for k, v in rows.items()}
                for part, rows in batch.items()}
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def _unchanged(step):
    def broken(self, state, batch):
        _, metrics = step(self, state, batch)
        return state, metrics
    return broken


def _half_batch(step):
    def broken(self, state, batch):
        return step(self, state, _halve(batch))
    return broken


def _altered(read):
    def broken(self, out, n, nbest):
        results = read(self, out, n, nbest)
        for r in results:
            best = r["nbest"][0] if "nbest" in r else r
            hyp = best["hyp"] if "hyp" in best else best["text"]
            swap = "b" if hyp[:1] == "a" else "a"
            if "hyp" in best:
                best["hyp"] = swap + hyp[1:]
            r["text"] = swap + r["text"][1:]
        return results
    return broken


def _no_exchange(reduce_outer):
    def broken(acc, per_task, group, data_size=1):
        return acc, per_task
    return broken


def _targets(name: str):
    if name == "no_exchange":
        from metaasr_tpu_torch.meta import maml

        return [(maml, "reduce_outer", _no_exchange)]
    if name == "altered_token":
        from metaasr_tpu_torch.serve.export import ServingDecoder

        return [(ServingDecoder, "_read", _altered)]
    wrap = {"unchanged": _unchanged, "half_batch": _half_batch}[name]
    return [(cls, "step", wrap) for cls in _trainers()]


@contextlib.contextmanager
def plant(name: str):
    saved = []
    for cls, attr, wrap in _targets(name):
        saved.append((cls, attr, getattr(cls, attr)))
        setattr(cls, attr, wrap(getattr(cls, attr)))
    before = os.environ.get("BENCHMARK_FAULT")
    os.environ["BENCHMARK_FAULT"] = name
    try:
        yield
    finally:
        for cls, attr, original in saved:
            setattr(cls, attr, original)
        if before is None:
            del os.environ["BENCHMARK_FAULT"]
        else:
            os.environ["BENCHMARK_FAULT"] = before


FAULTS = ("unchanged", "half_batch", "altered_token", "no_exchange")
