"""Checkpoints on ``torch.save`` (counterpart of
``metaasr_tpu/train/checkpoint.py``, which uses orbax).

The same policy: the whole train state (parameters, optimizer state, step,
seed, best metric) is saved per step as ``step_<N>.pt``, the newest ``keep``
are kept, and ``best/state.pt`` holds the best-by-metric state; evaluation
metrics given to ``save`` go beside it as ``step_<N>.metrics.json``
(``best/metrics.json``). Writes go to
a temporary file first and are renamed into place, so a reader never sees
half a file. ``average_checkpoints`` averages the saved parameters of
several steps (``--avg-last``). ``save_params_npz``/``load_params_npz``
exchange parameters in the reference's flat Flax layout
(``weights.params_to_flax``), the format ``--serve-params`` reads;
``save_tree_npz`` writes any Flax-layout tree as it is (the shallow-fusion
LM's, as the reference's ``save_params_npz`` does).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

from metaasr_tpu_torch.utils.tree import flatten, unflatten_like
from metaasr_tpu_torch.weights import flatten_tree, params_to_flax, unflatten

_STEP = re.compile(r"step_(\d+)\.pt$")


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _atomic_json(obj: dict, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({k: float(v) for k, v in obj.items()}, f)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.keep = keep
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._best = os.path.join(self.ckpt_dir, "best", "state.pt")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.ckpt_dir)
                      if (m := _STEP.match(f)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"step_{step}.pt")

    def _metrics_path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"step_{step}.metrics.json")

    def save(self, step: int, state: Any, metrics: dict | None = None,
             is_best: bool = False) -> None:
        _atomic_save(state, self._path(step))
        if metrics is not None:
            _atomic_json(metrics, self._metrics_path(step))
        if is_best:
            os.makedirs(os.path.dirname(self._best), exist_ok=True)
            _atomic_save(state, self._best)
            if metrics is not None:
                _atomic_json(metrics, os.path.join(
                    os.path.dirname(self._best), "metrics.json"))
        for old in self.all_steps()[:-self.keep] if self.keep > 0 else []:
            os.remove(self._path(old))
            if os.path.exists(self._metrics_path(old)):
                os.remove(self._metrics_path(old))

    def restore(self, state_template: Any = None, step: int | None = None,
                map_location=None) -> tuple[Any, int]:
        """The latest (or a given step's) state -> (state, step);
        (template, -1) when nothing is saved. Tensors land on
        ``map_location`` (default: where they were saved)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state_template, -1
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True), step

    def restore_best(self, map_location=None) -> Any:
        if not os.path.exists(self._best):
            return None
        return torch.load(self._best, map_location=map_location,
                          weights_only=True)


def average_checkpoints(mgr: CheckpointManager, steps: list[int] | None = None,
                        last_n: int = 0, map_location=None) -> Any:
    """The mean of the ``params`` of the saved steps ``steps`` (default: the
    last ``last_n``, or every saved step when 0), summed in float64 and cast
    to float32, on ``map_location`` (default the CPU); the tree keeps its
    structure (a Meta-SGD tree {"model", "inner_lr"} is averaged whole).
    Reads what is on disk: with fewer than ``last_n`` steps kept, it
    averages those there are."""
    avail = mgr.all_steps()
    if steps is None:
        steps = avail[-last_n:] if last_n else avail
    if not steps:
        raise ValueError(f"no checkpoints to average under {mgr.ckpt_dir}")
    acc = None
    for step in steps:
        state, _ = mgr.restore(step=step, map_location="cpu")
        flat = {k: v.to(torch.float64)
                for k, v in flatten(state["params"]).items()}
        acc = flat if acc is None else {k: acc[k] + v
                                        for k, v in flat.items()}
    return unflatten_like(state["params"], {
        k: (v / len(steps)).to(torch.float32).to(map_location or "cpu")
        for k, v in acc.items()})


def save_tree_npz(path: str, tree: dict) -> None:
    """Flat ``a/b/c`` npz of a nested Flax-layout tree of arrays, readable
    by both packages' ``load_params_npz``."""
    np.savez(path, **flatten_tree(tree))


def save_params_npz(path: str, params: dict, num_heads: int) -> None:
    """Flat ``a/b/c`` npz in the reference's Flax layout (plain or Meta-SGD
    tree), readable by both packages' ``load_params_npz`` and by
    ``--serve-params``."""
    save_tree_npz(path, params_to_flax(params, num_heads))


def load_params_npz(path: str) -> dict:
    """Inverse of :func:`save_params_npz`: the nested Flax-layout dict of
    numpy arrays (``weights.flax_to_params`` makes tensors of it)."""
    with np.load(path) as z:
        return unflatten({k: np.asarray(z[k]) for k in z.files})
