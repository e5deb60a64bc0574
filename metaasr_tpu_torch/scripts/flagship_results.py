"""The flagship quality recipe (counterpart of the reference's
``scripts/flagship_results.py``): the held-out accent, the support draws
and the training config that the quality scripts share.

``make_cfg`` reads the repo's ``configs/config3_fomaml.yaml`` (d 256, 12 +
6 layers, bf16, SpecAugment) with the reference's overrides, key for key:
the seed of both the parameters and the data stream, 4 s of audio and 48
tokens, batches of 32, a checkpoint every eighth of the run (10 kept, for
``--avg-last 5``) and beam 5. ``meta.algo`` stays ``fomaml`` for the
multitask arm: the caller picks the trainer (``MultitaskASRTrainer``) and
evaluates through a ``MetaASRTrainer``.

``scripts/kshot_curve.py`` restores checkpoints trained under this recipe.
The script's own ``main`` (the four training arms, ``evaluate`` and
``--avg-last``) comes with the next part of the port.
"""

from __future__ import annotations

import os

from metaasr_tpu_torch.config import Config, load_config

HELDOUT = "tango"
ADAPT_SEEDS = (0, 1, 2)
CFG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "configs", "config3_fomaml.yaml")


def make_cfg(algo: str, steps: int, data_dir: str, seed: int = 0,
             grad_dtype: str = "float32") -> Config:
    return load_config(CFG, {
        "meta.grad_dtype": grad_dtype,
        "train.seed": seed,       # parameter init + dropout/SpecAugment
        "data.seed": seed,        # task and batch sampling
        "meta.algo": algo if algo != "multi" else "fomaml",
        "data.data_dir": data_dir,
        "data.heldout_accents": HELDOUT,
        "data.max_frames": 400,
        "data.max_tokens": 48,
        "data.batch_size": 32,
        "train.max_steps": steps,
        "train.log_every": max(steps // 10, 1),
        "train.eval_every": 10 ** 9,
        # >= 6 checkpoints kept for the --avg-last 5 ablation
        "train.ckpt_every": max(steps // 8, 1),
        "train.keep_ckpts": 10,
        "train.beam_size": 5,
    })
