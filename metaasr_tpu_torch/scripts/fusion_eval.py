"""Shallow-fusion quality sweep on the hard synthetic benchmark
(counterpart of the reference's ``scripts/fusion_eval.py``).

Question: does an external LSTM LM, trained on the training accents'
transcripts (the held-out accent excluded), lower the held-out accent's
WER when fused into the joint CTC-attention beam, and at what weight?

Design: one flagship of ``--algo`` is trained (the multitask baseline by
default: it has WER headroom on the hard profile, where the meta models sit
near the floor) and decoded under each ``lm_weight``. The draws are
paired: adaptation does not read the LM, so each support seed adapts once
and every weight decodes the same adapted parameters on the same test
split. Differences between weights are the LM's alone.

    python -m metaasr_tpu_torch.scripts.fusion_eval [--steps 1500] \
        [--weights 0,0.1,0.2,0.3,0.5] [--algo multi|fomaml|reptile] \
        [--lm-steps 1500] [--seed 0] [--tiny] [--data-dir DIR] \
        [--workdir DIR] [--out fusion.json] [--device cpu]

Every flag of the reference is here, with its name, type, choices and
default; ``--data-dir``, ``--workdir`` and ``--out`` default to paths under
the system's temporary directory (``$TMPDIR``, else ``/tmp``), and
``--device`` (default CUDA, which raises without it; ``cpu`` runs the plain
PyTorch path) is added. The corpus is ``flagship_results``' hard profile
(16 accents x 192 utterances, seed 0), made in ``--data-dir`` unless
``tango.jsonl`` is there already.

The steps, each a function: ``lm_corpus`` (every accent's transcripts but
``tango``'s), ``train_fusion_lm`` (2 x 192 LSTM LM, embedding 64, batch 64,
``--lm-steps`` Adam steps on the resolved device, written as
``<data-dir>/fusion_lm.npz`` in the Flax layout both packages read),
``arm_configs`` (the flagship recipe and the reference's ``--tiny`` block,
which keeps config3's bf16 compute), ``train_arm`` and ``sweep`` (zero-shot
on the held-out utterances from index 8 on and 5-step adaptations for
support seeds 0, 1, 2, beam decodes of at most 64 utterances; one JSON line
per weight and ``--out`` rewritten after each). ``main`` returns the
results.

The multitask arm is scored through a ``MetaASRTrainer`` on a fresh
``make_cfg("fomaml", ...)`` with only ``vocab_size`` set (under ``--tiny``
it shares the arm's model config), in ``<workdir>/hard_multi_s<seed>_eval``,
as the reference does (``ROADMAP.md`` §3, flagship behaviour (a)).

Launches on the card, from the code: the LM's training K3 and K3b
``layers`` times a step each (2 x ``--lm-steps``); the fused search none
(its LM step is plain PyTorch). The arm's training, each adaptation (1 K1,
5 K2) and each decode batch (1 K1, up to 32 utterances) launch what
``flagship_results``' docstring lists.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.scripts.flagship_results import (
    ADAPT_SEEDS,
    HELDOUT,
    ensure_corpus,
    make_cfg,
)

UTTS_PER_ACCENT = 192


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    tmp = tempfile.gettempdir()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--data-dir",
                    default=os.path.join(tmp, "flagship_synth_hard"))
    ap.add_argument("--workdir", default=os.path.join(tmp, "fusion_runs"))
    ap.add_argument("--out", default=None,
                    help="default fusion_sweep_<algo>_s<seed>.json under the "
                         "temporary directory (seed-suffixed so sweeps don't "
                         "clobber each other)")
    ap.add_argument("--algo", default="multi", choices=("multi", "fomaml",
                                                        "reptile"))
    ap.add_argument("--weights", default="0,0.1,0.2,0.3,0.5")
    ap.add_argument("--lm-steps", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=0,
                    help="training+data seed (seed-stability of the gain)")
    ap.add_argument("--tiny", action="store_true",
                    help="debug: tiny dims (CPU-runnable script check)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    return ap


def lm_corpus(data_dir: str) -> list[str]:
    """The training accents' transcripts, accent by accent, ``HELDOUT``'s
    left out."""
    from metaasr_tpu_torch.scripts.train_lm import lm_corpus as corpus

    return corpus(data_dir, (HELDOUT,))


def train_fusion_lm(texts, tok, lm_steps: int, tiny: bool, data_dir: str,
                    device) -> tuple[str, float]:
    """The reference's LM recipe (embedding 64, 2 x 192, batch 64; 16, 1 x
    16 under ``--tiny``) trained on ``device`` and written to
    ``<data_dir>/fusion_lm.npz`` -> (path, final NLL)."""
    from metaasr_tpu_torch.models import lm
    from metaasr_tpu_torch.train.checkpoint import save_tree_npz
    from metaasr_tpu_torch.weights import lm_state_dict_to_flax

    t0 = time.time()
    _, lm_params, lm_nll = lm.train_char_lm(
        texts, tok, embed_dim=64 if not tiny else 16,
        hidden=192 if not tiny else 16, layers=2 if not tiny else 1,
        steps=lm_steps, batch_size=64, log_every=lm_steps // 5,
        device=device)
    lm_path = os.path.join(data_dir, "fusion_lm.npz")
    save_tree_npz(lm_path, lm_state_dict_to_flax(lm_params))
    print(f"LM: {len(texts)} transcripts, final nll {lm_nll:.3f} "
          f"({time.time() - t0:.0f}s)", flush=True)
    return lm_path, lm_nll


def arm_configs(args, data_dir: str,
                vocab_size: int) -> tuple[Config, Config | None]:
    """(the arm's config, the multitask arm's evaluation config or None),
    as the reference builds them. ``--tiny`` does not touch
    ``model.dtype``: config3's bfloat16 stays."""
    cfg = make_cfg(args.algo, args.steps, data_dir, seed=args.seed)
    cfg.model.vocab_size = vocab_size
    if args.tiny:
        cfg.model.d_model, cfg.model.num_heads = 32, 2
        cfg.model.d_ff = 64
        cfg.model.num_encoder_layers = 2
        cfg.model.num_decoder_layers = 2
        cfg.frontend.use_pallas = False
        cfg.meta.tasks_per_batch = 2
        cfg.data.max_frames = 200
    if args.algo != "multi":
        return cfg, None
    cfg2 = make_cfg("fomaml", args.steps, data_dir, seed=args.seed)
    cfg2.model.vocab_size = vocab_size
    if args.tiny:
        cfg2.model = cfg.model
        cfg2.meta.tasks_per_batch = 2
        cfg2.data.max_frames = 200
        cfg2.frontend.use_pallas = False
    return cfg, cfg2


def train_arm(args, cfg: Config, cfg2: Config | None, tok, data_dir: str,
              device):
    """Train the arm in ``<workdir>/hard_<algo>_s<seed>`` -> (the trainer
    that adapts and decodes, the trained parameters, the held-out
    dataset)."""
    from metaasr_tpu_torch.data.dataset import load_accent_datasets
    from metaasr_tpu_torch.task import ASRTask
    from metaasr_tpu_torch.train.meta_train import MetaASRTrainer
    from metaasr_tpu_torch.train.mono import MultitaskASRTrainer

    dsets = load_accent_datasets(data_dir, tok)
    heldout = {HELDOUT: dsets.pop(HELDOUT)}
    task = ASRTask(cfg, tok.sos_eos_id, device=device)
    wd = os.path.join(args.workdir, f"hard_{args.algo}_s{args.seed}")
    t0 = time.time()
    if args.algo == "multi":
        trainer = MultitaskASRTrainer(cfg, task, dsets, None, tok, wd,
                                      device=device)
        state = trainer.train(max_steps=args.steps)
        meta_tr = MetaASRTrainer(cfg2, task, dsets, heldout, tok,
                                 wd + "_eval", device=device)
    else:
        meta_tr = MetaASRTrainer(cfg, task, dsets, heldout, tok, wd,
                                 device=device)
        state = meta_tr.meta_train(max_steps=args.steps)
    print(f"[{args.algo}] trained {args.steps} steps in "
          f"{time.time() - t0:.0f}s", flush=True)
    return meta_tr, state["params"], heldout[HELDOUT]


def sweep(meta_tr, params, ds, lm_path: str, weights, results: dict,
          out: str) -> dict:
    """The paired sweep into ``results["weights"]``: one adaptation per
    support seed, then per weight a zero-shot beam decode of ``ds[8:]``
    and a beam decode of each seed's adapted parameters on its test
    split, all with ``train.lm_ckpt = lm_path``. At weight 0 the search is
    the search without an LM. Prints one JSON line and rewrites ``out``
    per weight."""
    meta_tr.cfg.train.lm_ckpt = lm_path
    zs_idx = list(range(len(ds)))
    zs_idx = zs_idx[8:] if len(zs_idx) > 8 else zs_idx
    adapted_by_seed = {seed: meta_tr.meta_adapt(params, ds, adapt_steps=5,
                                                seed=seed)
                       for seed in ADAPT_SEEDS}
    for w in weights:
        meta_tr.cfg.train.lm_weight = w
        zs = meta_tr.decode(params, ds, zs_idx, max_utts=64, mode="beam")
        draws = []
        for seed in ADAPT_SEEDS:
            adapted, test_idx = adapted_by_seed[seed]
            draws.append(meta_tr.decode(adapted, ds, test_idx, max_utts=64,
                                        mode="beam")["wer"])
        results["weights"][str(w)] = {
            "zero_shot_beam_wer": round(zs["wer"], 4),
            "adapt5_beam": {"mean": round(float(np.mean(draws)), 4),
                            "std": round(float(np.std(draws)), 4)},
            "adapt5_beam_draws": [round(d, 4) for d in draws],
        }
        print(json.dumps({str(w): results["weights"][str(w)]}), flush=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=2)
    return results


def main(argv=None) -> dict:
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer
    from metaasr_tpu_torch.device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    out = args.out or os.path.join(
        tempfile.gettempdir(), f"fusion_sweep_{args.algo}_s{args.seed}.json")
    ensure_corpus(args.data_dir, "hard", UTTS_PER_ACCENT)
    tok = CharTokenizer.ascii_default()
    weights = [float(w) for w in args.weights.split(",")]

    texts = lm_corpus(args.data_dir)
    lm_path, lm_nll = train_fusion_lm(texts, tok, args.lm_steps, args.tiny,
                                      args.data_dir, device)
    cfg, cfg2 = arm_configs(args, args.data_dir, tok.vocab_size)
    meta_tr, params, ds = train_arm(args, cfg, cfg2, tok, args.data_dir,
                                    device)
    results = {"algo": args.algo, "steps": args.steps, "seed": args.seed,
               "lm_nll": lm_nll, "weights": {}}
    sweep(meta_tr, params, ds, lm_path, weights, results, out)
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    main()
