"""End-to-end quality demonstration (counterpart of the reference's
``scripts/demo_meta_adaptation.py``): FOMAML over accent tasks against a
multitask baseline trained with the same budget, measured on a held-out
accent.

    python -m metaasr_tpu_torch.scripts.demo_meta_adaptation \
        [--steps 800] [--utts-per-accent 192] [--data-dir DIR] \
        [--workdir DIR] [--out RESULTS_demo.md] [--device cpu]

The corpus is the synthetic multi-accent set (``data/synthetic.py``, easy
profile, 8 accents), made in ``--data-dir`` unless it is there already (a
corpus there of another ``--utts-per-accent`` is refused); ``tango`` is
held out. ``--data-dir`` and ``--workdir`` default to directories under the
system's temporary directory (``$TMPDIR``, else ``/tmp``). Each arm trains
from scratch in ``<workdir>/<arm>``, so a workdir that already holds a
checkpoint of either arm is refused: the trainers would resume from it and
the table would report the old model with the seconds of no training.

The model is a small joint CTC-attention transformer (d 128, 4 heads,
4 + 2 layers, bf16 compute, SpecAugment). Both arms train ``--steps``
steps: FOMAML through ``MetaASRTrainer.meta_train`` (4 tasks of
8 + 8 utterances, 3 inner SGD steps at 0.03), the baseline through
``MultitaskASRTrainer.train`` (pooled batches of 32), both with Adam at a
constant 2e-3. Each arm is then scored on the held-out accent by a
``MetaASRTrainer`` (for the baseline, one built from a FOMAML copy of its
config): zero-shot greedy WER on the utterances from index 8 on, then
5-shot adaptation (``meta_adapt``, 5 inner steps) at support seeds 0 and 1,
each decoded greedily, seed 0 also with the joint beam search (beam 5), at
most 64 test utterances a decode.

It writes a markdown table and the raw JSON to ``--out``; the default,
``RESULTS_demo.md``, never overwrites the hand-curated ``RESULTS.md``.
Training runs on CUDA unless ``--device cpu`` is given: there K1 runs once
a training batch, twice a task of a meta-step, once an adaptation and once
a decode batch, and K2 once a training batch and once an inner step.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from metaasr_tpu_torch.config import Config

HELDOUT = "tango"
ARMS = ("fomaml", "multi")


def make_cfg(algo: str, steps: int) -> Config:
    cfg = Config()
    cfg.model.arch = "transformer"
    cfg.model.d_model = 128
    cfg.model.num_heads = 4
    cfg.model.d_ff = 512
    cfg.model.num_encoder_layers = 4
    cfg.model.num_decoder_layers = 2
    cfg.model.dropout = 0.1
    cfg.model.dtype = "bfloat16"
    cfg.specaug.enabled = True
    cfg.specaug.freq_mask_width = 15
    cfg.specaug.time_mask_width = 30
    cfg.meta.algo = algo
    cfg.meta.inner_lr = 0.03
    cfg.meta.inner_steps = 3
    cfg.meta.k_support = 8
    cfg.meta.k_query = 8
    cfg.meta.tasks_per_batch = 4
    cfg.meta.adapt_steps = 5
    cfg.data.max_frames = 400
    cfg.data.max_tokens = 32
    cfg.data.batch_size = 32
    cfg.optimizer.name = "adam"
    cfg.optimizer.lr = 2e-3
    cfg.optimizer.schedule = "constant"
    cfg.optimizer.grad_clip = 5.0
    cfg.train.max_steps = steps
    cfg.train.log_every = max(steps // 10, 1)
    cfg.train.eval_every = 10 ** 9
    cfg.train.ckpt_every = 10 ** 9
    cfg.train.beam_size = 5
    return cfg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=800)
    tmp = tempfile.gettempdir()
    ap.add_argument("--data-dir", default=os.path.join(tmp, "demo_synth"))
    ap.add_argument("--workdir", default=os.path.join(tmp, "demo_runs"))
    ap.add_argument("--out", default="RESULTS_demo.md")
    ap.add_argument("--utts-per-accent", type=int, default=192)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                    "PyTorch path)")
    return ap


def check_fresh(data_dir: str, utts_per_accent: int, workdir: str) -> None:
    """Refuse a corpus of another size and a workdir that holds a
    checkpoint of either arm (see the module's docstring)."""
    from metaasr_tpu_torch.train.checkpoint import CheckpointManager

    manifest = os.path.join(data_dir, f"{HELDOUT}.jsonl")
    if os.path.exists(manifest):
        with open(manifest) as f:
            n = sum(1 for line in f if line.strip())
        if n != utts_per_accent:
            raise SystemExit(f"{data_dir} holds {n} utterances an accent, "
                             f"not --utts-per-accent {utts_per_accent}: "
                             "give another --data-dir")
    for algo in ARMS:
        ckpts = os.path.join(workdir, algo, "ckpts")
        step = (CheckpointManager(ckpts).latest_step()
                if os.path.isdir(ckpts) else None)
        if step is not None:
            raise SystemExit(f"{ckpts} already holds step {step}: the demo "
                             "trains each arm from scratch; give an empty "
                             "--workdir")


def evaluate(meta_tr, params, ds, k_support: int) -> dict:
    """The demo's protocol on one held-out accent -> {"zero_shot_greedy",
    "adapt5_greedy_seed0", "adapt5_beam_seed0", "adapt5_greedy_seed1"}, each
    {"wer", "cer"}."""
    entry = {}
    zs_idx = list(range(len(ds)))[max(k_support, 8):]
    entry["zero_shot_greedy"] = meta_tr.decode(params, ds, zs_idx,
                                               max_utts=64)
    for seed in (0, 1):
        adapted, test_idx = meta_tr.meta_adapt(params, ds, adapt_steps=5,
                                               seed=seed)
        entry[f"adapt5_greedy_seed{seed}"] = meta_tr.decode(
            adapted, ds, test_idx, max_utts=64)
        if seed == 0:
            entry["adapt5_beam_seed0"] = meta_tr.decode(
                adapted, ds, test_idx, max_utts=64, mode="beam")
    return entry


def report(results: dict, steps: int) -> str:
    """The markdown table and the raw JSON, as the reference writes them."""
    lines = [
        "# RESULTS — held-out-accent k-shot adaptation (synthetic "
        "multi-accent set)",
        "",
        f"Setup: 7 training accents + held-out `{HELDOUT}`; transformer "
        "(d=128, 4 enc / 2 dec layers, joint CTC+attention); "
        f"{steps} train steps each; 5-shot adaptation with 3x inner "
        "SGD replayed 5 steps (meta.adapt_steps); WER/CER on up to 64 "
        "held-out test utterances. Data: synthetic accent-structured audio "
        "(metaasr_tpu_torch/data/synthetic.py); the PyTorch port.",
        "",
        "| trainer | zero-shot WER | 5-shot WER (s0) | 5-shot WER (s1) | "
        "5-shot beam WER | zero-shot CER | 5-shot CER (s0) |",
        "|---|---|---|---|---|---|---|",
    ]
    for algo in ARMS:
        e = results[algo]
        lines.append(
            f"| {algo} | {e['zero_shot_greedy']['wer']:.3f} "
            f"| {e['adapt5_greedy_seed0']['wer']:.3f} "
            f"| {e['adapt5_greedy_seed1']['wer']:.3f} "
            f"| {e['adapt5_beam_seed0']['wer']:.3f} "
            f"| {e['zero_shot_greedy']['cer']:.3f} "
            f"| {e['adapt5_greedy_seed0']['cer']:.3f} |")
    lines += ["", "Raw JSON:", "```json", json.dumps(results, indent=2),
              "```"]
    return "\n".join(lines) + "\n"


def main(argv=None) -> dict:
    from metaasr_tpu_torch.data.dataset import load_accent_datasets
    from metaasr_tpu_torch.data.synthetic import generate_dataset
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer
    from metaasr_tpu_torch.device import resolve_device
    from metaasr_tpu_torch.task import ASRTask
    from metaasr_tpu_torch.train.meta_train import MetaASRTrainer
    from metaasr_tpu_torch.train.mono import MultitaskASRTrainer

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    check_fresh(args.data_dir, args.utts_per_accent, args.workdir)
    if not os.path.exists(os.path.join(args.data_dir, f"{HELDOUT}.jsonl")):
        generate_dataset(args.data_dir, utts_per_accent=args.utts_per_accent,
                         words_per_utt=(2, 4), seed=0)
    tok = CharTokenizer.ascii_default()

    results = {}
    for algo in ARMS:
        cfg = make_cfg(algo, args.steps)
        cfg.model.vocab_size = tok.vocab_size
        dsets = load_accent_datasets(args.data_dir, tok)
        heldout = {HELDOUT: dsets.pop(HELDOUT)}
        task = ASRTask(cfg, tok.sos_eos_id, device=device)
        wd = os.path.join(args.workdir, algo)
        t0 = time.time()
        if algo == "multi":
            trainer = MultitaskASRTrainer(cfg, task, dsets, None, tok, wd,
                                          device=device)
            state = trainer.train(max_steps=args.steps)
            # the meta trainer's adaptation and decode on the same task
            cfg2 = make_cfg("fomaml", args.steps)
            cfg2.model.vocab_size = tok.vocab_size
            meta_tr = MetaASRTrainer(cfg2, task, dsets, heldout, tok,
                                     wd + "_eval", device=device)
        else:
            trainer = MetaASRTrainer(cfg, task, dsets, heldout, tok, wd,
                                     device=device)
            state = trainer.meta_train(max_steps=args.steps)
            meta_tr = trainer
        train_time = time.time() - t0

        entry = {"train_seconds": round(train_time, 1)}
        entry.update(evaluate(meta_tr, state["params"], heldout[HELDOUT],
                              cfg.meta.k_support))
        results[algo] = entry
        print(json.dumps({algo: entry}, indent=2), flush=True)

    with open(args.out, "w") as f:
        f.write(report(results, args.steps))
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
