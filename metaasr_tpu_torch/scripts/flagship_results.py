"""The flagship quality table (counterpart of the reference's
``scripts/flagship_results.py``): the flagship model trained as FOMAML,
full MAML, Reptile and a multitask baseline at one step budget, each
scored on the held-out accent by zero-shot WER (greedy and beam) and
5-shot-adapted WER over three support draws (mean and std), plus the
``--avg-last 5`` model-averaging row for FOMAML.

    python -m metaasr_tpu_torch.scripts.flagship_results \
        [--steps 1500] [--algos fomaml,maml,reptile,multi] \
        [--profile hard|easy|bpe] [--vocab char|bpe] [--learn-inner-lr] \
        [--eval-only] [--tiny] [--data-dir DIR] [--workdir DIR] \
        [--out flagship.json] [--device cpu]

Every flag of the reference is here, with its name, type, choices and
default; ``--data-dir``, ``--workdir`` and ``--out`` default to paths under
the system's temporary directory (``$TMPDIR``, else ``/tmp``), and
``--device`` (default CUDA, which raises without it; ``cpu`` runs the
plain PyTorch path) is added.

``make_cfg`` reads the repo's ``configs/config3_fomaml.yaml`` (d 256, 12 +
6 layers, bf16 compute, SpecAugment) with the reference's overrides, key
for key: the seed of both the parameters and the data stream, 4 s of audio
and 48 tokens, batches of 32, a checkpoint every eighth of the run (10
kept, for ``--avg-last 5``) and beam 5; ``meta.grad_dtype`` is float32
unless ``--grad-dtype bfloat16``. ``meta.algo`` stays ``fomaml`` for the
multitask arm.

The corpus is the port's synthetic set (``data/synthetic.py``), made with
seed 0 in ``--data-dir`` unless ``tango.jsonl`` is there already: the
``hard`` and ``bpe`` profiles over ``ACCENTS_HARD`` (16 accents, 3-6 words
an utterance), ``easy`` over the 8 default accents (2-4 words). ``tango``
is held out. ``--vocab bpe`` learns a BPE vocabulary from every accent's
transcripts (``--bpe-merges``) into ``<data-dir>/vocab_bpe.json``, or
loads it from there. Nothing is downloaded.

Each arm applies its overrides in the reference's order (``arm_config``),
trains in ``<workdir>/<profile>_<tag>`` (``arm_tag``: ``algo`` and then
``@seedN``, ``@bf16``, ``@conformer``, ``@metasgd``, ``@ilrX``,
``@iclipX``, ``@anil-a+b``, ``@istartN``, ``@widenN``, in that order; the
meta-only flags skip the multitask arm) and is scored by ``evaluate``;
``--out`` is rewritten after every arm, and ``main`` returns the results.

Behaviours of the reference that the port keeps (each changes the
numbers, so a port that "fixed" one would not compare with the
reference's tables):

(a) The multitask arm is scored through a ``MetaASRTrainer`` on a fresh
    ``make_cfg("fomaml", ...)`` with only ``vocab_size`` set, in
    ``<workdir>/<profile>_<tag>_eval``. The arm's ``--tiny``,
    ``--encoder``, ``--vocab``, ``--lr``, ``--tasks``, ``--k`` and
    ``--ctc-candidates`` overrides do not reach that evaluation config
    (its adaptation and decoding read 400 frames, beam 5 and config3's
    inner rate), though the model comes from the arm's shared task.
(b) ``--eval-only`` does not apply to the multitask arm, which trains
    anyway.
(c) Only ``algo == "fomaml"`` gets the averaged row
    (``adapt5_beam_avglast5``), with or without ``@metasgd``; a Meta-SGD
    tree {model, inner_lr} is averaged whole.
(d) A workdir that already holds checkpoints is resumed by both trainers
    (a run already at ``--steps`` trains nothing); ``--eval-only`` relies
    on it.

Launches on the card, from the code: a FOMAML or Meta-SGD step runs K1
2·M times and K2 M·(inner+1) times; a MAML step adds M·inner K2b; a
Reptile step runs K1 2·M and K2 M·inner (its inner steps take support and
query at once, and it takes no query backward); a multitask step one K1
and one K2; each ``meta_adapt`` one K1 and 5 K2; each decode batch (up to
32 utterances, greedy or beam) one K1.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

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


def apply_tiny(cfg: Config) -> None:
    """``--tiny``: the CPU tests' width. ``frontend.use_pallas`` is kept as
    the reference sets it; the port's front-end does not read it."""
    cfg.model.d_model, cfg.model.num_heads = 32, 2
    cfg.model.d_ff = 64
    cfg.model.num_encoder_layers = 2
    cfg.model.num_decoder_layers = 2
    cfg.model.dtype = "float32"
    cfg.frontend.use_pallas = False
    cfg.meta.tasks_per_batch = 2
    cfg.data.max_frames = 200


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    tmp = tempfile.gettempdir()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--data-dir", default=None,
                    help="corpus directory (default: flagship_synth_<profile> "
                         "under the temporary directory)")
    ap.add_argument("--workdir", default=os.path.join(tmp, "flagship_runs"))
    ap.add_argument("--out", default=os.path.join(tmp,
                                                  "flagship_results.json"))
    ap.add_argument("--utts-per-accent", type=int, default=192)
    ap.add_argument("--profile", choices=("easy", "hard", "bpe"),
                    default="hard",
                    help="bpe: hard acoustics + 700-word big_lexicon text "
                         "(for --vocab bpe large-vocab runs)")
    ap.add_argument("--algos", default="fomaml,multi",
                    help="comma list from fomaml,maml,reptile,multi")
    ap.add_argument("--grad-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="meta.grad_dtype (config3 ships bfloat16; this pins "
                         "float32 unless asked); results keyed algo@bf16 "
                         "when bfloat16")
    ap.add_argument("--seed", type=int, default=0,
                    help="training seed (train.seed, data.seed); results "
                         "keyed algo@seedN for N>0")
    ap.add_argument("--encoder", default="transformer",
                    choices=("transformer", "conformer"),
                    help="model.encoder; results keyed algo@conformer when "
                         "conformer")
    ap.add_argument("--lr", type=float, default=None,
                    help="optimizer.lr (Noam base) override")
    ap.add_argument("--inner-lr", type=float, default=None,
                    help="meta.inner_lr override; results keyed algo@ilrX")
    ap.add_argument("--inner-clip", type=float, default=None,
                    help="meta.inner_clip (global-norm clip on the inner SGD "
                         "gradient); results keyed algo@iclipX")
    ap.add_argument("--learn-inner-lr", action="store_true",
                    help="meta.learn_inner_lr (Meta-SGD: learned per-tensor "
                         "inner rates); results keyed algo@metasgd")
    ap.add_argument("--inner-start", type=int, default=None,
                    help="meta.inner_start_step (inner loop off until this "
                         "outer step); results keyed algo@istartN")
    ap.add_argument("--adapt-widen", type=int, default=None,
                    help="meta.adapt_widen_step (staged ANIL: leaves outside "
                         "--adapt-filter join the inner loop at this outer "
                         "step; requires --adapt-filter)")
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training; restore the workdir checkpoint and "
                         "run the evaluation (not for the multi arm)")
    ap.add_argument("--ctc-candidates", type=int, default=None,
                    help="train.ctc_candidates for beam decode (0 auto, -1 "
                         "force full-vocab)")
    ap.add_argument("--vocab", choices=("char", "bpe"), default="char",
                    help="bpe: a BPE tokenizer learned from the corpus "
                         "(--bpe-merges), the large-vocab decode path")
    ap.add_argument("--bpe-merges", type=int, default=520,
                    help="BPE merge count (vocab ~= base chars + merges)")
    ap.add_argument("--tasks", type=int, default=None,
                    help="meta.tasks_per_batch override")
    ap.add_argument("--k", type=int, default=None,
                    help="meta.k_support/k_query override (training-time "
                         "geometry; the 5-shot evaluation is unchanged)")
    ap.add_argument("--adapt-filter", default=None,
                    help="meta.adapt_filter (ANIL partial inner adaptation; "
                         "comma-separated param-path substrings, e.g. "
                         "'ctc_head,decoder'); results keyed algo@anil-X")
    ap.add_argument("--tiny", action="store_true",
                    help="debug: tiny model dims (CPU-runnable script check)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    return ap


def arm_config(args, algo: str, data_dir: str, vocab_size: int) -> Config:
    """The arm's config: ``make_cfg`` and the flags' overrides, in the
    reference's order, the meta-only ones skipping the multitask arm."""
    meta = algo != "multi"
    cfg = make_cfg(algo, args.steps, data_dir, seed=args.seed,
                   grad_dtype=args.grad_dtype)
    cfg.model.vocab_size = vocab_size
    cfg.data.vocab = args.vocab
    cfg.model.encoder = args.encoder
    if args.learn_inner_lr and meta:
        cfg.meta.learn_inner_lr = True
    if args.inner_lr is not None and meta:
        cfg.meta.inner_lr = args.inner_lr
    if args.inner_clip is not None and meta:
        cfg.meta.inner_clip = args.inner_clip
    if args.adapt_filter is not None and meta:
        cfg.meta.adapt_filter = args.adapt_filter
    if args.tasks is not None:
        cfg.meta.tasks_per_batch = args.tasks
    if args.k is not None:
        cfg.meta.k_support = cfg.meta.k_query = args.k
    if args.inner_start is not None and meta:
        cfg.meta.inner_start_step = args.inner_start
    if args.adapt_widen is not None and meta:
        cfg.meta.adapt_widen_step = args.adapt_widen
    if args.lr is not None:
        cfg.optimizer.lr = args.lr
    if args.ctc_candidates is not None:
        cfg.train.ctc_candidates = args.ctc_candidates
    if args.tiny:
        apply_tiny(cfg)
    return cfg


def arm_tag(args, algo: str) -> str:
    """The arm's key in the results and its workdir's suffix."""
    meta = algo != "multi"
    tag = algo if args.seed == 0 else f"{algo}@seed{args.seed}"
    if args.grad_dtype != "float32":
        tag += "@bf16"
    if args.encoder != "transformer":
        tag += f"@{args.encoder}"
    if args.learn_inner_lr and meta:
        tag += "@metasgd"
    if args.inner_lr is not None and meta:
        tag += f"@ilr{args.inner_lr:g}"
    if args.inner_clip is not None and meta:
        tag += f"@iclip{args.inner_clip:g}"
    if args.adapt_filter is not None and meta:
        tag += f"@anil-{args.adapt_filter.replace(',', '+')}"
    if args.inner_start is not None and meta:
        tag += f"@istart{args.inner_start}"
    if args.adapt_widen is not None and meta:
        tag += f"@widen{args.adapt_widen}"
    return tag


def _mean_std(vals) -> dict:
    return {"mean": round(float(np.mean(vals)), 4),
            "std": round(float(np.std(vals)), 4)}


def evaluate(meta_tr, params, ds, tag: str, results: dict,
             avg_params=None) -> None:
    """Score ``params`` on the held-out ``ds`` into ``results[tag]``:
    zero-shot greedy and beam on the utterances from index 8 on (all of
    them when there are 8 or fewer), then per seed of ``ADAPT_SEEDS`` a
    5-step adaptation and a greedy and a beam decode of the rest; with
    ``avg_params``, the beam row of the averaged weights too. At most 64
    utterances a decode."""
    zs_idx = list(range(len(ds)))
    zs_idx = zs_idx[8:] if len(zs_idx) > 8 else zs_idx
    entry = {}
    entry["zero_shot_greedy"] = meta_tr.decode(params, ds, zs_idx,
                                               max_utts=64)
    entry["zero_shot_beam"] = meta_tr.decode(params, ds, zs_idx,
                                             max_utts=64, mode="beam")
    g_wers, b_wers = [], []
    for seed in ADAPT_SEEDS:
        adapted, test_idx = meta_tr.meta_adapt(params, ds, adapt_steps=5,
                                               seed=seed)
        g_wers.append(meta_tr.decode(adapted, ds, test_idx,
                                     max_utts=64)["wer"])
        b_wers.append(meta_tr.decode(adapted, ds, test_idx, max_utts=64,
                                     mode="beam")["wer"])
    entry["adapt5_greedy"] = _mean_std(g_wers)
    entry["adapt5_beam"] = _mean_std(b_wers)
    entry["adapt5_beam_draws"] = [round(w, 4) for w in b_wers]
    if avg_params is not None:
        wers = []
        for seed in ADAPT_SEEDS:
            adapted, test_idx = meta_tr.meta_adapt(avg_params, ds,
                                                   adapt_steps=5, seed=seed)
            wers.append(meta_tr.decode(adapted, ds, test_idx, max_utts=64,
                                       mode="beam")["wer"])
        entry["adapt5_beam_avglast5"] = _mean_std(wers)
    results[tag] = entry
    print(json.dumps({tag: entry}, indent=2), flush=True)


def ensure_corpus(data_dir: str, profile: str, utts_per_accent: int) -> None:
    """The synthetic corpus of ``profile``, made unless the held-out
    accent's manifest is there."""
    from metaasr_tpu_torch.data.synthetic import (ACCENTS_HARD,
                                                  generate_dataset)

    if os.path.exists(os.path.join(data_dir, f"{HELDOUT}.jsonl")):
        return
    if profile in ("hard", "bpe"):
        generate_dataset(data_dir, accents=ACCENTS_HARD,
                         utts_per_accent=utts_per_accent,
                         words_per_utt=(3, 6), seed=0, profile=profile)
    else:
        generate_dataset(data_dir, utts_per_accent=utts_per_accent,
                         words_per_utt=(2, 4), seed=0)


def load_tokenizer(data_dir: str, vocab: str, bpe_merges: int):
    """``char``: the ASCII character set. ``bpe``: ``vocab_bpe.json`` in
    the corpus, learned from every accent's transcripts when missing."""
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer

    if vocab != "bpe":
        return CharTokenizer.ascii_default()
    from metaasr_tpu_torch.data.bpe import BPETokenizer
    from metaasr_tpu_torch.data.dataset import Manifest, discover_accents

    vocab_path = os.path.join(data_dir, "vocab_bpe.json")
    if os.path.exists(vocab_path):
        tok = BPETokenizer.load(vocab_path)
    else:
        texts = []
        for accent in discover_accents(data_dir):
            man = Manifest.load(os.path.join(data_dir, f"{accent}.jsonl"))
            texts.extend(u.text for u in man.utts)
        tok = BPETokenizer.from_corpus(texts, num_merges=bpe_merges)
        tok.save(vocab_path)
    print(json.dumps({"bpe_vocab_size": tok.vocab_size}), flush=True)
    return tok


def main(argv=None) -> dict:
    from metaasr_tpu_torch.data.dataset import load_accent_datasets
    from metaasr_tpu_torch.device import resolve_device
    from metaasr_tpu_torch.task import ASRTask
    from metaasr_tpu_torch.train.checkpoint import average_checkpoints
    from metaasr_tpu_torch.train.meta_train import MetaASRTrainer
    from metaasr_tpu_torch.train.mono import MultitaskASRTrainer

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    data_dir = args.data_dir or os.path.join(
        tempfile.gettempdir(), f"flagship_synth_{args.profile}")
    ensure_corpus(data_dir, args.profile, args.utts_per_accent)
    tok = load_tokenizer(data_dir, args.vocab, args.bpe_merges)

    results = {"profile": args.profile, "steps": args.steps,
               "vocab": args.vocab, "vocab_size": tok.vocab_size}
    for algo in args.algos.split(","):
        cfg = arm_config(args, algo, data_dir, tok.vocab_size)
        dsets = load_accent_datasets(data_dir, tok, vocab=args.vocab)
        heldout = {HELDOUT: dsets.pop(HELDOUT)}
        task = ASRTask(cfg, tok.sos_eos_id, device=device)
        tag = arm_tag(args, algo)
        wd = os.path.join(args.workdir, f"{args.profile}_{tag}")
        t0 = time.time()
        avg_params = None
        if algo == "multi":
            trainer = MultitaskASRTrainer(cfg, task, dsets, None, tok, wd,
                                          device=device)
            state = trainer.train(max_steps=args.steps)
            # (a): the evaluation config is a fresh recipe, vocab only
            cfg2 = make_cfg("fomaml", args.steps, data_dir, seed=args.seed,
                            grad_dtype=args.grad_dtype)
            cfg2.model.vocab_size = tok.vocab_size
            meta_tr = MetaASRTrainer(cfg2, task, dsets, heldout, tok,
                                     wd + "_eval", device=device)
        elif args.eval_only:
            meta_tr = MetaASRTrainer(cfg, task, dsets, heldout, tok, wd,
                                     device=device)
            state, step = meta_tr.ckpt.restore(map_location=device)
            if step < 0:
                raise SystemExit(f"--eval-only: no checkpoint under {wd}")
            print(f"[{algo}] eval-only from step {step}", flush=True)
        else:
            meta_tr = MetaASRTrainer(cfg, task, dsets, heldout, tok, wd,
                                     device=device)
            state = meta_tr.meta_train(max_steps=args.steps)
            if algo == "fomaml":
                avg_params = average_checkpoints(meta_tr.ckpt, last_n=5,
                                                 map_location=device)
        train_s = round(time.time() - t0, 1)
        print(f"[{algo}] trained {args.steps} steps in {train_s}s",
              flush=True)
        evaluate(meta_tr, state["params"], heldout[HELDOUT], tag, results,
                 avg_params=avg_params)
        results[tag]["train_seconds"] = train_s
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
