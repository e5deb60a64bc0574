"""Command line for the port (counterpart of ``metaasr_tpu/cli.py``):

    python -m metaasr_tpu_torch.cli --mode train \
        --config configs/config3_fomaml.yaml --data-dir DIR --workdir WD \
        [--algo no|multi|fomaml|maml|reptile] [--max-steps N] [--seed N]
        [-o key=value]

    python -m metaasr_tpu_torch.cli --mode serve --bundle DIR \
        --config configs/config3_fomaml.yaml --wav a.wav [b.wav ...]

``train`` trains on the accents of ``--data-dir`` (``<accent>.jsonl``
manifests, e.g. from ``data.synthetic.generate_dataset``), checkpointing
under ``<workdir>/ckpts``: meta-training for the algos fomaml, maml (full
second order, e.g. ``configs/config4_maml.yaml``) and reptile, the
single-accent baseline for ``no`` (e.g. ``configs/
config1_mono_vgg_ctc.yaml``, the VGG-BLSTM CTC phone recognizer) and pooled
multi-accent training for ``multi``, both with periodic dev evaluation
(``train.eval_every``, ``data.dev_fraction``). ``serve`` transcribes with a
bundle the JAX package exported (``--mode export``) or
``serve.export.write_bundle`` wrote;
``--config`` supplies what the bundle does not record (model dims and dtype,
CMVN mode, beam options). Both run on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

from metaasr_tpu_torch.config import Config, load_config, save_config


def _parse_override(kv: str):
    key, val = kv.split("=", 1)
    for cast in (int, float):
        try:
            return key, cast(val)
        except ValueError:
            pass
    if val.lower() in ("true", "false"):
        return key, val.lower() == "true"
    return key, val


def _corpus_texts(data_dir: str, field: str) -> list[str]:
    from metaasr_tpu_torch.data.dataset import Manifest, discover_accents

    texts = []
    for accent in discover_accents(data_dir):
        man = Manifest.load(os.path.join(data_dir, f"{accent}.jsonl"))
        texts.extend(getattr(u, field) for u in man.utts)
    return texts


def build_tokenizer(cfg: Config):
    """The vocabulary of ``data.vocab``: the ASCII char set, or the phone set
    loaded from ``<data_dir>/vocab_phone.json`` when present, else built from
    the manifests' phone transcripts (ARPAbet when they carry none) and
    saved there. The BPE vocabulary is not ported yet (ROADMAP.md)."""
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer, PhoneTokenizer

    kind = cfg.data.vocab
    if kind == "char":
        return CharTokenizer.ascii_default()
    if kind == "phone":
        vocab_path = os.path.join(cfg.data.data_dir, "vocab_phone.json")
        if os.path.exists(vocab_path):
            return PhoneTokenizer.load(vocab_path)
        tok = PhoneTokenizer.from_corpus(
            _corpus_texts(cfg.data.data_dir, "phones"))
        if len(tok.symbols) == 0:   # the manifests carry no phone field
            tok = PhoneTokenizer.arpabet_default()
        tok.save(vocab_path)
        return tok
    if kind == "bpe":
        raise NotImplementedError(
            "the BPE vocabulary (data.vocab: bpe) is not ported yet "
            "(ROADMAP.md, port queue)")
    raise ValueError(f"unknown vocab type {kind}")


def make_trainer(cfg: Config, workdir: str, device=None):
    """(trainer, tokenizer) for the configured algo: ``MonoASRTrainer``
    (no), ``MultitaskASRTrainer`` (multi) or ``MetaASRTrainer`` (fomaml,
    maml, reptile). Held-out accents (``data.heldout_accents``) are kept out of
    the training pool; the baselines evaluate on a per-accent dev split
    (``data.dev_fraction``) or, without one, on the first held-out accent."""
    from metaasr_tpu_torch.data.dataset import load_accent_datasets
    from metaasr_tpu_torch.task import ASRTask
    from metaasr_tpu_torch.train.meta_train import MetaASRTrainer
    from metaasr_tpu_torch.train.mono import (
        MonoASRTrainer,
        MultitaskASRTrainer,
    )

    algo = cfg.meta.algo
    if algo not in ("no", "multi", "fomaml", "maml", "reptile"):
        raise ValueError(f"unknown algo {algo}")
    tok = build_tokenizer(cfg)
    cfg.model.vocab_size = tok.vocab_size
    spk_path = ""
    if cfg.frontend.cmvn == "speaker":
        spk_path = (cfg.frontend.cmvn_stats_path
                    or os.path.join(cfg.data.data_dir, "speaker_cmvn.json"))
    load = lambda accents: load_accent_datasets(  # noqa: E731
        cfg.data.data_dir, tok, accents=accents, vocab=cfg.data.vocab,
        sample_rate=cfg.frontend.sample_rate, speaker_cmvn_path=spk_path,
        cache_audio=cfg.data.cache_audio)
    dsets = load(cfg.data.accents)
    heldout = {}
    for name in cfg.data.heldout_accents:
        heldout[name] = (dsets.pop(name) if name in dsets
                         else load((name,))[name])
    task = ASRTask(cfg, tok.sos_eos_id, device=device)
    if algo in ("fomaml", "maml", "reptile"):
        return MetaASRTrainer(cfg, task, dsets, heldout, tok, workdir,
                              device=device), tok
    dev = next(iter(heldout.values())) if heldout else None
    if cfg.data.dev_fraction > 0:
        # per-accent train/dev partition; the first accent's dev set scores
        devs = {}
        for name in list(dsets):
            dsets[name], devs[name] = dsets[name].split(
                cfg.data.dev_fraction, seed=cfg.data.seed)
        dev = next(iter(devs.values())) if devs else dev
    if algo == "no":
        train_sets = [dsets[a] for a in (cfg.data.accents or sorted(dsets))][:1]
        trainer = MonoASRTrainer(cfg, task, train_sets, dev, tok, workdir,
                                 device=device)
    else:
        trainer = MultitaskASRTrainer(cfg, task, dsets, dev, tok, workdir,
                                      device=device)
    # the baselines are tested on the same held-out accents as the meta runs
    trainer.heldout_datasets = heldout
    return trainer, tok


def main(argv=None):
    p = argparse.ArgumentParser("metaasr_tpu_torch")
    p.add_argument("--mode", choices=["train", "serve"], default="serve")
    p.add_argument("--config", type=str, default=None,
                   help="the run's YAML config (train: <workdir>/config.yaml "
                   "when it exists, else Config())")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "PyTorch path)")
    p.add_argument("-o", "--override", action="append", default=[],
                   help="dotted config override key=value")
    t = p.add_argument_group("train")
    t.add_argument("--algo",
                   choices=["no", "multi", "fomaml", "maml", "reptile"],
                   default=None)
    t.add_argument("--workdir", type=str, default="runs/default")
    t.add_argument("--data-dir", type=str, default=None)
    t.add_argument("--max-steps", type=int, default=None)
    t.add_argument("--seed", type=int, default=None)
    s = p.add_argument_group("serve")
    s.add_argument("--bundle", type=str, help="serving bundle directory")
    s.add_argument("--wav", nargs="+", help="WAV files to transcribe")
    s.add_argument("--serve-params", type=str, default=None,
                   help="hot-swap an adapted params npz (flat a/b/c keys, "
                   "Flax layout)")
    s.add_argument("--serve-out", type=str, default=None,
                   help="also write one JSONL record per file here")
    s.add_argument("--dump-nbest", type=int, default=1,
                   help="hypotheses (with scores) per utterance")
    args = p.parse_args(argv)

    overrides = dict(_parse_override(kv) for kv in args.override)
    if args.mode == "train":
        return _train(args, overrides)
    if not args.bundle or not args.wav:
        p.error("--mode serve needs --bundle DIR and --wav FILE [FILE ...]")
    from metaasr_tpu_torch.serve.export import ServingDecoder, load_bundle_params

    cfg = load_config(args.config, overrides)
    dec = ServingDecoder(args.bundle, cfg, device=args.device)
    params = (load_bundle_params(args.serve_params)
              if args.serve_params else None)
    results = dec.transcribe_files(args.wav, params=params,
                                   nbest=args.dump_nbest)
    lines = [json.dumps({"file": path, **r})
             for path, r in zip(args.wav, results)]
    for line in lines:
        print(line)
    if args.serve_out:
        with open(args.serve_out, "w") as f:
            f.writelines(line + "\n" for line in lines)
    return 0


def _train(args, overrides: dict) -> int:
    # a resumed run defaults to its own recorded config, as the reference
    # does: Config() defaults saved over <workdir>/config.yaml would resume
    # the checkpoint under another model
    recorded = os.path.join(args.workdir, "config.yaml")
    if args.config is None and os.path.exists(recorded):
        args.config = recorded
    if args.algo:
        overrides["meta.algo"] = args.algo
    if args.seed is not None:
        overrides["train.seed"] = args.seed
        overrides["data.seed"] = args.seed
    if args.data_dir:
        overrides["data.data_dir"] = args.data_dir
    cfg = load_config(args.config, overrides)
    os.makedirs(args.workdir, exist_ok=True)
    save_config(cfg, os.path.join(args.workdir, "config.yaml"))
    trainer, _ = make_trainer(cfg, args.workdir, device=args.device)
    # --max-steps bounds this invocation; the recorded config keeps its own
    if cfg.meta.algo in ("no", "multi"):
        state = trainer.train(max_steps=args.max_steps)
    else:
        state = trainer.meta_train(max_steps=args.max_steps)
    print(json.dumps({"workdir": args.workdir, "step": state["step"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
