"""Command line for the port (counterpart of ``metaasr_tpu/cli.py``):

    python -m metaasr_tpu_torch.cli [--mode train] \
        --config configs/config3_fomaml.yaml --data-dir DIR --workdir WD \
        [--algo no|multi|fomaml|maml|reptile] [--max-steps N] [--seed N]
        [-o key=value]
    python -m metaasr_tpu_torch.cli --mode adapt|test|transcribe --workdir WD \
        [--use-best | --avg-last N] [--decode-mode greedy|beam]
        [--dump-nbest K] [--lm-ckpt LM.npz --lm-weight W]
    python -m metaasr_tpu_torch.cli --mode export --workdir WD \
        [--export-dir DIR] [--export-buckets 8x48000,...]
        [--export-weights-dtype float32|bfloat16]
        [--export-decode auto|beam|greedy] [--lm-ckpt LM.npz --lm-weight W]
    python -m metaasr_tpu_torch.cli --mode serve --bundle DIR \
        --wav a.wav [b.wav ...]
    torchrun --nproc-per-node W -m metaasr_tpu_torch.cli --mode train \
        --mesh-tasks N --config CFG --data-dir DIR --workdir WD [...]

``train`` (the default) trains on the accents of ``--data-dir``
(``<accent>.jsonl`` manifests, e.g. from ``data.synthetic.generate_dataset``),
checkpointing under ``<workdir>/ckpts``: meta-training for the algos fomaml,
maml (full second order, e.g. ``configs/config4_maml.yaml``) and reptile,
with held-out evaluation every ``train.eval_every`` steps; the
single-accent baseline for ``no`` (e.g. ``configs/config1_mono_vgg_ctc.yaml``,
the VGG-BLSTM CTC phone recognizer) and pooled multi-accent training for
``multi``, both with periodic dev evaluation (``data.dev_fraction``).

The other modes load the latest checkpoint (``--use-best``: the best;
``--avg-last N``: the mean of the last N saved) and write
``<workdir>/<mode>_results.json``: ``adapt`` adapts to each held-out accent
and decodes the rest of it (``hyps_<accent>.jsonl``); ``test`` decodes the
held-out accents without adaptation, or a baseline's dev set; ``transcribe``
decodes every loaded accent without adaptation and reports WER where the
manifests carry transcripts; ``export`` writes a serving bundle, with the
shallow-fusion LM of ``--lm-ckpt`` (``scripts/train_lm.py``) when its
``--lm-weight`` is not 0; the beam decodes of ``train``'s held-out
evaluation, ``adapt``, ``test`` and ``transcribe`` fuse it too. These modes
and a resumed ``train`` run under the workdir's recorded ``config.yaml``
when ``--config`` is absent; only ``train`` writes it. ``serve``
transcribes WAV files with a bundle: one the port wrote records its config;
one the JAX package exported (``--mode export``) needs ``--config`` for the
model dims, CMVN mode and beam options. Every mode runs on CUDA unless
``--device cpu`` is given.

``--mesh-tasks N`` meta-trains data-parallel over the W processes torchrun
starts, one card each, where N divides W: N task groups of W / N ranks,
each group running M / N of a meta-batch's M tasks
(``parallel.make_mesh``), and the outer gradient is summed once a step.
With N below W each group's ranks split every task's shots under first
order (the data axis: an inner step's gradient is summed over the group)
and repeat the task under second order. Rank 0 alone resolves the
config, writes the workdir (``config.yaml``, checkpoints, logs) and
prints; the other ranks train its config. Started again on the same
workdir, the ranks resume from rank 0's latest checkpoint.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
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
    """The vocabulary of ``data.vocab``: the ASCII char set; or the phone or
    BPE vocabulary loaded from ``<data_dir>/vocab_<kind>.json`` when present,
    else built from the manifests (phones: their phone transcripts, ARPAbet
    when they carry none; BPE: 200 merges over their texts) and saved
    there."""
    from metaasr_tpu_torch.data.bpe import BPETokenizer
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer, PhoneTokenizer

    kind = cfg.data.vocab
    if kind == "char":
        return CharTokenizer.ascii_default()
    vocab_path = os.path.join(cfg.data.data_dir, f"vocab_{kind}.json")
    if kind == "phone":
        if os.path.exists(vocab_path):
            return PhoneTokenizer.load(vocab_path)
        tok = PhoneTokenizer.from_corpus(
            _corpus_texts(cfg.data.data_dir, "phones"))
        if len(tok.symbols) == 0:   # the manifests carry no phone field
            tok = PhoneTokenizer.arpabet_default()
        tok.save(vocab_path)
        return tok
    if kind == "bpe":
        if os.path.exists(vocab_path):
            return BPETokenizer.load(vocab_path)
        tok = BPETokenizer.from_corpus(_corpus_texts(cfg.data.data_dir, "text"))
        tok.save(vocab_path)
        return tok
    raise ValueError(f"unknown vocab type {kind}")


def make_trainer(cfg: Config, workdir: str, device=None, group=None,
                 mesh_tasks: int | None = None):
    """(trainer, tokenizer) for the configured algo: ``MonoASRTrainer``
    (no), ``MultitaskASRTrainer`` (multi) or ``MetaASRTrainer`` (fomaml,
    maml, reptile). Held-out accents (``data.heldout_accents``) are kept out of
    the training pool; the baselines evaluate on a per-accent dev split
    (``data.dev_fraction``) or, without one, on the first held-out accent.
    ``group`` (``parallel.initialize()``'s) makes the meta-trainer data
    parallel, over ``mesh_tasks`` task groups (all of its ranks by
    default); the baselines take none."""
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
    if group is not None and algo in ("no", "multi"):
        raise ValueError(f"algo {algo} trains in one process: a process "
                         "group is for the meta-trainer")
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
                              device=device, group=group,
                              mesh_tasks=mesh_tasks), tok
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
    p.add_argument("--mode", default="train",
                   choices=["train", "adapt", "test", "transcribe", "export",
                            "serve"])
    p.add_argument("--config", type=str, default=None,
                   help="the run's YAML config (default: "
                   "<workdir>/config.yaml when it exists, else Config(); "
                   "serve: only for bundles that do not record their config)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "PyTorch path)")
    p.add_argument("-o", "--override", action="append", default=[],
                   help="dotted config override key=value")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly detection: stop at the backward op "
                   "that produces a NaN (forward ops are not checked)")
    p.add_argument("--profile", type=str, default=None,
                   help="train: write a torch.profiler Chrome trace into "
                   "this directory (under --mesh-tasks N > 1, rank r > 0 "
                   "into <dir>_rank<r>)")
    p.add_argument("--lm-ckpt", type=str, default=None,
                   help="shallow-fusion LM npz (scripts/train_lm.py) for "
                   "beam decode; shorthand for -o train.lm_ckpt=...")
    p.add_argument("--lm-weight", type=float, default=None,
                   help="shallow-fusion weight (0 = off); shorthand for "
                   "-o train.lm_weight=...")
    p.add_argument("--mesh-tasks", type=int, default=0,
                   help="train with a meta algo over torchrun's W "
                   "processes, one card each: N task groups of W / N ranks "
                   "(N must divide W; below W, a group's ranks split each "
                   "task's shots, the data axis); rank 0 alone writes the "
                   "workdir")
    t = p.add_argument_group("train")
    t.add_argument("--algo",
                   choices=["no", "multi", "fomaml", "maml", "reptile"],
                   default=None)
    t.add_argument("--workdir", type=str, default="runs/default")
    t.add_argument("--data-dir", type=str, default=None)
    t.add_argument("--max-steps", type=int, default=None)
    t.add_argument("--seed", type=int, default=None)
    d = p.add_argument_group("adapt / test / transcribe / export")
    d.add_argument("--use-best", action="store_true",
                   help="load the best checkpoint instead of the latest")
    d.add_argument("--avg-last", type=int, default=0,
                   help="average the parameters of the last N checkpoints")
    d.add_argument("--decode-mode", choices=["greedy", "beam"],
                   default="greedy")
    d.add_argument("--dump-nbest", type=int, default=1,
                   help="hypotheses (with scores) per utterance in the "
                   "hyps_*.jsonl dumps (beam) and in serve's output")
    e = p.add_argument_group("export")
    e.add_argument("--export-dir", type=str, default=None,
                   help="bundle directory (default <workdir>/export)")
    e.add_argument("--export-buckets", type=str, default="8x48000",
                   help="comma-separated BATCHxWIDTH serving shapes "
                   "(width in audio samples)")
    e.add_argument("--export-weights-dtype", choices=["float32", "bfloat16"],
                   default="float32")
    e.add_argument("--export-decode", choices=["auto", "beam", "greedy"],
                   default="auto",
                   help="auto: beam for the transformer, greedy otherwise")
    e.add_argument("--export-platforms", type=str, default=None,
                   help="StableHLO targets of the JAX package's bundles; the "
                   "port writes no programs: refused")
    s = p.add_argument_group("serve")
    s.add_argument("--bundle", type=str, help="serving bundle directory")
    s.add_argument("--wav", nargs="+", help="WAV files to transcribe")
    s.add_argument("--serve-params", type=str, default=None,
                   help="hot-swap an adapted params npz (flat a/b/c keys, "
                   "Flax layout)")
    s.add_argument("--serve-out", type=str, default=None,
                   help="also write one JSONL record per file here")
    args = p.parse_args(argv)

    if args.export_platforms is not None:
        raise SystemExit(
            "--export-platforms names the StableHLO targets of the JAX "
            "package's bundles; the port's bundles hold no programs (its "
            "own modules serve them): drop the flag")
    if args.use_best and args.avg_last:
        raise SystemExit(
            "--use-best and --avg-last are mutually exclusive: averaging the "
            "last N checkpoints would replace the restored best parameters; "
            "pick one")
    if args.debug_nans:
        from metaasr_tpu_torch.utils.profiling import nan_check

        nan_check(True)
    group = _process_group(args)
    overrides = dict(_parse_override(kv) for kv in args.override)
    if args.mode == "serve":
        if not args.bundle or not args.wav:
            p.error("--mode serve needs --bundle DIR and --wav FILE "
                    "[FILE ...]")
        return _serve(args, overrides)
    if args.mode == "train":
        return _train(args, _train_config(args, overrides, group), group)
    return _meta_test(args, _run_config(args, overrides))


def _process_group(args):
    """The process group ``--mesh-tasks N`` asks for (``None``: one
    process), made before the config is resolved. W processes, N task
    groups of W / N, train one run; ``parallel.initialize`` takes
    torchrun's environment (gloo for ``--device cpu``, else NCCL on
    ``cuda:LOCAL_RANK``) or returns the group its caller made, and raises
    where the rendezvous fails. An N that does not divide W is refused, as
    is a multi-process environment without the flag: each process would
    train the whole run into one workdir."""
    from metaasr_tpu_torch import parallel

    n = args.mesh_tasks
    if n < 0:
        raise SystemExit(f"--mesh-tasks {n}: give a number of processes")
    if n > 1 and args.mode != "train":
        raise SystemExit(
            f"--mesh-tasks {n} runs meta-training over processes; --mode "
            f"{args.mode} runs in one process: drop the flag")
    if n and args.mode == "train":
        group = parallel.initialize(device=args.device)
        w = parallel.world_size(group)
        if w % n:
            raise SystemExit(
                f"--mesh-tasks {n} but the world size is {w}: N = {n} "
                f"task groups must divide the W = {w} processes (torchrun "
                f"--nproc-per-node a multiple of {n})")
        return group
    world = parallel.launched_world_size()
    if world > 1:
        raise SystemExit(
            f"{world} processes (WORLD_SIZE) but no --mesh-tasks: each would "
            f"train the whole run into one workdir; pass --mesh-tasks "
            f"{world} with --mode train and a meta algo")
    return None


def _serve(args, overrides: dict) -> int:
    from metaasr_tpu_torch.serve.export import (
        ServingDecoder,
        load_bundle_params,
    )

    cfg = (load_config(args.config, overrides)
           if args.config or overrides else None)
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


def _run_config(args, overrides: dict) -> Config:
    # a resumed run and the meta-test modes default to the run's own
    # recorded config, as the reference does: Config() defaults would load
    # the checkpoint into another model
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
    if args.lm_ckpt is not None:
        overrides["train.lm_ckpt"] = args.lm_ckpt
    if args.lm_weight is not None:
        overrides["train.lm_weight"] = args.lm_weight
    return load_config(args.config, overrides)


def _train_config(args, overrides: dict, group) -> Config:
    """The run's config, resolved by rank 0 alone (``_run_config``: the
    recorded ``config.yaml`` only where it is there) and handed to every
    rank; where rank 0 fails, every rank raises."""
    from metaasr_tpu_torch import parallel

    if group is None:
        return _run_config(args, overrides)
    cfg = err = None
    if parallel.rank(group) == 0:
        try:
            cfg = _run_config(args, overrides)
        except (Exception, SystemExit) as e:
            err = e
    # the other ranks wait here for rank 0: a failure reaches them too
    got, why = parallel.from_rank0(
        (cfg, None if err is None else f"{type(err).__name__}: {err}"),
        group)
    if err is not None:
        raise err
    if why is not None:
        raise SystemExit(f"rank 0 could not resolve the config: {why}")
    return got


def _train(args, cfg: Config, group=None) -> int:
    """Rank 0 records the config as ``<workdir>/config.yaml`` and writes
    the vocabulary file where one is built; every rank then trains rank
    0's ``Config``, so no rank reads a file another writes."""
    from metaasr_tpu_torch import parallel

    rank = parallel.rank(group)
    if cfg.meta.algo in ("no", "multi") and group is not None:
        if parallel.world_size(group) > 1:
            raise SystemExit(
                f"--mesh-tasks {args.mesh_tasks}: algo {cfg.meta.algo} "
                "trains in one process; the task mesh is for fomaml, maml "
                "and reptile")
        group = None
    if rank == 0:
        os.makedirs(args.workdir, exist_ok=True)
        save_config(cfg, os.path.join(args.workdir, "config.yaml"))
        if group is not None:
            build_tokenizer(cfg)
    parallel.barrier(group)
    trainer, _ = make_trainer(cfg, args.workdir,
                              device=parallel.rank_device(args.device, group),
                              group=group,
                              mesh_tasks=(args.mesh_tasks if group is not None
                                          else None))
    ctx = contextlib.nullcontext()
    if args.profile:
        from metaasr_tpu_torch.utils.profiling import trace

        ctx = trace(args.profile if rank == 0
                    else f"{args.profile}_rank{rank}")
    # --max-steps bounds this invocation; the recorded config keeps its own
    with ctx:
        if cfg.meta.algo in ("no", "multi"):
            state = trainer.train(max_steps=args.max_steps)
        else:
            state = trainer.meta_train(max_steps=args.max_steps)
    if rank == 0:
        print(json.dumps({"workdir": args.workdir, "step": state["step"]}))
    return 0


def _meta_test(args, cfg: Config) -> int:
    """adapt / test / transcribe / export from the run's checkpoint."""
    from metaasr_tpu_torch.meta.maml import split_lr
    from metaasr_tpu_torch.train.checkpoint import average_checkpoints
    from metaasr_tpu_torch.train.meta_train import MetaASRTrainer

    meta = cfg.meta.algo in ("fomaml", "maml", "reptile")
    if args.mode == "adapt" and not meta:
        raise SystemExit(
            f"--mode adapt adapts a meta-trained model; algo "
            f"{cfg.meta.algo!r} trains a baseline, which has no k-shot "
            "adaptation: use --mode test or transcribe")
    trainer, tok = make_trainer(cfg, args.workdir, device=args.device)
    ckpts = trainer.ckpt
    if args.use_best:
        state = ckpts.restore_best(map_location=trainer.device)
        if state is None:
            raise SystemExit(
                f"no best checkpoint under {ckpts.ckpt_dir}/best (best is "
                "saved at the periodic evaluations: train with "
                "train.eval_every set)")
    else:
        state, step = ckpts.restore(map_location=trainer.device)
        if step < 0:
            raise SystemExit(f"no checkpoint found under {ckpts.ckpt_dir}")
    params = state["params"]
    if args.avg_last:
        params = average_checkpoints(ckpts, last_n=args.avg_last,
                                     map_location=trainer.device)
    if args.mode == "export":
        from metaasr_tpu_torch.serve.export import write_bundle
        from metaasr_tpu_torch.train.checkpoint import load_params_npz
        from metaasr_tpu_torch.weights import params_to_flax

        out_dir = args.export_dir or os.path.join(args.workdir, "export")
        buckets = [tuple(int(v) for v in b.split("x"))
                   for b in args.export_buckets.split(",")]
        lm_params = None
        if cfg.train.lm_ckpt and cfg.train.lm_weight != 0.0:
            lm_params = load_params_npz(cfg.train.lm_ckpt)
        manifest = write_bundle(
            out_dir, cfg, params_to_flax(split_lr(params)[0],
                                         cfg.model.num_heads),
            tok, buckets, weights_dtype=args.export_weights_dtype,
            mode=None if args.export_decode == "auto" else args.export_decode,
            lm_params=lm_params)
        print(json.dumps({"export_dir": out_dir, "files": manifest["files"],
                          "mode": manifest["mode"],
                          "platforms": manifest["platforms"]}, indent=2))
        return 0

    def dump(name: str) -> str:
        return os.path.join(args.workdir, f"hyps_{name}.jsonl")

    decode = dict(mode=args.decode_mode, dump_nbest=args.dump_nbest)
    results = {}
    if args.mode == "adapt":
        for name, ds in trainer.heldout_datasets.items():
            adapted, test_idx = trainer.meta_adapt(params, ds)
            results[name] = trainer.decode(adapted, ds, test_idx,
                                           dump_path=dump(name), **decode)
    elif args.mode == "transcribe":
        # every loaded accent, zero-shot; manifests without transcripts
        # decode too (their refs are empty and no WER is reported)
        targets = dict(trainer.accent_datasets) if meta else {}
        targets.update(trainer.heldout_datasets)
        decoder = trainer
        if not meta:
            for i, ds in enumerate(trainer.train_datasets):
                targets.setdefault(ds.accent or f"accent{i}", ds)
            # a decode-only meta trainer over the baseline's model
            dcfg = copy.deepcopy(cfg)
            dcfg.meta.algo = "fomaml"
            decoder = MetaASRTrainer(dcfg, trainer.task, dict(targets), {},
                                     tok, os.path.join(args.workdir,
                                                       "_decode"),
                                     device=trainer.device)
        for name, ds in targets.items():
            scores = decoder.decode(params, ds, max_utts=len(ds),
                                    dump_path=dump(name), **decode)
            results[name] = {"utts": len(ds), "dump": dump(name)}
            if any(ds.transcript(i) for i in range(len(ds))):
                results[name].update(scores)
    else:   # test: decode without adaptation
        targets = trainer.heldout_datasets
        dev = getattr(trainer, "dev_dataset", None)
        if not targets and dev:
            targets = {"dev": dev}
        for name, ds in targets.items():
            results[name] = (trainer.decode(params, ds, dump_path=dump(name),
                                            **decode)
                             if meta else trainer.evaluate(params, ds))
    out = os.path.join(args.workdir, f"{args.mode}_results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
