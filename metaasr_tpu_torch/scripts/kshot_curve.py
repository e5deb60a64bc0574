"""k-shot adaptation curve on the held-out accent (counterpart of the
reference's ``scripts/kshot_curve.py``): for each trained run, beam WER
after adapting on k support utterances, averaged over support draws.

    python -m metaasr_tpu_torch.scripts.kshot_curve \
        --runs fomaml=RUNS/hard_fomaml,multi=RUNS/hard_multi \
        [--ks 0,1,2,5,10,20] [--draws 3] [--adapt-steps 5] [--max-utts 64] \
        [--data-dir DIR] [--out curve.json] [--tiny] [--device cpu]

``--data-dir`` and ``--out`` default to paths under the system's temporary
directory (``$TMPDIR``, else ``/tmp``).

Each workdir holds ``ckpts/`` from a run trained under the flagship recipe
(``scripts/flagship_results.py::make_cfg``); its newest checkpoint is
restored onto the run's device, wherever it was written. The label says
how: a label starting with ``multi`` restores through
``MultitaskASRTrainer`` and adapts and decodes through a
``MetaASRTrainer`` on ``<workdir>_kshot_eval``; any other through
``MetaASRTrainer``. ``@bf16`` in a label sets ``meta.grad_dtype=bfloat16``,
``@conformer`` ``model.encoder=conformer`` and ``@metasgd``
``meta.learn_inner_lr`` (the wrapped {model, inner_lr} tree is restored and
adapts with its learned rates). ``--tiny`` shrinks the model to the CPU
tests' width, for workdirs trained at that width.

k = 0 decodes the held-out utterances from index 8 on; every other k
averages ``--draws`` support draws (seed = draw index) of ``meta_adapt(
k_support=k, adapt_steps=--adapt-steps)``, each followed by a beam decode of
the rest. The JSON holds ``ks``, ``draws``, ``adapt_steps`` and, per label,
{k: {mean, std[, draws]}}. Runs on CUDA unless ``--device cpu`` is given:
there each adaptation launches K1 once and K2 once a step, and each decode
batch K1 once.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from metaasr_tpu_torch.scripts.flagship_results import HELDOUT, make_cfg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--runs", required=True,
                    help="comma list label=workdir; label starting with "
                         "'multi' restores a multitask checkpoint, "
                         "'@metasgd' in the label sets meta.learn_inner_lr, "
                         "'@bf16' sets meta.grad_dtype=bfloat16")
    tmp = tempfile.gettempdir()
    ap.add_argument("--data-dir",
                    default=os.path.join(tmp, "flagship_synth_hard"))
    ap.add_argument("--ks", default="0,1,2,5,10,20")
    ap.add_argument("--draws", type=int, default=3)
    ap.add_argument("--adapt-steps", type=int, default=5)
    ap.add_argument("--max-utts", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0,
                    help="kept for the reference's command lines: it sets "
                         "train.seed and data.seed, which nothing here reads "
                         "(checkpoints restore without a template)")
    ap.add_argument("--out", default=os.path.join(tmp, "kshot_curve.json"))
    ap.add_argument("--tiny", action="store_true",
                    help="debug: tiny model dims (CPU-runnable script "
                         "check; workdirs must hold tiny checkpoints)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                    "PyTorch path)")
    return ap


def apply_tiny(cfg) -> None:
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


def run_config(label: str, data_dir: str, seed: int, tiny: bool,
               vocab_size: int):
    """The flagship recipe as the label asks for it."""
    grad_dtype = "bfloat16" if "@bf16" in label else "float32"
    cfg = make_cfg("fomaml", 1, data_dir, seed=seed, grad_dtype=grad_dtype)
    cfg.model.vocab_size = vocab_size
    if "@conformer" in label:
        cfg.model.encoder = "conformer"
    if "@metasgd" in label:
        cfg.meta.learn_inner_lr = True
    if tiny:
        apply_tiny(cfg)
    return cfg


def zero_shot_indices(ds) -> list[int]:
    return list(range(len(ds)))[8:]


def curve_point(meta_tr, params, ds, k: int, draws: int, adapt_steps: int,
                max_utts: int) -> dict:
    """One k of the curve: beam WER {mean, std} (and the draws for k > 0)."""
    if k == 0:
        wer = meta_tr.decode(params, ds, zero_shot_indices(ds),
                             max_utts=max_utts, mode="beam")["wer"]
        return {"mean": round(wer, 4), "std": 0.0}
    wers = []
    for seed in range(draws):
        adapted, test_idx = meta_tr.meta_adapt(
            params, ds, adapt_steps=adapt_steps, k_support=k, seed=seed)
        wers.append(meta_tr.decode(adapted, ds, test_idx, max_utts=max_utts,
                                   mode="beam")["wer"])
    return {"mean": round(float(np.mean(wers)), 4),
            "std": round(float(np.std(wers)), 4),
            "draws": [round(w, 4) for w in wers]}


def main(argv=None) -> dict:
    from metaasr_tpu_torch.data.dataset import load_accent_datasets
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer
    from metaasr_tpu_torch.device import resolve_device
    from metaasr_tpu_torch.task import ASRTask
    from metaasr_tpu_torch.train.meta_train import MetaASRTrainer
    from metaasr_tpu_torch.train.mono import MultitaskASRTrainer

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    tok = CharTokenizer.ascii_default()
    ks = [int(k) for k in args.ks.split(",")]
    results = {"ks": ks, "draws": args.draws,
               "adapt_steps": args.adapt_steps}

    for spec in args.runs.split(","):
        label, wd = spec.split("=", 1)
        cfg = run_config(label, args.data_dir, args.seed, args.tiny,
                         tok.vocab_size)
        dsets = load_accent_datasets(args.data_dir, tok)
        heldout = {HELDOUT: dsets.pop(HELDOUT)}
        task = ASRTask(cfg, tok.sos_eos_id, device=device)
        if label.startswith("multi"):
            tr = MultitaskASRTrainer(cfg, task, dsets, None, tok, wd,
                                     device=device)
            state, step = tr.ckpt.restore(map_location=device)
            meta_tr = MetaASRTrainer(cfg, task, dsets, heldout, tok,
                                     wd + "_kshot_eval", device=device)
        else:
            meta_tr = MetaASRTrainer(cfg, task, dsets, heldout, tok, wd,
                                     device=device)
            state, step = meta_tr.ckpt.restore(map_location=device)
        if step < 0:
            raise SystemExit(f"no checkpoint under {wd}/ckpts")
        print(f"[{label}] restored step {step}", flush=True)
        ds = heldout[HELDOUT]
        curve = {}
        for k in ks:
            curve[str(k)] = curve_point(meta_tr, state["params"], ds, k,
                                        args.draws, args.adapt_steps,
                                        args.max_utts)
            print(f"[{label}] k={k}: {curve[str(k)]}", flush=True)
        results[label] = curve
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
