"""One-command acceptance drill (counterpart of the reference's
``scripts/acceptance.py``; the same stages, outputs and exit rule).

Every stage runs the port's own entry points as a subprocess, from the
root of the checkout:

    CV-format TSV + clips (22.05 kHz)
      -> prepare_data commonvoice          (filter, resample, manifests)
      -> cli --mode train --algo fomaml    (meta-train, the held-out accent
                                            excluded)
      -> cli --mode adapt                  (k-shot adaptation + beam decode
                                            on the held-out accent -> WER)
      -> adapted-params .npz               (make_trainer, restore,
                                            meta_adapt, save_params_npz)
      -> cli --mode export                 (serving bundle)
      -> cli --mode serve                  (WAV front door, adapted weights
                                            hot-swapped)
      -> WER of the served transcripts against the held-out references

The corpus is the synthetic accent transforms of ``data/synthetic.py``
rendered at 22.05 kHz, so the preparation must resample. Swap
``--tsv``/``--clips-dir`` for a real Common Voice download and nothing else
changes.

Usage:
    python -m metaasr_tpu_torch.scripts.acceptance --out /tmp/acceptance
    python -m metaasr_tpu_torch.scripts.acceptance --out DIR --device cpu

``--device`` (default cuda) goes to every stage. Writes
``<out>/acceptance.json``; prints ``ACCEPTANCE GREEN`` and exits 0 only if
every stage passed and, without ``--smoke``, the served WER is below 0.9.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HELDOUT = "india"
T0 = time.perf_counter()


def log(msg):
    print(f"[acceptance +{time.perf_counter() - T0:7.1f}s] {msg}",
          flush=True)


def sh(args, tag=""):
    """Run one stage from the checkout's root; a failure ends the drill.
    -> (the completed process, seconds)."""
    log(f"run[{tag}]: {' '.join(args[:8])}{' ...' if len(args) > 8 else ''}")
    t = time.perf_counter()
    r = subprocess.run(args, cwd=REPO, capture_output=True, text=True)
    if r.returncode != 0:
        print(r.stdout[-4000:], file=sys.stderr)
        print(r.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"stage '{tag}' failed (rc={r.returncode})")
    sec = time.perf_counter() - t
    log(f"ok [{tag}] in {sec:.1f}s")
    return r, sec


def make_cv_corpus(root: str, utts_per_accent: int, seed: int):
    """CV-format corpus: validated.tsv + clips/ at 22.05 kHz, using the
    synthetic accent transforms (learnable; accents genuinely differ)."""
    from metaasr_tpu_torch.data.audio_io import write_wav
    from metaasr_tpu_torch.data.synthetic import (
        LEXICON,
        _accent_params,
        synth_utterance,
    )

    accents = ("us", "england", HELDOUT)
    clips = os.path.join(root, "clips")
    os.makedirs(clips, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for ai, accent in enumerate(accents):
        # indices spread so the held-out accent's transform is not between
        # the training ones
        ap = _accent_params(2 * ai, rng)
        for i in range(utts_per_accent):
            text = " ".join(rng.choice(LEXICON,
                                       size=rng.integers(2, 5)))
            wav = synth_utterance(text, ap, rng, sample_rate=22050)
            name = f"{accent}_{i:03d}.wav"
            write_wav(os.path.join(clips, name), wav, 22050)
            rows.append({"path": name, "sentence": text, "accent": accent,
                         "client_id": f"{accent}_spk{i % 4}"})
    tsv = os.path.join(root, "validated.tsv")
    with open(tsv, "w", newline="") as f:
        w = csv.DictWriter(
            f, fieldnames=["path", "sentence", "accent", "client_id"],
            delimiter="\t")
        w.writeheader()
        w.writerows(rows)
    return tsv, clips


def main(argv=None):
    ap = argparse.ArgumentParser("acceptance")
    ap.add_argument("--out", default="/tmp/acceptance")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every stage ('cpu' runs the "
                    "kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=300,
                    help="meta-train steps (enough for the synthetic "
                    "corpus to beat the zero-shot floor)")
    ap.add_argument("--utts", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="composition only: every stage must run green and "
                    "produce its artifact, but the WER bound is waived (a "
                    "few steps cannot learn the corpus)")
    args = ap.parse_args(argv)

    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    wd = os.path.join(out, "run")
    dev = ["--device", args.device]
    cli = [sys.executable, "-m", "metaasr_tpu_torch.cli"]
    summary = {"stages": {}, "device": args.device}

    # ---- stage 0: CV-format corpus (in-process; host code only) ----
    t = time.perf_counter()
    tsv, clips = make_cv_corpus(os.path.join(out, "cv"), args.utts,
                                args.seed)
    summary["stages"]["corpus"] = {"sec": round(time.perf_counter() - t, 1),
                                   "tsv": tsv}
    log(f"corpus: {tsv}")

    # ---- stage 1: prepare_data commonvoice ----
    data_dir = os.path.join(out, "data")
    _, sec = sh([sys.executable, "-m", "metaasr_tpu_torch.scripts.prepare_data",
                 "commonvoice", "--tsv", tsv, "--clips-dir", clips, "--out",
                 data_dir, "--min-sec", "0.2", "--max-sec", "20"],
                tag="prepare_data")
    manifests = sorted(f for f in os.listdir(data_dir)
                       if f.endswith(".jsonl"))
    if f"{HELDOUT}.jsonl" not in manifests:
        raise SystemExit(f"prepare_data wrote no {HELDOUT} manifest: "
                         f"{manifests}")
    summary["stages"]["prepare_data"] = {"sec": round(sec, 1),
                                         "manifests": manifests}

    # ---- stage 2: FOMAML meta-train (held-out accent excluded) ----
    model_small = [
        "-o", "model.d_model=64", "-o", "model.num_heads=2",
        "-o", "model.d_ff=128", "-o", "model.num_encoder_layers=2",
        "-o", "model.num_decoder_layers=2", "-o", "model.dtype=float32",
    ]
    _, sec = sh([*cli, "--config", "configs/config3_fomaml.yaml", "--mode",
                 "train", "--algo", "fomaml", "--workdir", wd, "--data-dir",
                 data_dir, "--max-steps", str(args.steps), "--seed",
                 str(args.seed), *dev,
                 "-o", f"data.heldout_accents={HELDOUT}",
                 "-o", "meta.tasks_per_batch=2", "-o", "meta.k_support=4",
                 "-o", "meta.k_query=4", "-o", "train.eval_every=0",
                 "-o", "train.log_every=50", *model_small],
                tag="meta_train")
    summary["stages"]["meta_train"] = {"sec": round(sec, 1),
                                       "steps": args.steps}

    # ---- stage 3: k-shot adapt + beam decode on the held-out accent ----
    _, sec = sh([*cli, "--mode", "adapt", "--workdir", wd, "--decode-mode",
                 "beam", *dev], tag="meta_adapt")
    with open(os.path.join(wd, "adapt_results.json")) as f:
        adapt_res = json.load(f)
    summary["stages"]["adapt"] = {**adapt_res, "sec": round(sec, 1)}
    log(f"adapt results: {adapt_res}")

    # ---- stage 4: adapted params npz (the meta-serving artifact) ----
    code = (
        "import os\n"
        "from metaasr_tpu_torch.cli import make_trainer\n"
        "from metaasr_tpu_torch.config import load_config\n"
        "from metaasr_tpu_torch.meta.maml import split_lr\n"
        "from metaasr_tpu_torch.train.checkpoint import save_params_npz\n"
        f"cfg = load_config(os.path.join({wd!r}, 'config.yaml'), {{}})\n"
        f"tr, tok = make_trainer(cfg, {wd!r}, device={args.device!r})\n"
        "state, step = tr.ckpt.restore(map_location=tr.device)\n"
        "assert step >= 0, 'no checkpoint'\n"
        f"ds = tr.heldout_datasets[{HELDOUT!r}]\n"
        "adapted, _ = tr.meta_adapt(state['params'], ds)\n"
        f"save_params_npz(os.path.join({out!r}, 'adapted.npz'), "
        "split_lr(adapted)[0], cfg.model.num_heads)\n"
        "print('adapted.npz written')\n")
    _, sec = sh([sys.executable, "-c", code], tag="adapted_npz")
    summary["stages"]["adapted_npz"] = {"sec": round(sec, 1)}

    # ---- stage 5: export the serving bundle ----
    bundle = os.path.join(out, "bundle")
    _, sec = sh([*cli, "--mode", "export", "--workdir", wd, "--export-dir",
                 bundle, "--export-buckets", "8x48000", *dev], tag="export")
    summary["stages"]["export"] = {"sec": round(sec, 1)}

    # ---- stage 6: serve held-out WAVs through the CLI front door with
    # the adapted weights hot-swapped ----
    with open(os.path.join(data_dir, f"{HELDOUT}.jsonl")) as f:
        man = [json.loads(line) for line in f]
    # the utterances meta_adapt did not train on (its support set is drawn
    # from the front of the manifest; serve the tail)
    test_utts = man[-8:]
    wavs = [os.path.join(data_dir, u["wav"]) for u in test_utts]
    serve_out = os.path.join(out, "serve_out.jsonl")
    _, sec = sh([*cli, "--mode", "serve", "--bundle", bundle,
                 "--serve-params", os.path.join(out, "adapted.npz"),
                 "--serve-out", serve_out, *dev, "--wav", *wavs],
                tag="serve")
    summary["stages"]["serve"] = {"sec": round(sec, 1)}

    # ---- stage 7: score the served transcripts ----
    from metaasr_tpu_torch.train.metrics import compute_wer

    with open(serve_out) as f:
        hyps = [json.loads(line)["text"] for line in f]
    refs = [u["text"] for u in test_utts]
    wer = compute_wer(hyps, refs)
    summary["served_wer"] = wer
    summary["adapted_wer"] = adapt_res.get(HELDOUT, {}).get("wer")
    with open(os.path.join(out, "acceptance.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log(f"served WER on {len(hyps)} held-out utts: {wer:.3f} "
        f"(adapt-mode beam WER: {summary['adapted_wer']})")

    # every stage produced its artifact, the WER is finite and (without
    # --smoke) below the all-wrong floor: 1.0 means nothing useful came out
    if args.smoke:
        if not wer == wer:
            raise SystemExit("acceptance FAILED: served WER is NaN")
        log("ACCEPTANCE GREEN (smoke: composition only)")
        return 0
    if not (wer == wer and wer < 0.9):
        raise SystemExit(f"acceptance FAILED: served WER {wer} "
                         "not meaningfully below the all-wrong floor")
    log("ACCEPTANCE GREEN")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
