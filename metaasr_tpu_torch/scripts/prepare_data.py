"""Data preparation (counterpart of the reference's
``scripts/prepare_data.py``; the same subcommands, options and files).

Subcommands:

  synthetic    — the synthetic multi-accent dataset
      python -m metaasr_tpu_torch.scripts.prepare_data synthetic \
          --out data/synthetic --utts-per-accent 64

  commonvoice  — Common Voice-style prep: read a TSV (columns: path,
                 sentence, accent or accents[, client_id]), keep the rows
                 of the wanted accents, decode and resample the clips to
                 16 kHz mono WAV, write per-accent JSONL manifests
      python -m metaasr_tpu_torch.scripts.prepare_data commonvoice \
          --tsv validated.tsv --clips-dir clips/ --out data/cv \
          --accents us england india

  features     — offline log-mel fbank (cmvn none) per utterance into
                 ``feats/<accent>/<id>.npy`` (fp32), the manifests
                 rewritten to point at them, and the global CMVN statistics
                 of the corpus in ``cmvn_stats.json``
      python -m metaasr_tpu_torch.scripts.prepare_data features \
          --data-dir data/cv [--device cpu]

  speaker-cmvn — per-speaker fbank mean/var -> ``speaker_cmvn.json``

  vocab        — a char, phone or BPE vocabulary from the manifests ->
                 ``vocab_<type>.json``
      python -m metaasr_tpu_torch.scripts.prepare_data vocab \
          --data-dir data/cv --type bpe --bpe-merges 200

``features`` and ``speaker-cmvn`` compute the features with the port's
front-end, one utterance per call of K1 (``frontend/fbank_kernel.py``): on
CUDA unless ``--device cpu`` is given, where K1's plain version runs. The
other subcommands touch no tensor. As in the reference, ``features`` drops
the ``speaker`` field from the manifests it rewrites.
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np


def cmd_synthetic(args):
    from metaasr_tpu_torch.data.synthetic import ACCENTS, generate_dataset

    accents = args.accents or list(ACCENTS)
    generate_dataset(args.out, accents=accents,
                     utts_per_accent=args.utts_per_accent, seed=args.seed)
    print(f"wrote {len(accents)} accent manifests under {args.out}")


def cmd_commonvoice(args):
    from metaasr_tpu_torch.data.audio_io import load_wav, write_wav

    os.makedirs(args.out, exist_ok=True)
    wanted = {a.lower() for a in args.accents} if args.accents else None
    rows_by_accent: dict[str, list] = {}
    with open(args.tsv, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            accent = (row.get("accent") or row.get("accents") or "").strip().lower()
            if not accent or (wanted and accent not in wanted):
                continue
            rows_by_accent.setdefault(accent, []).append(row)
    for accent, rows in sorted(rows_by_accent.items()):
        wav_dir = os.path.join(args.out, "wav", accent)
        os.makedirs(wav_dir, exist_ok=True)
        lines = []
        # ids count every row of the accent, skipped ones too
        for i, row in enumerate(rows[: args.max_per_accent or None]):
            src = os.path.join(args.clips_dir, row["path"])
            if not os.path.exists(src):
                continue
            try:
                audio = load_wav(src, args.sample_rate)
            except Exception:   # a clip that does not decode is skipped
                continue
            if not (args.min_sec <= len(audio) / args.sample_rate <= args.max_sec):
                continue
            utt_id = f"{accent}_{i:06d}"
            rel = os.path.join("wav", accent, f"{utt_id}.wav")
            write_wav(os.path.join(args.out, rel), audio, args.sample_rate)
            text = " ".join(row.get("sentence", "").lower().split())
            lines.append(json.dumps({
                "id": utt_id, "wav": rel, "text": text,
                "phones": "", "num_samples": int(len(audio)),
                "speaker": row.get("client_id", ""),
            }))
        if lines:
            with open(os.path.join(args.out, f"{accent}.jsonl"), "w") as f:
                f.write("\n".join(lines) + "\n")
            print(f"{accent}: {len(lines)} utts")


def _corpus(args):
    """(the device ``args.device`` names, [(accent, manifest)] of
    ``args.data_dir``)."""
    from metaasr_tpu_torch.data.dataset import Manifest, discover_accents
    from metaasr_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    return device, [
        (accent, Manifest.load(os.path.join(args.data_dir, f"{accent}.jsonl")))
        for accent in discover_accents(args.data_dir)]


def _fbank(man, u, sample_rate: int, device) -> np.ndarray:
    """[F, 80] fp32 log-mel features (cmvn none) of one utterance: one K1
    call on ``device``."""
    import torch

    from metaasr_tpu_torch.data.audio_io import load_wav
    from metaasr_tpu_torch.frontend.fbank import log_mel_fbank

    audio = load_wav(os.path.join(man.root, u.wav), sample_rate)
    with torch.no_grad():
        feats, flens = log_mel_fbank(
            torch.from_numpy(audio)[None].to(device),
            torch.tensor([len(audio)], device=device), cmvn="none")
    return feats[0, : int(flens[0])].cpu().numpy()


def _moments(s1: np.ndarray, s2: np.ndarray, n: int) -> dict:
    mean = s1 / max(n, 1)
    return {"mean": mean.tolist(), "var": (s2 / max(n, 1) - mean ** 2).tolist(),
            "frames": int(n)}


def cmd_features(args):
    """Precompute fbank features (+ accumulate global CMVN stats in
    float64 over the saved fp32 arrays)."""
    device, corpus = _corpus(args)
    total_sum = np.zeros(80)
    total_sq = np.zeros(80)
    total_n = 0
    for accent, man in corpus:
        feat_dir = os.path.join(args.data_dir, "feats", accent)
        os.makedirs(feat_dir, exist_ok=True)
        lines = []
        for u in man.utts:
            arr = _fbank(man, u, args.sample_rate, device)
            rel = os.path.join("feats", accent, f"{u.utt_id}.npy")
            np.save(os.path.join(args.data_dir, rel), arr)
            a64 = arr.astype(np.float64)
            total_sum += a64.sum(0)
            total_sq += (a64 ** 2).sum(0)
            total_n += arr.shape[0]
            lines.append(json.dumps({
                "id": u.utt_id, "wav": u.wav, "feats": rel, "text": u.text,
                "phones": u.phones, "num_samples": u.num_samples,
            }))
        with open(os.path.join(args.data_dir, f"{accent}.jsonl"), "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"{accent}: features written")
    with open(os.path.join(args.data_dir, "cmvn_stats.json"), "w") as f:
        json.dump(_moments(total_sum, total_sq, total_n), f)
    print("global CMVN stats written")


def cmd_speaker_cmvn(args):
    """Per-speaker fbank mean/var stats -> speaker_cmvn.json."""
    device, corpus = _corpus(args)
    acc = {}
    for _, man in corpus:
        for u in man.utts:
            arr = _fbank(man, u, args.sample_rate, device).astype(np.float64)
            st = acc.setdefault(u.speaker, [np.zeros(80), np.zeros(80), 0])
            st[0] += arr.sum(0)
            st[1] += (arr ** 2).sum(0)
            st[2] += arr.shape[0]
    out = {spk: _moments(*st) for spk, st in acc.items()}
    path = os.path.join(args.data_dir, "speaker_cmvn.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print(f"{path}: {len(out)} speakers")


def cmd_vocab(args):
    from metaasr_tpu_torch.data.bpe import BPETokenizer
    from metaasr_tpu_torch.data.dataset import Manifest, discover_accents
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer, PhoneTokenizer

    texts = []
    for accent in discover_accents(args.data_dir):
        man = Manifest.load(os.path.join(args.data_dir, f"{accent}.jsonl"))
        for u in man.utts:
            texts.append(u.phones if args.type == "phone" else u.text)
    if args.type == "phone":
        tok = PhoneTokenizer.from_corpus(texts)
    elif args.type == "bpe":
        tok = BPETokenizer.from_corpus(texts, num_merges=args.bpe_merges)
    else:
        tok = CharTokenizer.from_corpus(texts)
    out = os.path.join(args.data_dir, f"vocab_{args.type}.json")
    tok.save(out)
    print(f"{out}: {tok.vocab_size} tokens")


def main(argv=None) -> int:
    p = argparse.ArgumentParser("prepare_data")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("synthetic")
    s.add_argument("--out", default="data/synthetic")
    s.add_argument("--accents", nargs="*", default=None)
    s.add_argument("--utts-per-accent", type=int, default=64)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_synthetic)

    s = sub.add_parser("commonvoice")
    s.add_argument("--tsv", required=True)
    s.add_argument("--clips-dir", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--accents", nargs="*", default=None)
    s.add_argument("--sample-rate", type=int, default=16000)
    s.add_argument("--min-sec", type=float, default=1.0)
    s.add_argument("--max-sec", type=float, default=16.0)
    s.add_argument("--max-per-accent", type=int, default=0)
    s.set_defaults(fn=cmd_commonvoice)

    for name, fn in (("features", cmd_features),
                     ("speaker-cmvn", cmd_speaker_cmvn)):
        s = sub.add_parser(name)
        s.add_argument("--data-dir", required=True)
        s.add_argument("--sample-rate", type=int, default=16000)
        s.add_argument("--device", default=None,
                       help="torch device of the fbank (default cuda; "
                       "'cpu' runs K1's plain version)")
        s.set_defaults(fn=fn)

    s = sub.add_parser("vocab")
    s.add_argument("--data-dir", required=True)
    s.add_argument("--type", choices=["char", "phone", "bpe"], default="char")
    s.add_argument("--bpe-merges", type=int, default=200)
    s.set_defaults(fn=cmd_vocab)

    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
