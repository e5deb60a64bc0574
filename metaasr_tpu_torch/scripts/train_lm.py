"""Train a token-level LSTM LM on the training accents' transcripts and save
it as an npz for shallow fusion at beam decode (counterpart of the
reference's ``scripts/train_lm.py``; the same options and file):

    python -m metaasr_tpu_torch.scripts.train_lm \
        --config configs/config3_fomaml.yaml --out lm.npz [--steps 500] \
        [--hidden 256] [--layers 2] [-o key=value ...] [--device cpu]

then decode with it:

    python -m metaasr_tpu_torch.cli --mode test --workdir WD \
        --decode-mode beam --lm-ckpt lm.npz --lm-weight 0.3

Held-out accents are excluded from the corpus (their text is the
evaluation target). The tokenizer is the ASR model's
(``cli.build_tokenizer``), so the LM scores the hypothesis space the beam
explores. Training runs on CUDA unless ``--device cpu`` is given; there the
LM's recurrence goes through K3 and its backward through K3b, one launch of
each per layer and step. The npz holds the Flax layout, readable by both
packages.
"""

from __future__ import annotations

import argparse
import os


def lm_corpus(data_dir: str, heldout) -> list[str]:
    from metaasr_tpu_torch.data.dataset import Manifest, discover_accents

    texts = []
    for accent in discover_accents(data_dir):
        if accent in set(heldout):
            continue
        man = Manifest.load(os.path.join(data_dir, f"{accent}.jsonl"))
        texts.extend(u.text for u in man.utts)
    return texts


def main(argv=None) -> str:
    from metaasr_tpu_torch.cli import _parse_override, build_tokenizer
    from metaasr_tpu_torch.config import load_config
    from metaasr_tpu_torch.device import resolve_device
    from metaasr_tpu_torch.models.lm import train_char_lm
    from metaasr_tpu_torch.train.checkpoint import save_tree_npz
    from metaasr_tpu_torch.weights import lm_state_dict_to_flax

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", default="", help="output npz path "
                    "(default <data_dir>/lm.npz)")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--embed-dim", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                    "PyTorch path)")
    ap.add_argument("-o", "--override", action="append", default=[])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config,
                      dict(_parse_override(kv) for kv in args.override))
    tok = build_tokenizer(cfg)
    texts = lm_corpus(cfg.data.data_dir, cfg.data.heldout_accents)
    if not texts:
        raise SystemExit(f"no transcripts under {cfg.data.data_dir}")
    print(f"LM corpus: {len(texts)} transcripts, vocab {tok.vocab_size}")

    _, params, nll = train_char_lm(
        texts, tok, embed_dim=args.embed_dim, hidden=args.hidden,
        layers=args.layers, steps=args.steps, batch_size=args.batch_size,
        lr=args.lr, seed=args.seed, log_every=max(1, args.steps // 10),
        device=device)

    out = args.out or os.path.join(cfg.data.data_dir, "lm.npz")
    save_tree_npz(out, lm_state_dict_to_flax(params))
    print(f"saved LM to {out} (final nll {nll:.4f}); decode with "
          f"--lm-ckpt {out} --lm-weight 0.3")
    return out


if __name__ == "__main__":
    main()
