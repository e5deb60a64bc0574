"""Serving throughput of a bundle on one NVIDIA GPU (counterpart of the
reference's ``scripts/serve_bench.py``: the same workload, record and
timing rule).

Does serving through a bundle (``write_bundle`` -> ``ServingDecoder``) cost
anything over the in-process decode? The workload is
``decode_bench.py``'s: the flagship model (d 256, 4 heads, d_ff 2048,
12 + 6 layers, bf16 compute, char vocabulary), 4 s utterances (400 feature
frames), beam 10, ``min_len = max_len = 48`` so every hypothesis runs all
48 steps, through a feature-mode bundle on bucket (16, 400). Weights come
from numpy seed 0 (``weights.random_state_dict``); the requests are the
reference's draws (numpy seed 0, after the draws its weights' init takes).

- sync: ``ServingDecoder.transcribe`` a batch (full read-back);
- pipelined: ``ServingDecoder.transcribe_stream``, every batch dispatched
  before any read. The search synchronises the host every beam step, so
  expect ``pipelined_speedup`` near 1;
- the same pipelined loop through a ``weights_dtype="bfloat16"`` bundle.
  The port keeps a bf16 bundle's weights as bf16 values in fp32 tensors and
  the model casts at each use, so the file halves and the weight reads do
  not: expect ``bf16_vs_fp32_weights`` near 1.

Each reading is the median of 3 passes over 8 batches of 16.
``sync_pipelined_texts_equal`` says whether both loops gave the same texts,
batch for batch.

Run on the card only (without CUDA it prints one JSON error line and
exits 1):

    python -m metaasr_tpu_torch.scripts.serve_bench

Prints a ``{"device": ...}`` line, then the record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.data.tokenizer import CharTokenizer
from metaasr_tpu_torch.scripts.bench import card
from metaasr_tpu_torch.scripts.decode_bench import median_of, no_card_line
from metaasr_tpu_torch.serve.export import ServingDecoder, write_bundle
from metaasr_tpu_torch.task import build_model
from metaasr_tpu_torch.weights import random_state_dict, state_dict_to_flax

T_FEAT = 400
BSZ = 16
BATCHES = 8
STEPS = 48
BEAM = 10


def bench_config():
    """-> (the flagship ``Config()`` with a char vocabulary, forced to 48
    decoder steps, its tokenizer)."""
    tok = CharTokenizer.ascii_default()
    cfg = Config()
    m = cfg.model
    m.arch, m.vocab_size = "transformer", tok.vocab_size
    m.d_model, m.num_heads, m.d_ff = 256, 4, 2048
    m.num_encoder_layers, m.num_decoder_layers = 12, 6
    m.dtype, m.dropout = "bfloat16", 0.0
    cfg.data.max_tokens = STEPS
    cfg.train.beam_size = BEAM
    cfg.train.beam_min_len = STEPS     # all 48 steps: worst-case timing
    return cfg, tok


def write_seeded_bundle(out_dir: str, cfg, tok, buckets, seed: int = 0,
                        weights_dtype: str = "float32") -> dict:
    """A feature-mode bundle of ``cfg``'s model with weights from numpy
    ``seed`` -> its manifest."""
    tree = state_dict_to_flax(random_state_dict(build_model(cfg), seed),
                              cfg.model.num_heads)
    return write_bundle(out_dir, cfg, tree, tok, buckets,
                        weights_dtype=weights_dtype, from_feats=True)


def draw_batches(vocab: int, batches: int = BATCHES) -> list[list[np.ndarray]]:
    """The reference's requests: numpy seed 0, past the example batch its
    weights' init draws, then ``batches`` x 16 [400, 80] float32 arrays."""
    rng = np.random.default_rng(0)
    rng.standard_normal((2, T_FEAT, 80))
    rng.integers(1, vocab - 1, (2, 8))
    return [[np.asarray(rng.standard_normal((T_FEAT, 80)), np.float32)
             for _ in range(BSZ)] for _ in range(batches)]


def record(batches: int, t_sync: float, t_pipe: float, t_pipe16: float,
           npz_bytes: int, npz16_bytes: int) -> dict:
    """The reference's record from the three loops' median seconds and the
    two ``params.npz`` sizes."""
    n_utts = BSZ * batches
    return {
        "mode": "exported-bundle serving", "batch": BSZ,
        "batches": batches, "beam": BEAM, "steps": STEPS,
        "sync_utts_per_sec": round(n_utts / t_sync, 1),
        "pipelined_utts_per_sec": round(n_utts / t_pipe, 1),
        "pipelined_speedup": round(t_sync / t_pipe, 2),
        "bf16_pipelined_utts_per_sec": round(n_utts / t_pipe16, 1),
        "bf16_vs_fp32_weights": round(t_pipe / t_pipe16, 2),
        "params_npz_mb": round(npz_bytes / 1e6, 1),
        "bf16_params_npz_mb": round(npz16_bytes / 1e6, 1),
    }


def measure(batches: int = BATCHES, *, device=None, passes: int = 3) -> dict:
    """Write the fp32 and bf16 bundles, serve ``batches`` batches of 16
    sync and pipelined (the median of 3 passes each, or of ``passes``,
    after one warm-up batch) -> :func:`record` plus
    ``sync_pipelined_texts_equal``."""
    cfg, tok = bench_config()
    feats_batches = draw_batches(tok.vocab_size, batches)
    texts = {}

    def pipelined_fn(dec, key):
        def run():
            texts[key] = [[r["text"] for r in res] for res in
                          dec.transcribe_stream(iter(feats_batches))]
        return run

    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as d16:
        write_seeded_bundle(d, cfg, tok, [(BSZ, T_FEAT)])
        dec = ServingDecoder(d, device=device)
        dec.transcribe(feats_batches[0])      # warm-up, drained by read-back

        def sync():
            texts["sync"] = [[r["text"] for r in dec.transcribe(b)]
                             for b in feats_batches]

        t_sync = median_of(sync, passes)
        t_pipe = median_of(pipelined_fn(dec, "pipelined"), passes)
        write_seeded_bundle(d16, cfg, tok, [(BSZ, T_FEAT)],
                            weights_dtype="bfloat16")
        dec16 = ServingDecoder(d16, device=device)
        dec16.transcribe(feats_batches[0])
        t_pipe16 = median_of(pipelined_fn(dec16, "bf16"), passes)
        sizes = [os.path.getsize(os.path.join(p, "params.npz"))
                 for p in (d, d16)]
    return {**record(batches, t_sync, t_pipe, t_pipe16, *sizes),
            "sync_pipelined_texts_equal": texts["sync"] == texts["pipelined"]}


def main(argv=None) -> int:
    argparse.ArgumentParser(description="serving throughput of a "
                            "feature-mode bundle on one GPU").parse_args(argv)
    if not torch.cuda.is_available():
        print(no_card_line("serve_bench"))
        return 1
    print(json.dumps({"device": card()}), flush=True)
    print(json.dumps(measure()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
