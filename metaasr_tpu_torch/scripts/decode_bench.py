"""Batched beam-search decode throughput of the port on one NVIDIA GPU
(counterpart of the reference's ``scripts/decode_bench.py``: the same
workload, rows, keys and timing rule).

Times ``decode/beam_search.py::beam_search_transformer`` on the flagship
model (d 256, 4 heads, d_ff 2048, 12 encoder / 6 decoder layers, bf16
compute, vocab 30) at 4 s-utterance shapes (400 feature frames -> 99
encoder frames), beam 10, CTC weight 0.3, with ``min_len = max_len = 48``
so every hypothesis runs all 48 decoder steps: a worst case that does not
depend on what hypotheses random weights make. The model's weights come
from numpy seed 0 (``weights.random_state_dict``), the LM's from a
``torch.Generator`` seeded 1; the JAX package's ``PRNGKey`` draws cannot be
matched. The inputs are the reference's draws (numpy seed 0; seed 1 for the
pipelined batches).

Timing: the median of 3 passes, each ended by a host read of one length
(``int(out["lengths"][0, 0])``).

- :func:`measure`: the latency of one batch (the ``ms_per_batch`` rows);
- :func:`measure_pipelined`: serving-mode throughput with the full read-back
  of tokens and lengths per batch, every batch dispatched before any read,
  beside its own sync-read loop and the packed read-back
  (``serve.pack_decode_outputs``: one int32 tensor, one copy to the host a
  batch). The search synchronises the host at every beam step (the
  early-exit test and the CTC prefix loop's frame count), so a second batch
  cannot be queued while the first runs: expect the three loops close.

Run on the card only (without CUDA it prints one JSON error line and
exits 1):

    python -m metaasr_tpu_torch.scripts.decode_bench [--bpe-only]

Prints a ``{"device": ...}`` line (``nvidia-smi``'s name and power limit),
then one JSON line per row.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from metaasr_tpu_torch.decode.beam_search import (
    BeamSearchConfig,
    beam_search_transformer,
)
from metaasr_tpu_torch.device import resolve_device
from metaasr_tpu_torch.models.lm import LSTMLM
from metaasr_tpu_torch.models.transformer import TransformerASR
from metaasr_tpu_torch.scripts.bench import card
from metaasr_tpu_torch.serve.export import (
    pack_decode_outputs,
    unpack_decode_outputs,
)
from metaasr_tpu_torch.weights import random_state_dict

VOCAB = 30
T_FEAT = 400          # 4 s at 10 ms hop
AUDIO_SEC = 4.0
STEPS = 48

# the reference's flagship model (its _setup) and fusion LM (train_lm's
# defaults)
MODEL = {"d_model": 256, "num_heads": 4, "d_ff": 2048,
         "num_encoder_layers": 12, "num_decoder_layers": 6,
         "dtype": "bfloat16"}
LM = {"embed_dim": 128, "hidden": 256, "layers": 2}
MODEL_SEED, LM_SEED = 0, 1


def no_card_line(name: str) -> str:
    return json.dumps({"bench": name, "error": f"no CUDA device: {name} "
                       "runs on the card only (a CPU reading is never "
                       "written as the card's)"})


def draw_inputs(bsz: int, vocab: int = VOCAB):
    """The reference's draws (numpy seed 0, in its order): feats [B, 400, 80]
    float32, lens [B] int32 and the tokens [B, 8] int32 its weights' init
    takes (unused here)."""
    rng = np.random.default_rng(0)
    feats = np.asarray(rng.standard_normal((bsz, T_FEAT, 80)), np.float32)
    lens = np.full((bsz,), T_FEAT, np.int32)
    toks = np.asarray(rng.integers(1, vocab - 1, (bsz, 8)), np.int32)
    return feats, lens, toks


def pipelined_feats(bsz: int, nbatches: int) -> list[np.ndarray]:
    """The reference's further batches of the pipelined row: numpy seed 1,
    ``nbatches - 1`` feats [B, 400, 80] float32."""
    rng = np.random.default_rng(1)
    return [np.asarray(rng.standard_normal((bsz, T_FEAT, 80)), np.float32)
            for _ in range(nbatches - 1)]


class Decode:
    """The bench's model, LM, inputs and search options on one device;
    calling it runs one search -> the outputs on the device."""

    def __init__(self, bsz: int, beam: int, lm_weight: float, vocab: int,
                 ctc_candidates: int, device):
        dev = resolve_device(device)
        dims = {k: v for k, v in MODEL.items() if k != "dtype"}
        model = TransformerASR(vocab_size=vocab, dropout=0.0,
                               dtype=getattr(torch, MODEL["dtype"]), **dims)
        model.load_state_dict(random_state_dict(model, MODEL_SEED))
        self.model = model.to(dev).eval()
        self.lm = None
        if lm_weight:
            self.lm = LSTMLM(vocab_size=vocab, **LM,
                             generator=torch.Generator().manual_seed(LM_SEED)
                             ).to(dev).eval()
        self.cfg = BeamSearchConfig(beam_size=beam, max_len=STEPS,
                                    min_len=STEPS, ctc_weight=0.3,
                                    lm_weight=lm_weight,
                                    ctc_candidates=ctc_candidates)
        self.eos = vocab - 1
        feats, lens, _ = draw_inputs(bsz, vocab)
        self.feats = torch.from_numpy(feats).to(dev)
        self.lens = torch.from_numpy(lens).to(dev)
        self.device = dev

    def __call__(self, feats=None) -> dict:
        with torch.inference_mode():
            return beam_search_transformer(
                self.model, self.feats if feats is None else feats,
                self.lens, self.eos, self.cfg, lm_model=self.lm)


def _setup(bsz: int, beam: int, lm_weight: float = 0.0, vocab: int = VOCAB,
           ctc_candidates: int = 0, *, device=None) -> Decode:
    """The shared set-up of both modes: build, then one search drained by a
    host read (its first call builds whatever is lazy)."""
    run = Decode(bsz, beam, lm_weight, vocab, ctc_candidates, device)
    _ = int(run()["lengths"][0, 0])
    return run


def median3(run_pass) -> float:
    """The reference's rule: 3 passes of ``run_pass`` -> the median's
    seconds."""
    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_pass()
        dts.append(time.perf_counter() - t0)
    return sorted(dts)[1]


def row(bsz: int, beam: int, dt: float, lm_weight: float = 0.0,
        vocab: int = VOCAB, ctc_candidates: int = 0) -> dict:
    """:func:`measure`'s row from the median pass's seconds."""
    out = {"batch": bsz, "beam": beam, "decode_steps": STEPS,
           "ms_per_batch": round(dt * 1e3, 1),
           "utts_per_sec": round(bsz / dt, 1),
           "rtf": round(dt / (bsz * AUDIO_SEC), 5)}
    if lm_weight:
        out["lm_weight"] = lm_weight
    if vocab != VOCAB:
        out["vocab"] = vocab
    if ctc_candidates:
        out["ctc_candidates"] = ctc_candidates
    return out


def measure(bsz: int, beam: int = 10, lm_weight: float = 0.0,
            vocab: int = VOCAB, ctc_candidates: int = 0, *,
            device=None) -> dict:
    """The latency row of one batch; ``hyp_lengths`` is [min, max] of the
    last pass's hypothesis lengths (STEPS, both, when the forced length
    held)."""
    run = _setup(bsz, beam, lm_weight, vocab, ctc_candidates, device=device)
    last = {}

    def one_pass():
        last["out"] = run()
        _ = int(last["out"]["lengths"][0, 0])

    out = row(bsz, beam, median3(one_pass), lm_weight, vocab,
              ctc_candidates)
    lengths = last["out"]["lengths"]
    out["hyp_lengths"] = [int(lengths.min()), int(lengths.max())]
    return out


def pipelined_row(bsz: int, beam: int, nbatches: int, dt_sync: float,
                  dt_pipe: float, dt_packed: float) -> dict:
    """:func:`measure_pipelined`'s row from the three loops' median
    seconds."""
    return {"batch": bsz, "beam": beam, "decode_steps": STEPS,
            "mode": "pipelined", "nbatches": nbatches,
            "ms_per_batch": round(dt_pipe / nbatches * 1e3, 1),
            "utts_per_sec": round(nbatches * bsz / dt_pipe, 1),
            "sync_read_utts_per_sec": round(nbatches * bsz / dt_sync, 1),
            "speedup_vs_sync_read": round(dt_sync / dt_pipe, 2),
            "packed_readback_utts_per_sec":
                round(nbatches * bsz / dt_packed, 1),
            "packed_vs_dict_readback": round(dt_pipe / dt_packed, 2),
            "rtf": round(dt_pipe / (nbatches * bsz * AUDIO_SEC), 5)}


def same_readback(out: dict) -> bool:
    """The packed read-back of ``out`` equals its dict read-back: tokens
    and lengths exact, scores bit-equal."""
    got = unpack_decode_outputs(pack_decode_outputs(out))
    want = {k: out[k].cpu().numpy() for k in ("tokens", "lengths", "scores")}
    return (np.array_equal(got["tokens"], want["tokens"])
            and np.array_equal(got["lengths"], want["lengths"])
            and got["scores"].tobytes()
            == want["scores"].astype(np.float32).tobytes())


def measure_pipelined(bsz: int, beam: int = 10, nbatches: int = 8, *,
                      device=None) -> dict:
    """Serving-mode throughput: every batch dispatched before any host read,
    full tokens + lengths read back per batch; beside it the sync-read loop
    (same read-back) and the packed loop (one int32 tensor, one copy to
    the host a batch). ``packed_equals_dict``: :func:`same_readback` of
    the pipelined loop's last batch."""
    run = _setup(bsz, beam, device=device)
    feats = [run.feats] + [torch.from_numpy(f).to(run.device)
                           for f in pipelined_feats(bsz, nbatches)]
    last = {}

    def read(out):
        _ = out["tokens"].cpu().numpy()
        _ = out["lengths"].cpu().numpy()

    def sync():
        for f in feats:
            read(run(f))

    def pipelined():
        outs = [run(f) for f in feats]              # all dispatched
        for out in outs:
            read(out)
        last["out"] = outs[-1]

    dt_sync, dt_pipe = median3(sync), median3(pipelined)
    _ = unpack_decode_outputs(pack_decode_outputs(run(feats[0])))

    def packed():
        outs = [pack_decode_outputs(run(f)) for f in feats]
        for out in outs:
            unpack_decode_outputs(out)              # the one copy a batch

    dt_packed = median3(packed)
    return {**pipelined_row(bsz, beam, nbatches, dt_sync, dt_pipe,
                            dt_packed),
            "packed_equals_dict": same_readback(last["out"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="beam-search decode "
                                 "throughput of the port on one GPU")
    ap.add_argument("--bpe-only", action="store_true",
                    help="run only the BPE-scale vocab rows")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(no_card_line("decode_bench"))
        return 1
    print(json.dumps({"device": card()}), flush=True)
    if not args.bpe_only:
        for bsz in (16, 64):
            print(json.dumps(measure(bsz)), flush=True)
        # fusion overhead: the same search with a 2 x 256 LSTM LM in step
        print(json.dumps(measure(16, lm_weight=0.3)), flush=True)
        # serving-mode pipelined throughput (full token read-back a batch)
        print(json.dumps(measure_pipelined(16)), flush=True)
    # BPE-scale rows: vocab 512 with CTC candidate pruning, and the full
    # vocabulary (ctc_candidates -1) at B = 4, as the reference runs them
    for bsz, cand in ((16, 40), (16, 80), (4, 40), (4, -1)):
        print(json.dumps(measure(bsz, vocab=512, ctc_candidates=cand)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
