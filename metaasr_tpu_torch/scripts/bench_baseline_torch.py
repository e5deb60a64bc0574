"""PyTorch reference-style FOMAML meta-step baseline, on the card
(counterpart of the reference's ``bench_baseline_torch.py``).

Reproduces the REFERENCE's orchestration (SURVEY.md section 3.1): per accent
task, ``copy.deepcopy`` the model, run k inner SGD steps on the support
batch, compute the query gradient on the adapted copy, apply it to the
original — sequentially per task. Same model shape / data sizes as the
bench, so utts/sec is comparable. The reference could run it only on the
CPU; here it runs on the device it is given (the card, in the same process
as the port's bench), at PyTorch's default precision (no TF32 for matrix
products), as its authors would run it.

Run standalone: python -m metaasr_tpu_torch.scripts.bench_baseline_torch
-> prints JSON {utts_per_sec} (CUDA; no CPU fallback).
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import time

import numpy as np
import torch
import torch.nn as nn

# Bench workload (must match bench.py)
M_TASKS = 4
K_SUPPORT = 4
K_QUERY = 4
INNER_STEPS = 3
NUM_SAMPLES = 64000
NUM_TOKENS = 32
VOCAB = 30
D_MODEL = 256
HEADS = 4
FF = 2048
ENC_LAYERS = 12
DEC_LAYERS = 6


class Subsample(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.c1 = nn.Conv2d(1, d, 3, stride=2)
        self.c2 = nn.Conv2d(d, d, 3, stride=2)
        self.proj = nn.Linear(d * 19, d)  # 80 -> 39 -> 19 freq bins

    def forward(self, x):  # [B, T, 80]
        x = torch.relu(self.c2(torch.relu(self.c1(x.unsqueeze(1)))))
        b, c, t, f = x.shape
        return self.proj(x.permute(0, 2, 1, 3).reshape(b, t, c * f))


class TorchASR(nn.Module):
    def __init__(self):
        super().__init__()
        self.sub = Subsample(D_MODEL)
        enc = nn.TransformerEncoderLayer(D_MODEL, HEADS, FF, 0.1,
                                         batch_first=True, norm_first=True)
        self.encoder = nn.TransformerEncoder(enc, ENC_LAYERS)
        dec = nn.TransformerDecoderLayer(D_MODEL, HEADS, FF, 0.1,
                                         batch_first=True, norm_first=True)
        self.decoder = nn.TransformerDecoder(dec, DEC_LAYERS)
        self.embed = nn.Embedding(VOCAB, D_MODEL)
        self.ctc_head = nn.Linear(D_MODEL, VOCAB)
        self.out = nn.Linear(D_MODEL, VOCAB)
        self.ctc = nn.CTCLoss(blank=0, zero_infinity=True)

    def forward(self, feats, tokens):
        enc = self.encoder(self.sub(feats))
        ctc_lp = self.ctc_head(enc).log_softmax(-1)
        t_len = ctc_lp.shape[1]
        in_tok = torch.cat([torch.full_like(tokens[:, :1], VOCAB - 1), tokens],
                           dim=1)
        mask = nn.Transformer.generate_square_subsequent_mask(
            in_tok.shape[1], device=feats.device)
        dec = self.decoder(self.embed(in_tok), enc, tgt_mask=mask)
        att_logits = self.out(dec)
        tgt_out = torch.cat([tokens, torch.full_like(tokens[:, :1], VOCAB - 1)],
                            dim=1)
        l_att = nn.functional.cross_entropy(
            att_logits.reshape(-1, VOCAB), tgt_out.reshape(-1),
            label_smoothing=0.1)
        lens = torch.full((feats.shape[0],), t_len, dtype=torch.long)
        tok_lens = torch.full((tokens.shape[0],), tokens.shape[1],
                              dtype=torch.long)
        l_ctc = self.ctc(ctc_lp.permute(1, 0, 2), tokens, lens, tok_lens)
        return 0.3 * l_ctc + 0.7 * l_att


def fbank_stub(audio: torch.Tensor) -> torch.Tensor:
    """Matmul-DFT fbank equivalent workload (frames -> 80 mel), its tables
    made on the audio's device."""
    dev = audio.device
    frames = audio.unfold(1, 400, 160)  # [B, F, 400]
    win = torch.hann_window(400, device=dev) ** 0.85
    k = torch.arange(256, device=dev)[None, :]
    n = torch.arange(400, device=dev)[:, None]
    cos = torch.cos(2 * math.pi * n * k / 512)
    sin = torch.sin(2 * math.pi * n * k / 512)
    fw = frames * win
    power = (fw @ cos) ** 2 + (fw @ sin) ** 2
    mel = torch.rand(256, 80, device=dev)  # weights irrelevant for timing
    feats = torch.log(torch.clamp(power @ mel, min=1e-7))
    return feats - feats.mean(dim=1, keepdim=True)


def _draw(rng, k, device):
    audio = torch.from_numpy(
        0.1 * rng.standard_normal((k, NUM_SAMPLES)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(1, VOCAB - 1, (k, NUM_TOKENS)))
    return audio.to(device), tokens.to(device)


def meta_step(model, opt, rng):
    """Reference orchestration: sequential tasks, deepcopy per task; the
    batches drawn on the host each inner step and copied to the model's
    device."""
    device = next(model.parameters()).device
    outer_grads = None
    for _ in range(M_TASKS):
        fast = copy.deepcopy(model)
        inner_opt = torch.optim.SGD(fast.parameters(), lr=1e-2)
        for _ in range(INNER_STEPS):
            audio, tokens = _draw(rng, K_SUPPORT, device)
            loss = fast(fbank_stub(audio), tokens)
            inner_opt.zero_grad()
            loss.backward()
            inner_opt.step()
        audio, tokens = _draw(rng, K_QUERY, device)
        q_loss = fast(fbank_stub(audio), tokens)
        fast.zero_grad()
        q_loss.backward()
        grads = [p.grad.detach().clone() for p in fast.parameters()]
        outer_grads = grads if outer_grads is None else [
            a + b for a, b in zip(outer_grads, grads)]
    for p, g in zip(model.parameters(), outer_grads):
        p.grad = g / M_TASKS
    opt.step()
    opt.zero_grad()
    return q_loss.detach()


@contextlib.contextmanager
def default_precision():
    """PyTorch's own fp32 defaults inside (no TF32 for matrix products,
    TF32 for cuDNN convolutions), whatever policy the process set; the
    flags as they were after."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def measure(steps: int = 2, device="cuda") -> float:
    """Presentations/s: 1 warm-up meta-step, then ``steps`` timed ones
    ending in a device synchronise."""
    from metaasr_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    with default_precision():
        torch.manual_seed(0)
        rng = np.random.default_rng(0)
        model = TorchASR().to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        meta_step(model, opt, rng)  # warmup
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.time()
        for _ in range(steps):
            loss = meta_step(model, opt, rng)
        float(loss)
        dt = (time.time() - t0) / steps
    utts = M_TASKS * (K_SUPPORT * INNER_STEPS + K_QUERY)
    return utts / dt


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print(json.dumps({"utts_per_sec": None,
                          "error": "no CUDA device: the baseline runs on "
                                   "the card only"}))
        raise SystemExit(1)
    ups = measure()
    print(json.dumps({"utts_per_sec": ups,
                      "hardware": torch.cuda.get_device_name(0),
                      "style": "reference copy-the-model FOMAML"}))
