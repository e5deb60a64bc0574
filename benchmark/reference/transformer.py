"""The joint CTC-attention transformer (Hsu, Chen & Lee, ICASSP 2020, after
ESPnet's recipe) as plain functions of a parameter dict.

Encoder: two 3x3 stride-2 convolutions with ReLU over [T, 80] features,
their (frequency, channel) outputs flattened channel fastest and projected
to d; x * sqrt(d) plus sinusoidal positions; pre-LayerNorm layers
(self-attention, then a ReLU feed-forward); a final LayerNorm; frames past
each utterance's length zeroed. Decoder: embeddings * sqrt(d) plus
positions, pre-LayerNorm layers of causal self-attention, cross-attention
and feed-forward, a final LayerNorm and the output projection. LayerNorm
epsilon 1e-6. Dropout (rate 0.1 in training) after the positions of the
encoder, after every residual branch and inside every feed-forward, drawn
as ``rand < 0.9`` from the step's generator in the order the layers run.

Loss: 0.3 * CTC (mean over utterances of the negative log likelihood,
blank 0, infeasible rows 0) + 0.7 * KL divergence to the label-smoothed
(0.1) target, averaged over the target positions (the tokens and eos).
The decoder reads sos + tokens; sos and eos share the last id.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.numerics import Precision

NEG = -1e9
LN_EPS = 1e-6


def positions(length: int, d: int, device) -> torch.Tensor:
    pos = np.arange(length)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    pe = np.zeros((length, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device)


def layer_norm(P, name, x):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"],
                        P[f"{name}.bias"], LN_EPS)


def dropout(x, gen, rate):
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=gen, device=x.device)
    return torch.where(u < keep, x / keep, 0.0)


def pad_bias(lens, length):
    pos = torch.arange(length, device=lens.device)[None, :]
    return torch.where(pos < lens.long()[:, None], 0.0, NEG)[:, None, None, :]


class Transformer:
    def __init__(self, P: dict, heads: int = 4, enc_layers: int = 12,
                 dec_layers: int = 6, dropout: float = 0.1,
                 precision: Precision | None = None):
        self.P, self.heads = P, heads
        self.enc_layers, self.dec_layers = enc_layers, dec_layers
        self.rate = dropout
        self.prec = precision or Precision("fp32")
        self.d = P["decoder.embed.weight"].shape[1]

    def dense(self, name, x):
        return self.prec.linear(x, self.P[f"{name}.weight"],
                                self.P[f"{name}.bias"])

    def attend(self, q, k, v, bias):
        """q [B, Q, H, Dh], k / v [B, K, H, Dh]."""
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        scores = self.prec.matmul(q, k.transpose(2, 3)) / math.sqrt(
            q.shape[-1]) + bias
        out = self.prec.matmul(torch.softmax(scores, dim=-1), v)
        return out.transpose(1, 2)

    def self_attention(self, name, x, bias):
        b, n, d = x.shape
        q, k, v = self.dense(f"{name}.qkv", x).view(
            b, n, 3, self.heads, -1).unbind(2)
        return self.dense(f"{name}.out",
                          self.attend(q, k, v, bias).reshape(b, n, d))

    def cross_attention(self, name, x, enc, bias):
        b, n, d = x.shape
        t = enc.shape[1]
        q = self.dense(f"{name}.q", x).view(b, n, self.heads, -1)
        k = self.dense(f"{name}.k", enc).view(b, t, self.heads, -1)
        v = self.dense(f"{name}.v", enc).view(b, t, self.heads, -1)
        return self.dense(f"{name}.out",
                          self.attend(q, k, v, bias).reshape(b, n, d))

    def feed_forward(self, name, x, gen):
        h = dropout(torch.relu(self.dense(f"{name}.fc1", x)), gen, self.rate)
        return self.dense(f"{name}.fc2", h)

    def encode(self, feats, flen, gen=None):
        P, prec = self.P, self.prec
        mask = torch.arange(feats.shape[1], device=feats.device)[None, :] \
            < flen.long()[:, None]
        x = torch.where(mask[..., None], feats, 0.0)[:, None]
        for i in (0, 1):
            x = torch.relu(prec.conv2d(
                x, P[f"encoder.subsample.conv{i}.weight"],
                P[f"encoder.subsample.conv{i}.bias"], stride=2))
        b, c, t, f = x.shape
        x = self.dense("encoder.subsample.proj",
                       x.permute(0, 2, 3, 1).reshape(b, t, f * c))
        lens = flen.long()
        for _ in range(2):
            lens = torch.div(lens - 1, 2, rounding_mode="floor")
        lens = lens.clamp_min(1)
        x = x * math.sqrt(self.d) + positions(t, self.d, x.device)
        x = dropout(x, gen, self.rate)
        bias = pad_bias(lens, t)
        for i in range(self.enc_layers):
            n = f"encoder.layers.{i}"
            y = self.self_attention(f"{n}.self_attn",
                                    layer_norm(P, f"{n}.norm1", x), bias)
            x = x + dropout(y, gen, self.rate)
            y = self.feed_forward(f"{n}.ff", layer_norm(P, f"{n}.norm2", x),
                                  gen)
            x = x + dropout(y, gen, self.rate)
        x = layer_norm(P, "encoder.final_norm", x)
        valid = torch.arange(t, device=x.device)[None, :] < lens[:, None]
        return torch.where(valid[..., None], x, 0.0), lens

    def ctc_logits(self, enc):
        return self.dense("ctc_head", enc)

    def loss(self, feats, flen, tokens, token_lens, gen=None):
        return joint_loss(self, feats, flen, tokens, token_lens, gen)

    def decode(self, tokens_in, in_lens, enc, enc_lens, gen=None):
        """Teacher-forced: tokens_in [B, U] (sos first) -> logits [B, U, V]."""
        P = self.P
        u = tokens_in.shape[1]
        x = P["decoder.embed.weight"][tokens_in.long()] * math.sqrt(self.d) \
            + positions(u, self.d, enc.device)
        causal = torch.where(
            torch.arange(u, device=enc.device)[None, :]
            <= torch.arange(u, device=enc.device)[:, None], 0.0, NEG)
        self_bias = causal[None, None] + pad_bias(in_lens, u)
        cross_bias = pad_bias(enc_lens, enc.shape[1])
        for i in range(self.dec_layers):
            n = f"decoder.layers.{i}"
            y = self.self_attention(f"{n}.self_attn",
                                    layer_norm(P, f"{n}.norm1", x), self_bias)
            x = x + dropout(y, gen, self.rate)
            y = self.cross_attention(f"{n}.cross_attn",
                                     layer_norm(P, f"{n}.norm2", x), enc,
                                     cross_bias)
            x = x + dropout(y, gen, self.rate)
            y = self.feed_forward(f"{n}.ff", layer_norm(P, f"{n}.norm3", x),
                                  gen)
            x = x + dropout(y, gen, self.rate)
        return self.dense("decoder.out_proj",
                          layer_norm(P, "decoder.final_norm", x))


def ctc_nll(logits, lens, tokens, token_lens):
    """[B] CTC negative log likelihoods in float64, infeasible rows 0."""
    logp = torch.log_softmax(logits.float(), dim=-1).double()
    return F.ctc_loss(logp.transpose(0, 1), tokens.long(), lens.long(),
                      token_lens.long(), blank=0, reduction="none",
                      zero_infinity=True)


def smoothed_kl(logits, targets, mask, eps: float = 0.1):
    vocab = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    on, off = 1.0 - eps, eps / (vocab - 1)
    tgt = logp.gather(-1, targets.long()[..., None])[..., 0]
    xent = -(on * tgt + off * (logp.sum(-1) - tgt))
    entropy = -(on * math.log(on) + (vocab - 1) * off * math.log(off))
    kl = torch.where(mask, xent - entropy, 0.0)
    return kl.sum() / mask.sum().clamp_min(1)


def joint_loss(model: Transformer, feats, flen, tokens, token_lens, gen=None,
               ctc_weight: float = 0.3, smoothing: float = 0.1):
    """-> scalar loss (float32) of one batch, dropout drawn from ``gen``."""
    sos = model.P["decoder.embed.weight"].shape[0] - 1
    bsz, u = tokens.shape
    tokens = tokens.long()
    tokens_in = torch.cat([torch.full((bsz, 1), sos, device=tokens.device,
                                      dtype=torch.long), tokens], 1)
    pos = torch.arange(u + 1, device=tokens.device)[None, :]
    lens = token_lens.long()[:, None]
    targets = torch.cat([tokens, torch.zeros_like(tokens[:, :1])], 1) \
        * (pos < lens) + torch.where(pos == lens, sos, 0)
    enc, enc_lens = model.encode(feats, flen, gen)
    ctc = ctc_nll(model.ctc_logits(enc), enc_lens, tokens,
                  token_lens).mean().float()
    att = smoothed_kl(model.decode(tokens_in, token_lens + 1, enc, enc_lens,
                                   gen), targets, pos <= lens, smoothing)
    return ctc_weight * ctc + (1.0 - ctc_weight) * att
