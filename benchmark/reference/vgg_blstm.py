"""The VGG-BLSTM CTC phone recognizer as plain functions of a parameter dict.

Two VGG blocks, each two 3x3 SAME convolutions with ReLU and a 2x2 max-pool
(time and frequency / 4), flattened channel fastest; four bidirectional
LSTM layers of 320 units, gates (i, f, g, o), the forget gate's
pre-activation + 1, the backward direction run over each utterance's valid
frames reversed; outputs past each utterance's length zeroed; a linear CTC
head. Loss: the mean over utterances of the CTC negative log likelihood.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.numerics import Precision
from benchmark.reference.transformer import ctc_nll


def reverse_valid(x, lens):
    """Reverse each row's first ``lens`` steps of [B, T, ...]."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :].expand(x.shape[0], -1)
    lens = lens.long()[:, None]
    idx = torch.where(pos < lens, lens - 1 - pos, pos)
    return torch.gather(x, 1, idx[..., None].expand_as(x))


class VGGBLSTM:
    def __init__(self, P: dict, layers: int = 4,
                 precision: Precision | None = None):
        self.P, self.layers = P, layers
        self.prec = precision or Precision("fp32")

    def lstm(self, name, x, lens, reverse):
        P, prec = self.P, self.prec
        if reverse:
            x = reverse_valid(x, lens)
        gx = prec.linear(x, P[f"{name}.input_proj.weight"],
                         P[f"{name}.input_proj.bias"])
        u = P[f"{name}.recurrent"]
        hidden = u.shape[0]
        h = gx.new_zeros((x.shape[0], hidden))
        c = torch.zeros_like(h)
        out = []
        for t in range(x.shape[1]):
            g = gx[:, t] + prec.matmul(h, u)
            i, f, gg, o = g.split(hidden, dim=1)
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        hs = torch.stack(out, 1)
        return reverse_valid(hs, lens) if reverse else hs

    def logits(self, feats, flen):
        P, prec = self.P, self.prec
        mask = torch.arange(feats.shape[1], device=feats.device)[None, :] \
            < flen.long()[:, None]
        x = torch.where(mask[..., None], feats, 0.0)[:, None]
        for b in (0, 1):
            for c in (0, 1):
                x = F.relu(prec.conv2d(x, P[f"vgg.conv{b}_{c}.weight"],
                                       P[f"vgg.conv{b}_{c}.bias"],
                                       padding=1))
            x = F.max_pool2d(x, 2, 2)
        b, ch, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * ch)
        lens = torch.div(torch.div(flen.long(), 2, rounding_mode="floor"), 2,
                         rounding_mode="floor").clamp_min(1)
        valid = (torch.arange(t, device=x.device)[None, :]
                 < lens[:, None])[..., None]
        for i in range(self.layers):
            x = torch.cat([self.lstm(f"blstm.fwd_{i}", x, lens, False),
                           self.lstm(f"blstm.bwd_{i}", x, lens, True)], -1)
            x = torch.where(valid, x, 0.0)
        return prec.linear(x, P["ctc_head.weight"], P["ctc_head.bias"]), lens

    def loss(self, feats, flen, tokens, token_lens, gen=None):
        logits, lens = self.logits(feats, flen)
        return ctc_nll(logits, lens, tokens, token_lens).mean().float()
