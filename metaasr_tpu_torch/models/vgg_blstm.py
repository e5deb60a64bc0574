"""VGG-BLSTM CTC phone recognizer, the baseline model (counterpart of
``metaasr_tpu/models/vgg_blstm.py``): two VGG blocks (each 2 x conv3x3 +
ReLU, then a 2x2 max-pool: time and frequency / 4) -> a stack of
bidirectional LSTM layers -> linear -> CTC logits.

- The input projection of a whole sequence is one ``F.linear``; only the
  recurrence ``h @ U`` runs step by step, in K3/K3b
  (``ops/lstm_kernel.py``) or, with ``impl="scan"``, as a Python loop under
  autograd.
- The backward direction flips each row's valid prefix before and after the
  recurrence (:func:`flip_padded`), so padded frames always come after the
  valid ones and never reach a valid output; the BLSTM masks its outputs.
- Activations are NCHW inside the extractor; its output is flattened with
  the channel fastest, ``[B, T/4, (D/4)*C]``, as the reference's NHWC reshape
  gives it, so the first LSTM's input projection reads the same feature
  axis. The recurrent matrix is one fp32 ``[H, 4H]`` parameter, gate order
  (i, f, g, o).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from metaasr_tpu_torch.models.transformer import Dense
from metaasr_tpu_torch.ops.lstm_kernel import lstm_recurrence, lstm_scan
from metaasr_tpu_torch.utils.padding import (
    make_non_pad_mask,
    vgg_subsampled_lengths,
)

LSTM_IMPLS = ("auto", "pallas", "scan")


def flip_padded(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Reverse each sequence's valid prefix; padding stays at the end.
    x [B, T, ...], lens [B]. Applying it twice restores the valid part."""
    t_len = x.shape[1]
    lens = lens.to(torch.int64)[:, None]
    pos = torch.arange(t_len, device=x.device)[None, :].expand(x.shape[0], -1)
    idx = torch.where(pos < lens, lens - 1 - pos, pos)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return torch.gather(x, 1, idx)


class LSTMLayer(nn.Module):
    """One direction of an LSTM over padded [B, T, D].

    ``impl``: "auto" or "pallas" -> the K3/K3b recurrence (the CUDA kernels
    on CUDA tensors, their plain version on CPU tensors; first order only);
    "scan" -> the step loop under autograd (any order)."""

    def __init__(self, in_features: int, hidden: int, reverse: bool = False,
                 dtype: torch.dtype = torch.float32, impl: str = "auto"):
        super().__init__()
        if impl not in LSTM_IMPLS:
            raise ValueError(f"unknown lstm_impl {impl!r}")
        self.hidden = hidden
        self.reverse = reverse
        self.compute_dtype = dtype
        self.impl = impl
        self.input_proj = Dense(in_features, 4 * hidden, dtype)
        self.recurrent = nn.Parameter(torch.empty(hidden, 4 * hidden))
        nn.init.orthogonal_(self.recurrent)

    def forward(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        if self.reverse:
            x = flip_padded(x, lens)
        gx = self.input_proj(x).transpose(0, 1)               # [T, B, 4H]
        if self.impl == "scan":
            hs = lstm_scan(gx, self.recurrent.to(self.compute_dtype))
        else:
            hs = lstm_recurrence(gx.to(torch.float32).contiguous(),
                                 self.recurrent.to(torch.float32).contiguous())
        out = hs.transpose(0, 1)                              # [B, T, H]
        if self.reverse:
            out = flip_padded(out, lens)
        return out


class BLSTM(nn.Module):
    """Stack of bidirectional LSTM layers with output masking."""

    def __init__(self, in_features: int, hidden: int, layers: int,
                 dtype: torch.dtype = torch.float32, lstm_impl: str = "auto"):
        super().__init__()
        self.num_layers = layers
        for i in range(layers):
            d_in = in_features if i == 0 else 2 * hidden
            setattr(self, f"fwd_{i}",
                    LSTMLayer(d_in, hidden, False, dtype, lstm_impl))
            setattr(self, f"bwd_{i}",
                    LSTMLayer(d_in, hidden, True, dtype, lstm_impl))

    def forward(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        mask = make_non_pad_mask(lens, x.shape[1])[..., None]
        for i in range(self.num_layers):
            fwd = getattr(self, f"fwd_{i}")(x, lens)
            bwd = getattr(self, f"bwd_{i}")(x, lens)
            x = torch.cat([fwd, bwd], dim=-1)
            x = torch.where(mask, x, 0.0)
        return x


class _SameConv(nn.Conv2d):
    """3x3 stride-1 SAME convolution computing in ``compute_dtype``."""

    def __init__(self, in_ch: int, out_ch: int, compute_dtype: torch.dtype):
        super().__init__(in_ch, out_ch, 3, padding=1)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, padding=1)
        return y + self.bias.to(dt)[None, :, None, None]


class VGGExtractor(nn.Module):
    """Two VGG blocks: (conv3x3 x 2, maxpool 2x2) x 2 => T/4, freq/4.
    feats [B, T, D] -> [B, T/4, (D/4)*C], channel fastest."""

    def __init__(self, channels=(64, 128),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels = tuple(channels)
        in_ch = 1
        for bi, ch in enumerate(self.channels):
            for ci in range(2):
                setattr(self, f"conv{bi}_{ci}", _SameConv(in_ch, ch, dtype))
                in_ch = ch

    def out_features(self, feat_dim: int) -> int:
        for _ in self.channels:
            feat_dim //= 2
        return feat_dim * self.channels[-1]

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats[:, None]                                    # [B, 1, T, D]
        for bi in range(len(self.channels)):
            for ci in range(2):
                x = F.relu(getattr(self, f"conv{bi}_{ci}")(x))
            x = F.max_pool2d(x, 2, 2)                         # VALID: floor
        b, c, t, f = x.shape
        return x.permute(0, 2, 3, 1).reshape(b, t, f * c)


class VGGBLSTMCTC(nn.Module):
    """feats [B, T, D], feat_lens -> (ctc_logits [B, T/4, V] fp32, out_lens)."""

    def __init__(self, vocab_size: int, blstm_hidden: int = 320,
                 blstm_layers: int = 4, vgg_channels=(64, 128),
                 feat_dim: int = 80, dtype: torch.dtype = torch.float32,
                 lstm_impl: str = "auto"):
        super().__init__()
        self.vgg = VGGExtractor(vgg_channels, dtype)
        self.blstm = BLSTM(self.vgg.out_features(feat_dim), blstm_hidden,
                           blstm_layers, dtype, lstm_impl)
        self.ctc_head = Dense(2 * blstm_hidden, vocab_size, torch.float32)

    def output_lengths(self, feat_lens: torch.Tensor) -> torch.Tensor:
        return vgg_subsampled_lengths(feat_lens, len(self.vgg.channels))

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False, generator=None):
        # padding frames are zeroed so that conv windows straddling the
        # valid boundary see zeros, whatever the caller padded with
        mask = make_non_pad_mask(feat_lens, feats.shape[1])[..., None]
        x = self.vgg(torch.where(mask, feats, 0.0))
        out_lens = self.output_lengths(feat_lens)
        x = self.blstm(x, out_lens)
        return self.ctc_head(x), out_lens.to(torch.int32)

    def ctc_logits_only(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        """The greedy decode's entry, shared with the transformer."""
        return self.forward(feats, feat_lens)
