"""Conformer encoder (counterpart of ``metaasr_tpu/models/conformer.py``):
the drop-in alternative to the transformer encoder behind
``model.encoder: conformer``.

A layer is the macaron ½·FFN, relative-position self-attention
(Transformer-XL: content and position terms, learned per-head biases u and
v), a convolution module (pointwise + GLU, a depthwise convolution over the
valid frames, LayerNorm where the paper has BatchNorm, swish, pointwise) and
a second ½·FFN, then a LayerNorm. The encoder's interface is
:class:`~metaasr_tpu_torch.models.transformer.Encoder`'s: ``(feats,
feat_lens, train, generator) -> (enc [B, T', D] fp32, out_lens [B])``.

Dtype placement follows the reference under a bf16 compute dtype: q is
upcast to fp32 for both score terms, the relative table is cast to the
compute dtype before its projection, scores and softmax run in fp32, the
LayerNorms in fp32 with a cast back (``final_norm``'s output stays fp32),
the depthwise kernel and bias are cast to the compute dtype.

The depthwise convolution is one ``F.conv1d(groups=C)`` after an explicit
"SAME" pad (``lo = (k-1)//2``, ``hi = k-1-lo``), cross-correlation. The
reference writes it as K shifted multiply-adds because the TPU's vmapped
gradient of the grouped convolution was wrong; the port has no vmap (the
task axis is a loop), and one launch replaces 2K on a launch-bound path.
In fp32 the two forms agree to rounding; in bf16 ``conv1d`` accumulates in
fp32 where the reference rounds after every multiply-add. Swish and GLU are
``F.silu`` and ``F.glu``, one rounding each, where the reference's bf16
sigmoid rounds its exp, sum and reciprocal apart; both gaps are single bf16
ulps (``tests/test_torch_conformer.py`` states the measured bound).

The relative table is a non-persistent buffer over ``max_len`` offsets
each way; a call of length T slices rows ``max_len-T .. max_len+T-2``,
which is ``relative_positions(T, D)`` exactly, and shares the slice (cast
once) across the layers.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metaasr_tpu_torch.models.transformer import (
    Conv2dSubsampling,
    Dense,
    Dropout,
    LayerNorm,
    length_mask_bias,
    sinusoidal_positions,
)
from metaasr_tpu_torch.utils.padding import make_non_pad_mask, subsampled_lengths


def relative_positions(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal table over relative offsets [max_len-1 .. -(max_len-1)],
    shape [2*max_len-1, d_model]; row i encodes offset (max_len-1-i)."""
    pos = np.arange(max_len - 1, -max_len, -1)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    pe = np.zeros((2 * max_len - 1, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] -> [B, H, T, T] with ``out[..., t, s] =
    in[..., t, T-1+s-t]``: the Transformer-XL pad + reshape skew."""
    b, h, t, _ = x.shape
    x = F.pad(x, (1, 0))                              # [B, H, T, 2T]
    x = x.reshape(b, h, 2 * t, t)[:, :, 1:, :]        # drop the pad's row
    return x.reshape(b, h, t, 2 * t - 1)[..., :t]


class RelPosSelfAttention(nn.Module):
    """score(t, s) = (q_t + u)·k_s + (q_t + v)·r_{t-s}, over √Dh, softmax in
    fp32. ``qkv`` has output index order (3, H, Dh); ``pos`` has no bias."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        dh = d_model // num_heads
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = Dense(d_model, 3 * d_model, dtype)
        self.pos = Dense(d_model, d_model, dtype, bias=False)
        self.out = Dense(d_model, d_model, dtype)
        self.u_bias = nn.Parameter(torch.zeros(num_heads, dh))
        self.v_bias = nn.Parameter(torch.zeros(num_heads, dh))

    def forward(self, x, mask_bias, rel):
        """x [B, T, D]; ``rel`` the [2T-1, D] table in the compute dtype."""
        b, t, d = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).view(b, t, 3, h, -1).unbind(2)
        r = self.pos(rel).view(2 * t - 1, h, -1)
        qf = q.float()
        ac = torch.einsum("bqhd,bkhd->bhqk", qf + self.u_bias, k.float())
        bd = torch.einsum("bqhd,phd->bhqp", qf + self.v_bias, r.float())
        scores = (ac + rel_shift(bd)) / math.sqrt(q.shape[-1])
        weights = torch.softmax(scores + mask_bias, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.to(self.dtype),
                           v.to(self.dtype))
        return self.out(out.reshape(b, t, d))


class DepthwiseConv1d(nn.Module):
    """Per-channel 1-D convolution, "SAME" padding, no flip: ``out[t] =
    sum_i x[t - lo + i] * w[i]``. ``weight [C, 1, K]`` (``nn.Conv1d``'s
    layout), ``bias [C]``, both cast to the compute dtype."""

    def __init__(self, channels: int, kernel_size: int, dtype: torch.dtype):
        super().__init__()
        self.kernel_size = kernel_size
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, C] -> [B, T, C]."""
        k, dt = self.kernel_size, self.dtype
        lo = (k - 1) // 2
        xp = F.pad(x.to(dt).transpose(1, 2), (lo, k - 1 - lo))
        y = F.conv1d(xp, self.weight.to(dt), groups=self.weight.shape[0])
        return y.transpose(1, 2) + self.bias.to(dt)


class ConvModule(nn.Module):
    """pw1 (2D) -> GLU -> zero the padded frames -> depthwise -> fp32
    LayerNorm -> swish -> pw2 -> dropout."""

    def __init__(self, d_model: int, kernel_size: int, dtype: torch.dtype,
                 dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.pw1 = Dense(d_model, 2 * d_model, dtype)
        self.depthwise = DepthwiseConv1d(d_model, kernel_size, dtype)
        self.norm = LayerNorm(d_model)
        self.pw2 = Dense(d_model, d_model, dtype)
        self.drop = Dropout(dropout)

    def forward(self, x, pad_mask, train: bool = False, generator=None):
        """pad_mask [B, T, 1], True at valid frames."""
        x = F.glu(self.pw1(x), dim=-1)
        x = torch.where(pad_mask, x, 0.0)   # windows must not read padding
        x = self.norm(self.depthwise(x)).to(self.dtype)
        return self.drop(self.pw2(F.silu(x)), train, generator)


class ConformerFeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 dropout: float = 0.0):
        super().__init__()
        self.fc1 = Dense(d_model, d_ff, dtype)
        self.fc2 = Dense(d_ff, d_model, dtype)
        self.drop = Dropout(dropout)

    def forward(self, x, train: bool = False, generator=None):
        return self.fc2(self.drop(F.silu(self.fc1(x)), train, generator))


class ConformerLayer(nn.Module):
    """Macaron ½·FFN, attention, convolution, ½·FFN, each residual branch
    through the layer's dropout, then ``norm_out`` and a cast."""

    def __init__(self, d_model, num_heads, d_ff, kernel_size, dtype,
                 dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.norm_ff1 = LayerNorm(d_model)
        self.norm_attn = LayerNorm(d_model)
        self.norm_conv = LayerNorm(d_model)
        self.norm_ff2 = LayerNorm(d_model)
        self.norm_out = LayerNorm(d_model)
        self.ff1 = ConformerFeedForward(d_model, d_ff, dtype, dropout)
        self.self_attn = RelPosSelfAttention(d_model, num_heads, dtype)
        self.conv = ConvModule(d_model, kernel_size, dtype, dropout)
        self.ff2 = ConformerFeedForward(d_model, d_ff, dtype, dropout)
        self.drop = Dropout(dropout)

    def forward(self, x, mask_bias, pad_mask, rel, train: bool = False,
                generator=None):
        dt = self.dtype

        def branch(y):
            return self.drop(y, train, generator)

        x = x + 0.5 * branch(self.ff1(self.norm_ff1(x).to(dt), train,
                                      generator))
        x = x + branch(self.self_attn(self.norm_attn(x).to(dt), mask_bias,
                                      rel))
        x = x + branch(self.conv(self.norm_conv(x).to(dt), pad_mask, train,
                                 generator))
        x = x + 0.5 * branch(self.ff2(self.norm_ff2(x).to(dt), train,
                                      generator))
        return self.norm_out(x).to(dt)


class ConformerEncoder(nn.Module):
    """Masked features -> Conv2dSubsampling -> x·√d + sinusoidal PE (a
    variance floor: see below) -> dropout -> layers -> ``final_norm``
    (fp32), padded frames zeroed."""

    def __init__(self, d_model, num_heads, d_ff, num_layers, feat_dim, dtype,
                 kernel_size: int = 15, max_len: int = 4096,
                 dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dtype = dtype
        self.max_len = max_len
        self.subsample = Conv2dSubsampling(d_model, feat_dim, dtype)
        self.drop = Dropout(dropout)
        self.layers = nn.ModuleList(
            ConformerLayer(d_model, num_heads, d_ff, kernel_size, dtype,
                           dropout)
            for _ in range(num_layers))
        self.final_norm = LayerNorm(d_model)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_positions(max_len, d_model)),
            persistent=False)
        self.register_buffer(
            "rel", torch.from_numpy(relative_positions(max_len, d_model)),
            persistent=False)

    def relative_table(self, t_len: int) -> torch.Tensor:
        """``relative_positions(t_len, d_model)``, sliced from the buffer."""
        return self.rel[self.max_len - t_len: self.max_len + t_len - 1]

    def forward(self, feats, feat_lens, train: bool = False, generator=None):
        feats = torch.where(
            make_non_pad_mask(feat_lens, feats.shape[1])[..., None], feats, 0.0)
        x = self.subsample(feats)
        out_lens = subsampled_lengths(feat_lens, 4)
        t_len = x.shape[1]
        # The absolute positions are a variance floor, not position
        # information (the relative term carries that): without them a
        # SpecAugment-masked region maps to an exactly constant vector at
        # every masked frame, and the LayerNorm backward of a constant
        # vector scales by 1/sqrt(eps) (the reference's comment and
        # docs/DESIGN.md section 7).
        scale = float(torch.tensor(float(self.d_model), dtype=x.dtype).sqrt())
        x = x * scale + self.pe[:t_len].to(x.dtype)
        x = self.drop(x, train, generator)
        bias = length_mask_bias(out_lens, t_len)
        pad_mask = make_non_pad_mask(out_lens, t_len)[..., None]
        rel = self.relative_table(t_len).to(self.dtype)
        for layer in self.layers:
            x = layer(x, bias, pad_mask, rel, train, generator)
        x = self.final_norm(x)
        return torch.where(pad_mask, x, 0.0), out_lens
