"""Joint CTC-attention transformer (counterpart of
``metaasr_tpu/models/transformer.py``): the teacher-forced training forward
and the inference methods.

PyTorch layouts (``nn.Linear`` weight ``[out, in]``, ``Conv2d`` OIHW,
NCHW activations); ``weights.py`` maps the Flax parameter tree onto them.
The numerics follow the reference's dtype placement under a bf16 compute
dtype with fp32 weights:

- a :class:`Dense`/:class:`Conv2d` casts input, weight and bias to the
  compute dtype, then multiplies and adds the bias in that dtype (Flax's
  ``promote_dtype``);
- LayerNorms (eps 1e-6), attention scores and softmax, the CTC head and the
  decoder's output projection run in fp32;
- the encoder scales ``x * sqrt(d)`` in the compute dtype; the decoder
  embeds in fp32 and then casts.

The decoder's self-attention KV cache has a fixed length and is written in
place at each step; a step attends only to the filled prefix, which equals
the reference's masked attention over the whole cache.

Dropout sits where the reference has it (after the positional encoding,
after each residual branch, inside the feed-forward) and draws its masks
from the ``generator`` passed down with ``train=True``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metaasr_tpu_torch.utils.padding import make_non_pad_mask, subsampled_lengths
from metaasr_tpu_torch.utils.rows import draw

NEG_INF = -1e9  # additive mask bias (fp32-safe through softmax)
LN_EPS = 1e-6   # Flax LayerNorm's epsilon (torch's default is 1e-5)


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def length_mask_bias(lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] -> [B, 1, 1, max_len] fp32 additive bias (0 valid / NEG_INF pad)."""
    valid = make_non_pad_mask(lens, max_len)
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]


def causal_mask_bias(q_len: int, k_len: int, offset: int = 0,
                     device=None) -> torch.Tensor:
    """[1, 1, q_len, k_len] fp32 additive causal bias; query t sees keys
    <= t + offset."""
    q = torch.arange(q_len, device=device)[:, None]
    k = torch.arange(k_len, device=device)[None, :]
    return torch.where(k <= q + offset, 0.0, NEG_INF).to(
        torch.float32)[None, None]


class Dropout(nn.Module):
    """Flax's ``nn.Dropout``: keep with probability 1-rate and scale by
    1/(1-rate) when training; the identity otherwise or at rate 0. Masks
    come from the caller's ``torch.Generator``, drawn at the whole batch's
    rows where it carries a rank's (``utils.rows``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = draw(lambda s: torch.rand(s, generator=generator,
                                      device=x.device), x.shape, generator)
        return torch.where(u < keep, x / keep, 0.0).to(x.dtype)


class Dense(nn.Linear):
    """Linear layer computing in ``compute_dtype`` (weights stay as stored)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class Conv2d(nn.Conv2d):
    """3x3 stride-2 VALID convolution computing in ``compute_dtype``."""

    def __init__(self, in_ch: int, out_ch: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, 3, stride=2)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, stride=2)
        return y + self.bias.to(dt)[None, :, None, None]


class LayerNorm(nn.LayerNorm):
    """fp32 LayerNorm with Flax's epsilon."""

    def __init__(self, d: int):
        super().__init__(d, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)


def _attend(q, k, v, mask_bias, dtype, return_weights: bool = False):
    """q [B,Q,H,Dh], k/v [B,K,H,Dh]: fp32 scores and softmax, the weighted
    sum in the compute dtype."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(dh)
    if mask_bias is not None:
        scores = scores + mask_bias
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(dtype), v.to(dtype))
    return (out, weights) if return_weights else out


class SelfAttention(nn.Module):
    """Fused-QKV self-attention; output index order (3, H, Dh)."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = Dense(d_model, 3 * d_model, dtype)
        self.out = Dense(d_model, d_model, dtype)

    def forward(self, x, mask_bias, cache: dict | None = None,
                cache_index: int = 0):
        """x [B, Q, D]. With ``cache`` ({'k','v': [B, Kmax, H, Dh]}), the new
        keys/values are written in place at ``cache_index`` and attention
        runs over positions < cache_index + Q."""
        b, q_len, d = x.shape
        q, k, v = self.qkv(x).view(b, q_len, 3, self.num_heads, -1).unbind(2)
        if cache is not None:
            end = cache_index + q_len
            cache["k"][:, cache_index:end] = k
            cache["v"][:, cache_index:end] = v
            k, v = cache["k"][:, :end], cache["v"][:, :end]
        att = _attend(q, k, v, mask_bias, self.dtype)
        return self.out(att.reshape(b, q_len, d))


class CrossAttention(nn.Module):
    """Decoder-to-encoder attention; K/V precomputed once per utterance."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.q = Dense(d_model, d_model, dtype)
        self.k = Dense(d_model, d_model, dtype)
        self.v = Dense(d_model, d_model, dtype)
        self.out = Dense(d_model, d_model, dtype)

    def kv(self, enc: torch.Tensor) -> dict:
        b, t, _ = enc.shape
        return {"k": self.k(enc).view(b, t, self.num_heads, -1),
                "v": self.v(enc).view(b, t, self.num_heads, -1)}

    def forward(self, x, mask_bias, kv: dict, return_weights: bool = False):
        b, q_len, d = x.shape
        q = self.q(x).view(b, q_len, self.num_heads, -1)
        out = _attend(q, kv["k"], kv["v"], mask_bias, self.dtype,
                      return_weights)
        att, w = out if return_weights else (out, None)
        return self.out(att.reshape(b, q_len, d)), w


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 dropout: float = 0.0):
        super().__init__()
        self.fc1 = Dense(d_model, d_ff, dtype)
        self.fc2 = Dense(d_ff, d_model, dtype)
        self.drop = Dropout(dropout)

    def forward(self, x, train: bool = False, generator=None):
        return self.fc2(self.drop(torch.relu(self.fc1(x)), train, generator))


class EncoderLayer(nn.Module):
    """Pre-LN encoder layer."""

    def __init__(self, d_model, num_heads, d_ff, dtype, dropout: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.self_attn = SelfAttention(d_model, num_heads, dtype)
        self.ff = FeedForward(d_model, d_ff, dtype, dropout)
        self.drop = Dropout(dropout)

    def forward(self, x, mask_bias, train: bool = False, generator=None):
        y = self.self_attn(self.norm1(x), mask_bias)
        x = x + self.drop(y, train, generator)
        y = self.ff(self.norm2(x), train, generator)
        return x + self.drop(y, train, generator)


class Conv2dSubsampling(nn.Module):
    """Two stride-2 3x3 convs over [B, 1, T, D] (T/4, D/4), then a linear
    map of the flattened (freq, channel) features, channel fastest."""

    def __init__(self, d_model: int, feat_dim: int, dtype: torch.dtype):
        super().__init__()
        self.conv0 = Conv2d(1, d_model, dtype)
        self.conv1 = Conv2d(d_model, d_model, dtype)
        f_out = ((feat_dim - 3) // 2 + 1 - 3) // 2 + 1
        self.proj = Dense(f_out * d_model, d_model, dtype)

    def forward(self, feats):
        x = torch.relu(self.conv0(feats[:, None]))
        x = torch.relu(self.conv1(x))
        b, c, t, f = x.shape
        return self.proj(x.permute(0, 2, 3, 1).reshape(b, t, f * c))


class Encoder(nn.Module):
    def __init__(self, d_model, num_heads, d_ff, num_layers, feat_dim, dtype,
                 max_len: int = 4096, dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dtype = dtype
        self.subsample = Conv2dSubsampling(d_model, feat_dim, dtype)
        self.drop = Dropout(dropout)
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, num_heads, d_ff, dtype, dropout)
            for _ in range(num_layers))
        self.final_norm = LayerNorm(d_model)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_positions(max_len, d_model)),
            persistent=False)

    def forward(self, feats, feat_lens, train: bool = False, generator=None):
        feats = torch.where(
            make_non_pad_mask(feat_lens, feats.shape[1])[..., None], feats, 0.0)
        x = self.subsample(feats)
        out_lens = subsampled_lengths(feat_lens, 4)
        t_len = x.shape[1]
        # sqrt(d) rounded to the compute dtype, as the reference computes it
        scale = float(torch.tensor(float(self.d_model), dtype=x.dtype).sqrt())
        x = x * scale + self.pe[:t_len].to(x.dtype)
        x = self.drop(x, train, generator)
        bias = length_mask_bias(out_lens, t_len)
        for layer in self.layers:
            x = layer(x, bias, train, generator)
        x = self.final_norm(x)
        return (torch.where(make_non_pad_mask(out_lens, t_len)[..., None],
                            x, 0.0), out_lens)


class DecoderLayer(nn.Module):
    def __init__(self, d_model, num_heads, d_ff, dtype, dropout: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.self_attn = SelfAttention(d_model, num_heads, dtype)
        self.cross_attn = CrossAttention(d_model, num_heads, dtype)
        self.ff = FeedForward(d_model, d_ff, dtype, dropout)
        self.drop = Dropout(dropout)

    def forward(self, x, self_bias, enc, cross_bias, train: bool = False,
                generator=None):
        """Teacher-forced layer over the whole target sequence."""
        y = self.self_attn(self.norm1(x), self_bias)
        x = x + self.drop(y, train, generator)
        y, _ = self.cross_attn(self.norm2(x), cross_bias,
                               self.cross_attn.kv(enc))
        x = x + self.drop(y, train, generator)
        y = self.ff(self.norm3(x), train, generator)
        return x + self.drop(y, train, generator)

    def step(self, x, cross_bias, self_cache, cache_index, cross_kv,
             return_cross_attn: bool = False):
        x = x + self.self_attn(self.norm1(x), None, cache=self_cache,
                               cache_index=cache_index)
        y, cross_w = self.cross_attn(self.norm2(x), cross_bias, cross_kv,
                                     return_cross_attn)
        x = x + y
        return x + self.ff(self.norm3(x)), cross_w


class Decoder(nn.Module):
    def __init__(self, vocab_size, d_model, num_heads, d_ff, num_layers,
                 dtype, max_len: int = 512, dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, num_heads, d_ff, dtype, dropout)
            for _ in range(num_layers))
        self.final_norm = LayerNorm(d_model)
        self.out_proj = Dense(d_model, vocab_size, torch.float32)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_positions(max_len, d_model)),
            persistent=False)

    def _embed_pos(self, tokens, start: int):
        x = self.embed(tokens).float() * math.sqrt(self.d_model)
        x = x + self.pe[start: start + tokens.shape[1]]
        return x.to(self.dtype)

    def forward(self, tokens, token_lens, enc, enc_lens, train: bool = False,
                generator=None):
        """Teacher-forced forward: tokens [B, U] (sos-prefixed) ->
        logits [B, U, V] fp32."""
        u_len = tokens.shape[1]
        x = self._embed_pos(tokens, 0)
        self_bias = (causal_mask_bias(u_len, u_len, device=tokens.device)
                     + length_mask_bias(token_lens, u_len))
        cross_bias = length_mask_bias(enc_lens, enc.shape[1])
        enc = enc.to(self.dtype)
        for layer in self.layers:
            x = layer(x, self_bias, enc, cross_bias, train, generator)
        return self.out_proj(self.final_norm(x))

    def init_state(self, bsz: int, max_decode_len: int) -> list[dict]:
        dh = self.d_model // self.num_heads
        dev = self.embed.weight.device
        return [{name: torch.zeros((bsz, max_decode_len, self.num_heads, dh),
                                   dtype=self.dtype, device=dev)
                 for name in ("k", "v")}
                for _ in self.layers]

    def precompute_cross(self, enc) -> list[dict]:
        enc = enc.to(self.dtype)
        return [layer.cross_attn.kv(enc) for layer in self.layers]

    def decode_step(self, tokens, step: int, caches, enc_lens, cross_caches,
                    return_attn: bool = False):
        """tokens [N, 1] (last emitted), ``step`` the write position ->
        (log_probs [N, V], caches) (+ the last layer's head-averaged cross
        attention [N, T_enc] when ``return_attn``). Caches update in place."""
        x = self._embed_pos(tokens, step)
        cross_bias = length_mask_bias(enc_lens, cross_caches[0]["k"].shape[1])
        last = len(self.layers) - 1
        cross_w = None
        for i, (layer, cache, ckv) in enumerate(
                zip(self.layers, caches, cross_caches)):
            x, w = layer.step(x, cross_bias, cache, step, ckv,
                              return_attn and i == last)
            if w is not None:
                cross_w = w
        logits = self.out_proj(self.final_norm(x))[:, 0]
        logp = torch.log_softmax(logits.float(), dim=-1)
        if return_attn:
            return logp, caches, cross_w.mean(dim=1)[:, 0]
        return logp, caches


class TransformerASR(nn.Module):
    """Joint CTC-attention model: encoder + CTC head + attention decoder.
    ``encoder_type`` "conformer" swaps in ``models/conformer.py``'s encoder
    (depthwise kernel ``conformer_kernel``); nothing else changes."""

    def __init__(self, vocab_size: int, d_model: int = 256, num_heads: int = 4,
                 d_ff: int = 2048, num_encoder_layers: int = 12,
                 num_decoder_layers: int = 6, feat_dim: int = 80,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 encoder_type: str = "transformer",
                 conformer_kernel: int = 15):
        super().__init__()
        self.dtype = dtype
        if encoder_type == "conformer":
            from metaasr_tpu_torch.models.conformer import ConformerEncoder

            self.encoder = ConformerEncoder(
                d_model, num_heads, d_ff, num_encoder_layers, feat_dim, dtype,
                kernel_size=conformer_kernel, dropout=dropout)
        elif encoder_type == "transformer":
            self.encoder = Encoder(d_model, num_heads, d_ff,
                                   num_encoder_layers, feat_dim, dtype,
                                   dropout=dropout)
        else:
            raise ValueError(f"unknown encoder {encoder_type!r} (transformer "
                             "or conformer)")
        self.ctc_head = Dense(d_model, vocab_size, torch.float32)
        self.decoder = Decoder(vocab_size, d_model, num_heads, d_ff,
                               num_decoder_layers, dtype, dropout=dropout)

    def forward(self, feats, feat_lens, tokens_in, token_in_lens,
                train: bool = False, generator=None) -> dict:
        """Teacher-forced forward; ``tokens_in`` [B, U+1] sos-prefixed.
        Returns {ctc_logits [B, T', V], att_logits [B, U+1, V], enc_lens
        [B], encoder_out [B, T', D]}."""
        enc, enc_lens = self.encode(feats, feat_lens, train, generator)
        return {"ctc_logits": self.ctc_head(enc),
                "att_logits": self.decoder(tokens_in, token_in_lens, enc,
                                           enc_lens, train, generator),
                "enc_lens": enc_lens, "encoder_out": enc}

    def encode(self, feats, feat_lens, train: bool = False, generator=None):
        """-> (encoder output [B, T', D] fp32, padded frames zeroed;
        lengths [B])."""
        return self.encoder(feats, feat_lens, train, generator)

    def apply_ctc_head(self, enc):
        return self.ctc_head(enc)

    def ctc_logits_only(self, feats, feat_lens):
        enc, enc_lens = self.encode(feats, feat_lens)
        return self.ctc_head(enc), enc_lens

    def decoder_init_state(self, bsz: int, max_decode_len: int):
        return self.decoder.init_state(bsz, max_decode_len)

    def decoder_precompute_cross(self, enc):
        return self.decoder.precompute_cross(enc)

    def decoder_step(self, tokens, step: int, caches, enc_lens, cross_caches,
                     return_attn: bool = False):
        return self.decoder.decode_step(tokens, step, caches, enc_lens,
                                        cross_caches, return_attn)
