"""Model FLOPs of a training step, counted from the cell's shapes: the
matrix products and convolutions of one forward pass (2 per multiply-add),
times 3 for forward and backward. Elementwise work, the front-end and the
CTC recursion are not counted, nor is anything recomputed."""

from __future__ import annotations


def _conv_out(n: int) -> int:
    return (n - 3) // 2 + 1


def transformer_forward(frames: int, positions: int, d: int, ff: int,
                        enc_layers: int, dec_layers: int, vocab: int,
                        feat_dim: int = 80) -> int:
    """One utterance of ``frames`` feature frames and ``positions`` decoder
    positions (tokens + 1) through the joint CTC-attention transformer."""
    t1, f1 = _conv_out(frames), _conv_out(feat_dim)
    t, f2 = _conv_out(t1), _conv_out(f1)
    u = positions
    flops = 2 * d * t1 * f1 * 9 + 2 * d * t * f2 * d * 9 + 2 * t * f2 * d * d
    enc = 2 * t * d * 3 * d + 2 * 2 * t * t * d + 2 * t * d * d \
        + 2 * 2 * t * d * ff
    dec = (2 * u * d * 3 * d + 2 * 2 * u * u * d + 2 * u * d * d      # self
           + 2 * u * d * d + 2 * 2 * t * d * d + 2 * 2 * u * t * d
           + 2 * u * d * d                                            # cross
           + 2 * 2 * u * d * ff)
    return flops + enc_layers * enc + dec_layers * dec + 2 * t * d * vocab \
        + 2 * u * d * vocab


def vgg_blstm_forward(frames: int, hidden: int, layers: int, channels,
                      vocab: int, feat_dim: int = 80) -> int:
    flops, t, f, c_in = 0, frames, feat_dim, 1
    for c in channels:
        flops += 2 * c * t * f * c_in * 9 + 2 * c * t * f * c * 9
        c_in, t, f = c, t // 2, f // 2
    d_in = f * c_in
    for i in range(layers):
        width = d_in if i == 0 else 2 * hidden
        flops += 2 * (2 * t * width * 4 * hidden + 2 * t * hidden * 4 * hidden)
    return flops + 2 * t * 2 * hidden * vocab


def train_step(forward: int, utterances: int) -> int:
    return 3 * forward * utterances
