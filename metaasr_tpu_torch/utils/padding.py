"""Padding / masking utilities (counterpart of ``metaasr_tpu/utils/padding.py``)."""

from __future__ import annotations

import numpy as np
import torch


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] int lengths -> [B, max_len] bool mask, True on valid positions."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths.to(torch.int64)[:, None]


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] int lengths -> [B, max_len] bool mask, True on padding positions."""
    return ~make_non_pad_mask(lengths, max_len)


def subsampled_lengths(lengths: torch.Tensor, factor: int = 4) -> torch.Tensor:
    """Lengths through stacked stride-2 kernel-3 VALID convs:
    L -> floor((L - 1) / 2) per factor of 2, floored at 1."""
    out = lengths.to(torch.int64)
    f = factor
    while f > 1:
        out = torch.div(out - 1, 2, rounding_mode="floor")
        f //= 2
    return torch.clamp(out, min=1)


def pad_to(x: np.ndarray, length: int, axis: int = 0, value=0) -> np.ndarray:
    """Host side: pad ``x`` along ``axis`` with ``value`` to ``length``, or
    cut it there when it is longer."""
    if x.shape[axis] >= length:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(0, length)
        return x[tuple(idx)]
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, length - x.shape[axis])
    return np.pad(x, widths, constant_values=value)


def bucket_length(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= n (the largest when none fits)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def vgg_subsampled_lengths(lengths: torch.Tensor,
                           num_blocks: int = 2) -> torch.Tensor:
    """Lengths through the VGG extractor: each block ends in a VALID 2x2
    max-pool of stride 2 (L -> floor(L / 2)), floored at 1."""
    out = lengths.to(torch.int64)
    for _ in range(num_blocks):
        out = torch.div(out, 2, rounding_mode="floor")
    return torch.clamp(out, min=1)
