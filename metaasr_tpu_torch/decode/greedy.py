"""Greedy CTC decoding (counterpart of ``metaasr_tpu/decode/greedy.py``)."""

from __future__ import annotations

import torch

from metaasr_tpu_torch.constants import BLANK_ID
from metaasr_tpu_torch.utils.padding import make_non_pad_mask


def ctc_greedy_decode(logits: torch.Tensor, logit_lens: torch.Tensor,
                      blank: int = BLANK_ID):
    """[B, T, V] -> (ids [B, T] collapsed and left-packed, lens [B]):
    per-frame argmax (first maximum on ties), collapse repeats, drop
    blanks, then a stable sort moves the kept positions first."""
    best = torch.argmax(logits, dim=-1)                       # [B, T]
    t_len = best.shape[1]
    valid = make_non_pad_mask(logit_lens, t_len)
    prev = torch.cat([torch.full_like(best[:, :1], blank), best[:, :-1]], 1)
    keep = valid & (best != blank) & (best != prev)
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    packed = torch.where(keep, best, 0).gather(1, order).to(torch.int32)
    return packed, keep.sum(dim=1).to(torch.int32)
