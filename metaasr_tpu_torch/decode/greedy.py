"""Greedy CTC decoding (counterpart of ``metaasr_tpu/decode/greedy.py``)."""

from __future__ import annotations

import numpy as np
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


def collapse_ctc(ids, blank: int = BLANK_ID) -> list[int]:
    """Host-side collapse of a frame-level id sequence: repeats -> one,
    blanks dropped."""
    out, prev = [], None
    for i in ids:
        i = int(i)
        if i != blank and i != prev:
            out.append(i)
        prev = i
    return out


def greedy_to_texts(packed, out_lens, tokenizer) -> list[str]:
    """Packed ids [B, T] and lens [B] (tensors or arrays) -> texts."""
    packed = np.asarray(torch.as_tensor(packed).cpu())
    out_lens = np.asarray(torch.as_tensor(out_lens).cpu())
    return [tokenizer.decode(packed[b, : out_lens[b]])
            for b in range(len(out_lens))]
