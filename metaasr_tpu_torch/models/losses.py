"""Losses and target preparation for the joint CTC-attention objective
(counterpart of ``metaasr_tpu/models/losses.py``): label-smoothed KL for the
attention decoder against sos/eos-shifted targets, and the joint loss
``λ·L_ctc + (1-λ)·L_att``.
"""

from __future__ import annotations

import math

import torch

from metaasr_tpu_torch.ops.ctc import ctc_loss


def prepare_decoder_targets(tokens: torch.Tensor, token_lens: torch.Tensor,
                            sos_eos_id: int):
    """[B, U] padded targets -> (tokens_in [B, U+1] sos-prefixed,
    tokens_out [B, U+1] eos-suffixed, out_mask [B, U+1] bool).

    tokens_in[b]  = [sos, y1 .. yU, pad...]
    tokens_out[b] = [y1 .. yU, eos, pad...]   (mask covers len+1 positions)
    """
    bsz, u = tokens.shape
    sos = torch.full((bsz, 1), sos_eos_id, dtype=tokens.dtype,
                     device=tokens.device)
    tokens_in = torch.cat([sos, tokens], dim=1)
    pos = torch.arange(u + 1, device=tokens.device)[None, :]
    lens = token_lens.to(torch.int64)[:, None]
    eos_col = torch.where(pos == lens, sos_eos_id, 0).to(tokens.dtype)
    padded = torch.cat([tokens, torch.zeros_like(sos)], dim=1)
    tokens_out = padded * (pos < lens) + eos_col
    return tokens_in, tokens_out, pos <= lens


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor, smoothing: float = 0.1,
                         normalize: str = "tokens",
                         whole=None) -> torch.Tensor:
    """KL(smoothed one-hot || softmax(logits)) over masked positions: the
    smoothed target puts (1-eps) on the label and eps/(V-1) elsewhere; the
    entropy constant is kept (a true KL). Averaged over valid positions
    (``normalize='tokens'``) or over utterances (``'batch'``).

    ``whole``: (rows, valid positions) of the whole batch these rows are a
    share of (a rank's shots on the data axis, ``whole_counts``): the sum
    is then divided by the whole batch's count, so the shares' losses add
    up to the whole batch's."""
    vocab = logits.shape[-1]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    on = 1.0 - smoothing
    off = smoothing / (vocab - 1)
    tgt_logp = torch.gather(logp, -1, targets.to(torch.int64)[..., None])[..., 0]
    q_entropy = -(on * math.log(max(on, 1e-10))
                  + (vocab - 1) * off * math.log(max(off, 1e-10)))
    xent = -(on * tgt_logp + off * (logp.sum(dim=-1) - tgt_logp))
    kl = torch.where(mask, xent - q_entropy, 0.0)
    if normalize == "tokens":
        count = mask.sum() if whole is None else whole[1]
        return kl.sum() / torch.clamp_min(count, 1)
    return kl.sum() / (logits.shape[0] if whole is None else whole[0])


def whole_counts(batch: dict):
    """(rows, valid decoder positions) of the whole batch a rank's share
    ``batch`` belongs to, from its ``whole_token_lens`` (every row's token
    count; ``sampler.TaskSampler.sample(shots=)``) -> None for a batch
    that is whole."""
    lens = batch.get("whole_token_lens")
    if lens is None:
        return None
    return lens.shape[0], (lens.to(torch.int64) + 1).sum()


def batch_mean(per_row: torch.Tensor, whole=None) -> torch.Tensor:
    """The mean over the batch of per-row losses; of a share, its rows'
    sum over the whole batch's rows."""
    return per_row.mean() if whole is None else per_row.sum() / whole[0]


def joint_ctc_attention_loss(outputs: dict, tokens: torch.Tensor,
                             token_lens: torch.Tensor, sos_eos_id: int,
                             ctc_weight: float = 0.3,
                             label_smoothing: float = 0.1,
                             ctc_loss_fn=None, whole=None):
    """outputs: dict from ``TransformerASR.forward`` (teacher-forced with
    the same ``prepare_decoder_targets`` inputs). Returns (scalar loss,
    metrics). ``ctc_loss_fn`` selects the CTC backend (scan or K2).
    ``whole`` (``whole_counts``): these rows are a share of a batch, and
    both terms divide by the whole batch's counts."""
    ctc_loss_fn = ctc_loss_fn or ctc_loss
    lp = torch.log_softmax(outputs["ctc_logits"].to(torch.float32), dim=-1)
    l_ctc = batch_mean(ctc_loss_fn(lp, outputs["enc_lens"], tokens,
                                   token_lens), whole)
    _, tokens_out, out_mask = prepare_decoder_targets(tokens, token_lens,
                                                      sos_eos_id)
    l_att = label_smoothing_loss(outputs["att_logits"], tokens_out, out_mask,
                                 label_smoothing, whole=whole)
    loss = ctc_weight * l_ctc + (1.0 - ctc_weight) * l_att
    return loss, {"loss": loss, "ctc_loss": l_ctc, "att_loss": l_att}
