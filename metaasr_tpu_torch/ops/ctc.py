"""CTC loss as a log-space α recursion under autograd (counterpart of
``metaasr_tpu/ops/ctc.py``, the ``ctc_impl: scan`` backend).

    extended labels z = [b, y1, b, y2, ..., yU, b],  S = 2U+1, blank b=0
    alpha[0, 0] = logp_0(b);  alpha[0, 1] = logp_0(y1)
    alpha[t, s] = logp_t(z_s) + LSE(alpha[t-1, s], alpha[t-1, s-1],
                                    alpha[t-1, s-2] if z_s != b and z_s != z_{s-2})
    loss = -LSE(alpha[T-1, S-1], alpha[T-1, S-2])

The label emissions are gathered once into [B, T, S]; the recursion is a
Python loop over T of [B, S] elementwise ops, and autograd differentiates
through it (the reference's ``lax.scan``). Ragged T freezes α per row;
ragged U needs no masking. Infeasible rows (T too short) are zeroed, with
their gradient, when ``zero_infinity``. K2 (``ops/ctc_kernel.py``) computes
the same loss and its gradient in one kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from metaasr_tpu_torch.constants import BLANK_ID, LOG_EPS


def extend_labels(labels: torch.Tensor, blank: int = BLANK_ID) -> torch.Tensor:
    """[B, U] labels -> [B, 2U+1] blank-interleaved extended labels."""
    bsz, u = labels.shape
    z = torch.full((bsz, 2 * u + 1), blank, dtype=labels.dtype,
                   device=labels.device)
    z[:, 1::2] = labels
    return z


def gather_emissions(log_probs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """[B, T, V] log-probs, [B, S] extended labels -> [B, T, S] emissions
    (one gather; its backward scatters back to [B, T, V])."""
    bsz, t_len, _ = log_probs.shape
    idx = z.to(torch.int64)[:, None, :].expand(bsz, t_len, z.shape[1])
    return torch.gather(log_probs, 2, idx)


def skip_bias(z: torch.Tensor, blank: int = BLANK_ID) -> torch.Tensor:
    """[B, S] extended labels -> [B, S] f32 bias: 0 where the skip
    transition s-2 -> s is allowed (z_s != blank, z_s != z_{s-2}), else
    LOG_EPS."""
    z_prev2 = F.pad(z, (2, 0), value=blank)[:, : z.shape[1]]
    can_skip = (z != blank) & (z != z_prev2)
    return torch.where(can_skip, 0.0, LOG_EPS).to(torch.float32)


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp_min(m, LOG_EPS)  # avoid (-inf) - (-inf)
    return m + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                         + torch.exp(c - m_safe))


def _lse2(a, b):
    m = torch.maximum(a, b)
    m_safe = torch.clamp_min(m, LOG_EPS)
    return m + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[:, s] <- x[:, s-k], vacated lanes LOG_EPS."""
    return F.pad(x, (k, 0), value=LOG_EPS)[:, : x.shape[1]]


def ctc_forward(log_probs: torch.Tensor, logit_lens: torch.Tensor,
                labels: torch.Tensor, label_lens: torch.Tensor,
                blank: int = BLANK_ID) -> torch.Tensor:
    """Per-utterance negative log likelihood, shape [B].

    log_probs [B, T, V] log-softmaxed posteriors; logit_lens [B] valid
    frames; labels [B, U] zero-padded ids (no blanks); label_lens [B]."""
    t_len = log_probs.shape[1]
    z = extend_labels(labels, blank)
    logp_z = gather_emissions(log_probs, z)                # [B, T, S]
    skip = skip_bias(z, blank).to(log_probs.dtype)
    neg = torch.full_like(logp_z[:, 0], LOG_EPS)
    lane = torch.arange(z.shape[1], device=z.device)[None, :]
    alpha = torch.where(lane == 0, logp_z[:, 0], neg)
    alpha = torch.where((lane == 1) & (label_lens > 0)[:, None],
                        logp_z[:, 0], alpha)
    lens = logit_lens.to(torch.int64)[:, None]
    for t in range(1, t_len):
        new = logp_z[:, t] + _lse3(alpha, _shift(alpha, 1),
                                   _shift(alpha, 2) + skip)
        alpha = torch.where(t < lens, new, alpha)
    end = (2 * label_lens.to(torch.int64))[:, None]
    last = torch.gather(alpha, 1, end)[:, 0]
    prev = torch.gather(alpha, 1, torch.clamp_min(end - 1, 0))[:, 0]
    prev = torch.where(label_lens > 0, prev, neg[:, 0])
    return -_lse2(last, prev)


def zero_infeasible(nll: torch.Tensor) -> torch.Tensor:
    """``zero_infinity``: rows whose α readout stayed at LOG_EPS (T too
    short for the labels) get loss 0 and gradient 0."""
    return torch.where(nll > -0.5 * LOG_EPS, torch.zeros_like(nll), nll)


def ctc_loss(log_probs, logit_lens, labels, label_lens, blank: int = BLANK_ID,
             zero_infinity: bool = True) -> torch.Tensor:
    """[B] CTC negative log likelihoods (un-normalized)."""
    nll = ctc_forward(log_probs, logit_lens, labels, label_lens, blank)
    return zero_infeasible(nll) if zero_infinity else nll


def ctc_loss_normalized(log_probs, logit_lens, labels, label_lens,
                        blank: int = BLANK_ID) -> torch.Tensor:
    """Scalar: batch mean of per-utterance NLL."""
    return ctc_loss(log_probs, logit_lens, labels, label_lens, blank).mean()
