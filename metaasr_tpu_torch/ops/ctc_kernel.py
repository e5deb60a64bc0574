"""K2: the CTC α/β kernel, its plain PyTorch version, and the loss built on
it (counterpart of ``metaasr_tpu/ops/ctc_pallas.py``).

:func:`ctc_alpha_beta` maps label-gathered emissions ``logp_z [B, T, S]``
to ``(nll [B], grad [B, T, S])``, the gradient being the posterior
``-exp(α + β + nll)``. On a CPU tensor it runs :func:`plain_ctc_alpha_beta`;
on a CUDA tensor it launches ``csrc/ctc.cu`` (the source's header gives the
kernel's design and bound) or raises. There is no size fallback: the kernel
takes any T.

:func:`ctc_loss_kernel` is the counterpart of ``ctc_loss_pallas``: it
gathers the emissions, builds the skip bias and ``end = 2·label_len``, and
runs the recursion inside a ``torch.autograd.Function`` whose backward is
``grad_out[:, None, None] * g`` with the kernel's saved ``g``; the gather's
own backward scatters that to ``[B, T, V]``. The Function is first order
only (``once_differentiable``): second-order MAML needs K2b (the next
slice of ROADMAP.md's port queue).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from metaasr_tpu_torch.constants import BLANK_ID, LOG_EPS
from metaasr_tpu_torch.ops.ctc import (
    extend_labels,
    gather_emissions,
    skip_bias,
    zero_infeasible,
)


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp_min(m, LOG_EPS)
    return m + torch.log((torch.exp(a - m_safe) + torch.exp(b - m_safe))
                         + torch.exp(c - m_safe))


def _neighbour(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[:, s] <- x[:, s+k] (k > 0) or x[:, s-|k|] (k < 0); lanes with no
    neighbour get LOG_EPS."""
    out = torch.full_like(x, LOG_EPS)
    if k > 0:
        out[:, :-k] = x[:, k:]
    else:
        out[:, -k:] = x[:, :k]
    return out


def plain_ctc_alpha_beta(logp_z: torch.Tensor, skip: torch.Tensor,
                         lens: torch.Tensor, end: torch.Tensor):
    """The kernel's arithmetic as torch ops over [B, S] rows, in the same
    order: -> (nll [B], grad [B, T, S]). ``lens``/``end`` are [B] ints."""
    bsz, t_len, s_len = logp_z.shape
    lens = lens.to(torch.int64)[:, None]
    end = end.to(torch.int64)[:, None]
    lane = torch.arange(s_len, device=logp_z.device)[None, :]
    alpha = torch.where(lane == 0, logp_z[:, 0], LOG_EPS)
    alpha = torch.where((lane == 1) & (end > 0), logp_z[:, 0], alpha)
    history = [alpha]
    for t in range(1, t_len):
        new = logp_z[:, t] + _lse3(alpha, _neighbour(alpha, -1),
                                   _neighbour(alpha, -2) + skip)
        alpha = torch.where(t < lens, new, alpha)
        history.append(alpha)
    a_last = torch.gather(alpha, 1, end)
    a_prev = torch.where(end > 0,
                         torch.gather(alpha, 1, torch.clamp_min(end - 1, 0)),
                         LOG_EPS)
    m = torch.where(end > 0, torch.maximum(a_last, a_prev), a_last)
    m_safe = torch.clamp_min(m, LOG_EPS)
    total = torch.exp(a_last - m_safe)
    total = torch.where(end > 0, total + torch.exp(a_prev - m_safe), total)
    nll = -(m + torch.log(total))                             # [B, 1]

    pick = (lane == end) | ((lane == end - 1) & (end > 0))
    beta_init = torch.where(pick, 0.0, LOG_EPS)
    grad = torch.empty_like(logp_z)
    carry = beta_init
    for t in range(t_len - 1, -1, -1):
        beta_t = torch.where(t >= lens - 1, beta_init, carry)
        grad[:, t] = torch.where(
            t < lens, -torch.exp(history[t] + beta_t + nll), 0.0)
        cur = beta_t + logp_z[:, t]
        # next states s+1, s+2 (the skip into s+2 carries skip[s+2])
        carry = _lse3(cur, _neighbour(cur, 1), _neighbour(cur + skip, 2))
    return nll[:, 0], grad


def _launch(logp_z, skip, lens, end):
    from metaasr_tpu_torch.ops import _build

    lib = _build.load("ctc")
    fn = lib.metaasr_ctc_alpha_beta
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.metaasr_ctc_max_lanes.restype = ctypes.c_int
    bsz, t_len, s_len = logp_z.shape
    if s_len > lib.metaasr_ctc_max_lanes():
        raise ValueError(f"S={s_len} exceeds the kernel's "
                         f"{lib.metaasr_ctc_max_lanes()} lanes")
    nll = torch.empty((bsz,), dtype=torch.float32, device=logp_z.device)
    grad = torch.empty_like(logp_z)
    stream = torch.cuda.current_stream(logp_z.device).cuda_stream
    rc = fn(logp_z.data_ptr(), skip.data_ptr(), lens.data_ptr(),
            end.data_ptr(), nll.data_ptr(), grad.data_ptr(),
            bsz, t_len, s_len, stream)
    if rc != 0:
        raise RuntimeError(f"ctc kernel launch failed: cudaError {rc}")
    ctc_alpha_beta.launches += 1
    return nll, grad


def ctc_alpha_beta(logp_z: torch.Tensor, skip: torch.Tensor,
                   lens: torch.Tensor, end: torch.Tensor):
    """logp_z [B, T, S] f32, skip [B, S] f32, lens/end [B] int32 ->
    (nll [B], grad [B, T, S]). A CPU tensor runs the plain version; a CUDA
    tensor launches K2 (counted in ``launches``) or raises."""
    if logp_z.dim() != 3 or logp_z.dtype != torch.float32:
        raise ValueError(f"logp_z must be [B, T, S] float32, got "
                         f"{tuple(logp_z.shape)} {logp_z.dtype}")
    bsz, t_len, s_len = logp_z.shape
    if t_len < 1:
        raise ValueError("logp_z needs at least one frame")
    if skip.shape != (bsz, s_len) or skip.dtype != torch.float32:
        raise ValueError(f"skip must be [{bsz}, {s_len}] float32, got "
                         f"{tuple(skip.shape)} {skip.dtype}")
    for name, x in (("lens", lens), ("end", end)):
        if x.shape != (bsz,):
            raise ValueError(f"{name} must be [{bsz}], got {tuple(x.shape)}")
    if any(x.device != logp_z.device for x in (skip, lens, end)):
        raise ValueError("all inputs must be on one device")
    if logp_z.device.type == "cpu":
        return plain_ctc_alpha_beta(logp_z, skip, lens, end)
    if logp_z.device.type != "cuda":
        raise ValueError(f"unsupported device {logp_z.device}")
    if lens.dtype != torch.int32 or end.dtype != torch.int32:
        raise ValueError("lens and end must be int32")
    if not all(x.is_contiguous() for x in (logp_z, skip, lens, end)):
        raise ValueError("inputs must be contiguous")
    return _launch(logp_z, skip, lens, end)


ctc_alpha_beta.launches = 0


@once_differentiable
def _scale_posterior(ctx, grad_out):
    (g,) = ctx.saved_tensors
    return grad_out[:, None, None] * g, None, None, None


class CTCAlphaBeta(torch.autograd.Function):
    """nll [B] from K2 in forward; backward scales the kernel's posterior
    gradient by the incoming cotangent. First order only: a backward that
    builds a graph for a second one (``create_graph=True``, as second-order
    MAML does) raises, since the posterior would enter it as a constant and
    the CTC Hessian term would silently vanish."""

    @staticmethod
    def forward(ctx, logp_z, skip, lens, end):
        nll, grad = ctc_alpha_beta(logp_z, skip, lens, end)
        ctx.save_for_backward(grad)
        return nll

    @staticmethod
    def backward(ctx, grad_out):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "the CTC alpha/beta Function is first order only; a "
                "differentiable backward (create_graph=True) needs K2b, "
                "the next slice of ROADMAP.md's port queue")
        return _scale_posterior(ctx, grad_out)


def ctc_forward_kernel(log_probs: torch.Tensor, logit_lens: torch.Tensor,
                       labels: torch.Tensor, label_lens: torch.Tensor,
                       blank: int = BLANK_ID) -> torch.Tensor:
    """Drop-in for ``ops.ctc.ctc_forward`` (per-utterance NLL [B]) with the
    α/β recursion in K2."""
    z = extend_labels(labels, blank)
    logp_z = gather_emissions(log_probs.to(torch.float32), z).contiguous()
    skip = skip_bias(z, blank).contiguous()
    lens = logit_lens.to(torch.int32).contiguous()
    end = (2 * label_lens.to(torch.int32)).contiguous()
    return CTCAlphaBeta.apply(logp_z, skip, lens, end)


def ctc_loss_kernel(log_probs, logit_lens, labels, label_lens,
                    blank: int = BLANK_ID,
                    zero_infinity: bool = True) -> torch.Tensor:
    """[B] CTC negative log likelihoods through K2 (counterpart of
    ``ctc_loss_pallas``)."""
    nll = ctc_forward_kernel(log_probs, logit_lens, labels, label_lens, blank)
    return zero_infeasible(nll) if zero_infinity else nll
