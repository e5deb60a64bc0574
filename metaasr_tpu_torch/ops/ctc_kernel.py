"""K2 and K2b: the CTC α/β kernel and its Hessian-vector product, their
plain PyTorch versions, and the loss built on them (counterpart of
``metaasr_tpu/ops/ctc_pallas.py``).

:func:`ctc_alpha_beta` maps label-gathered emissions ``logp_z [B, T, S]``
to ``(nll [B], grad [B, T, S])``, the gradient being the posterior
``-exp(α + β + nll)``. :func:`ctc_hvp` maps the same inputs and a direction
``v [B, T, S]`` to ``(hv, nll_dot)``: ``hv = (∂²nll/∂logp_z²)·v``, the
forward-mode tangent of the α/β recursion, and ``nll_dot = <grad, v>``. On a
CPU tensor they run :func:`plain_ctc_alpha_beta` / :func:`plain_ctc_hvp`; on
a CUDA tensor they launch ``csrc/ctc.cu`` (the source's header gives the
kernels' design and bounds) or raise. There is no size fallback: the
kernels take any T and S up to ``MAX_S``; :func:`plan` picks how a launch
lays out its histories and states.

:func:`ctc_loss_kernel` is the counterpart of ``ctc_loss_pallas``: it
gathers the emissions, builds the skip bias and ``end = 2·label_len``, and
runs the recursion inside :class:`CTCAlphaBeta`, whose backward is
``grad_out[:, None, None] * g`` with the kernel's saved ``g``; the gather's
own backward scatters that to ``[B, T, V]``. The loss is twice
differentiable, as full second-order MAML needs: a backward that builds a
graph (``create_graph=True``) routes ``g`` through :class:`CTCPosterior`
(the counterpart of ``_ctc_pair``), whose backward is K2b. Third order is
unsupported and raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

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


def _lse3_weights(a, b, c):
    """lse3 and its softmax weights from the same three exponentials:
    -> (lse, (e_a, e_b, e_c), sum)."""
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp_min(m, LOG_EPS)
    es = (torch.exp(a - m_safe), torch.exp(b - m_safe), torch.exp(c - m_safe))
    total = (es[0] + es[1]) + es[2]
    return m + torch.log(total), es, total


def _shift0(x: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`_neighbour` for tangents: lanes with no neighbour get 0."""
    out = torch.zeros_like(x)
    if k > 0:
        out[:, :-k] = x[:, k:]
    else:
        out[:, -k:] = x[:, :k]
    return out


def plain_ctc_hvp(logp_z: torch.Tensor, skip: torch.Tensor,
                  lens: torch.Tensor, end: torch.Tensor, v: torch.Tensor):
    """K2b's arithmetic as torch ops over [B, S] rows, in the same order:
    -> (hv [B, T, S], nll_dot [B]). The forward-mode tangent of
    :func:`plain_ctc_alpha_beta` along ``v``: α̇ and β̇ run beside α and β with
    the softmax weights of each lse3; an unreachable state (α or β below
    ``LOG_EPS / 2``) has tangent 0; an infeasible row gives 0 (the clamped
    loss is constant there)."""
    bsz, t_len, s_len = logp_z.shape
    lens = lens.to(torch.int64)[:, None]
    end = end.to(torch.int64)[:, None]
    dead = 0.5 * LOG_EPS
    lane = torch.arange(s_len, device=logp_z.device)[None, :]
    emits = (lane == 0) | ((lane == 1) & (end > 0))
    alpha = torch.where(emits, logp_z[:, 0], LOG_EPS)
    adot = torch.where(emits, v[:, 0], 0.0)
    a_hist, ad_hist = [alpha], [adot]
    for t in range(1, t_len):
        lse, (e0, e1, e2), total = _lse3_weights(
            alpha, _neighbour(alpha, -1), _neighbour(alpha, -2) + skip)
        new = logp_z[:, t] + lse
        mix = ((e0 * adot + e1 * _shift0(adot, -1))
               + e2 * _shift0(adot, -2)) / total
        new_dot = torch.where(new > dead, v[:, t] + mix, 0.0)
        alpha = torch.where(t < lens, new, alpha)
        adot = torch.where(t < lens, new_dot, adot)
        a_hist.append(alpha)
        ad_hist.append(adot)
    a_last = torch.gather(alpha, 1, end)
    prev_at = torch.clamp_min(end - 1, 0)
    a_prev = torch.where(end > 0, torch.gather(alpha, 1, prev_at), LOG_EPS)
    m = torch.where(end > 0, torch.maximum(a_last, a_prev), a_last)
    m_safe = torch.clamp_min(m, LOG_EPS)
    e_last = torch.exp(a_last - m_safe)
    e_prev = torch.where(end > 0, torch.exp(a_prev - m_safe), 0.0)
    total = torch.where(end > 0, e_last + e_prev, e_last)
    nll = -(m + torch.log(total))                             # [B, 1]
    feasible = ~(nll > -dead)
    d_last = torch.gather(adot, 1, end)
    d_prev = torch.where(end > 0, torch.gather(adot, 1, prev_at), 0.0)
    nll_dot = torch.where(
        feasible, -((e_last * d_last + e_prev * d_prev) / total), 0.0)

    pick = (lane == end) | ((lane == end - 1) & (end > 0))
    beta_init = torch.where(pick, 0.0, LOG_EPS)
    hv = torch.empty_like(logp_z)
    carry, carry_dot = beta_init, torch.zeros_like(beta_init)
    for t in range(t_len - 1, -1, -1):
        at_last = t >= lens - 1
        beta_t = torch.where(at_last, beta_init, carry)
        bdot = torch.where(at_last, 0.0, carry_dot)
        g = -torch.exp(a_hist[t] + beta_t + nll)
        hv[:, t] = torch.where((t < lens) & feasible,
                               g * ((ad_hist[t] + bdot) + nll_dot), 0.0)
        cur = beta_t + logp_z[:, t]
        cur_dot = bdot + v[:, t]
        carry, (e0, e1, e2), total = _lse3_weights(
            cur, _neighbour(cur, 1), _neighbour(cur + skip, 2))
        mix = ((e0 * cur_dot + e1 * _shift0(cur_dot, 1))
               + e2 * _shift0(cur_dot, 2)) / total
        carry_dot = torch.where(carry > dead, mix, 0.0)
    return hv, nll_dot[:, 0]


MAX_S = 1024        # csrc/ctc.cu: states (lanes) of an utterance
MAX_K = 8           # states a thread holds
RING = 8            # rows of logp_z (and v) a streamed recursion keeps ahead
STATIC_SMEM = 1024  # the kernel's static shared memory (edge states), rounded


def plan(t_len: int, s_len: int, smem_limit: int,
         tangent: bool = False) -> dict:
    """How K2 (K2b with ``tangent``) runs [*, T, S] on a device whose blocks
    can opt into ``smem_limit`` bytes of shared memory: ``warps`` per
    recursion and ``k`` states per thread (k = ceil(S / 32 warps) <= MAX_K,
    the fewest warps that allow it); ``layout`` "resident" when logp_z (and
    v) and the histories (alpha, beta; adot, bdot) fit in shared memory, else
    "streamed" (histories in global memory, rows through a ring); the
    launch's dynamic ``smem_bytes``; and ``scratch``, the [B, T, S] f32
    arrays the caller allocates (streamed: beta's history, and adot's and
    bdot's). Raises for S > MAX_S."""
    if s_len > MAX_S or s_len < 1 or t_len < 1:
        raise ValueError(f"S={s_len} exceeds the kernel's {MAX_S} lanes"
                         if s_len > MAX_S else
                         f"T={t_len}, S={s_len}: both must be >= 1")
    warps = -(-s_len // (32 * MAX_K))
    arrays = 2 if tangent else 1   # logp_z, and v under the tangent
    out = {"warps": warps, "k": -(-s_len // (32 * warps)),
           "layout": "resident", "smem_bytes": 4 * arrays * 3 * t_len * s_len,
           "scratch": 0}
    if out["smem_bytes"] + STATIC_SMEM > smem_limit:
        out.update(layout="streamed", smem_bytes=4 * arrays * 2 * RING * s_len,
                   scratch=2 * arrays - 1)
        if out["smem_bytes"] + STATIC_SMEM > smem_limit:
            raise ValueError(f"S={s_len} needs {out['smem_bytes']} bytes of "
                             f"shared memory; the device allows {smem_limit}")
    return out


_smem: dict = {}


def _smem_limit(lib, device: torch.device) -> int:
    """The opt-in shared memory per block of ``device``, cached."""
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in _smem:
        with torch.cuda.device(key):
            _smem[key] = lib.metaasr_ctc_smem_optin()
    return _smem[key]


def launch_plan(logp_z: torch.Tensor, tangent: bool = False) -> dict:
    """The :func:`plan` of a launch on ``logp_z`` (a CUDA tensor)."""
    lib = _library()
    _, t_len, s_len = logp_z.shape
    _check_lanes(lib, s_len)
    return plan(t_len, s_len, _smem_limit(lib, logp_z.device), tangent)


def _launch_args(logp_z: torch.Tensor, tangent: bool):
    """(the plan's scratch tensor or None, the C call's trailing arguments)
    for a launch on ``logp_z``'s device. The caller holds the scratch tensor
    until the launch is queued; the stream orders its reuse after that."""
    pl = launch_plan(logp_z, tangent)
    scratch = (torch.empty((pl["scratch"],) + tuple(logp_z.shape),
                           dtype=torch.float32, device=logp_z.device)
               if pl["scratch"] else None)
    stream = torch.cuda.current_stream(logp_z.device).cuda_stream
    tail = (None if scratch is None else scratch.data_ptr(),
            *logp_z.shape, pl["k"], pl["warps"],
            int(pl["layout"] == "streamed"), pl["smem_bytes"], stream)
    return scratch, tail


@functools.cache
def _library():
    from metaasr_tpu_torch.ops import _build

    lib = _build.load("ctc")
    lib.metaasr_ctc_max_lanes.restype = ctypes.c_int
    lib.metaasr_ctc_smem_optin.restype = ctypes.c_int
    lib.metaasr_ctc_alpha_beta.restype = ctypes.c_int
    lib.metaasr_ctc_alpha_beta.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.metaasr_ctc_hvp.restype = ctypes.c_int
    lib.metaasr_ctc_hvp.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return lib


def _check(logp_z, skip, lens, end, v=None) -> bool:
    """Raise on what the kernels do not take; -> True when the tensors lie
    on a CUDA device (launch), False on the CPU (plain version)."""
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
    tensors = [logp_z, skip, lens, end]
    if v is not None:
        if v.shape != logp_z.shape or v.dtype != torch.float32:
            raise ValueError(f"v must be {tuple(logp_z.shape)} float32, got "
                             f"{tuple(v.shape)} {v.dtype}")
        tensors.append(v)
    if any(x.device != logp_z.device for x in tensors):
        raise ValueError("all inputs must be on one device")
    if logp_z.device.type == "cpu":
        return False
    if logp_z.device.type != "cuda":
        raise ValueError(f"unsupported device {logp_z.device}")
    if lens.dtype != torch.int32 or end.dtype != torch.int32:
        raise ValueError("lens and end must be int32")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("inputs must be contiguous")
    return True


def _check_lanes(lib, s_len: int) -> None:
    if s_len > lib.metaasr_ctc_max_lanes():
        raise ValueError(f"S={s_len} exceeds the kernel's "
                         f"{lib.metaasr_ctc_max_lanes()} lanes")


def ctc_alpha_beta(logp_z: torch.Tensor, skip: torch.Tensor,
                   lens: torch.Tensor, end: torch.Tensor):
    """logp_z [B, T, S] f32, skip [B, S] f32, lens/end [B] int32 ->
    (nll [B], grad [B, T, S]). A CPU tensor runs the plain version; a CUDA
    tensor launches K2 (counted in ``launches``) or raises."""
    if not _check(logp_z, skip, lens, end):
        return plain_ctc_alpha_beta(logp_z, skip, lens, end)
    scratch, tail = _launch_args(logp_z, tangent=False)
    lib = _library()
    nll = torch.empty((logp_z.shape[0],), dtype=torch.float32,
                      device=logp_z.device)
    grad = torch.empty_like(logp_z)
    rc = lib.metaasr_ctc_alpha_beta(
        logp_z.data_ptr(), skip.data_ptr(), lens.data_ptr(), end.data_ptr(),
        nll.data_ptr(), grad.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(f"ctc kernel launch failed: cudaError {rc}")
    ctc_alpha_beta.launches += 1
    return nll, grad


ctc_alpha_beta.launches = 0


def ctc_hvp(logp_z: torch.Tensor, skip: torch.Tensor, lens: torch.Tensor,
            end: torch.Tensor, v: torch.Tensor):
    """K2's inputs and a direction v [B, T, S] f32 -> (hv [B, T, S] =
    (∂²nll/∂logp_z²)·v, nll_dot [B] = <grad, v>). A CPU tensor runs the
    plain version; a CUDA tensor launches K2b (counted in ``launches``) or
    raises. Where :func:`plan` streams the histories, their [3, B, T, S]
    scratch is allocated here."""
    if not _check(logp_z, skip, lens, end, v):
        return plain_ctc_hvp(logp_z, skip, lens, end, v)
    scratch, tail = _launch_args(logp_z, tangent=True)
    lib = _library()
    hv = torch.empty_like(logp_z)
    nll_dot = torch.empty((logp_z.shape[0],), dtype=torch.float32,
                          device=logp_z.device)
    rc = lib.metaasr_ctc_hvp(
        logp_z.data_ptr(), skip.data_ptr(), lens.data_ptr(), end.data_ptr(),
        v.data_ptr(), tail[0], hv.data_ptr(), nll_dot.data_ptr(), *tail[1:])
    if rc != 0:
        raise RuntimeError(f"ctc hvp kernel launch failed: cudaError {rc}")
    ctc_hvp.launches += 1
    return hv, nll_dot


ctc_hvp.launches = 0


class CTCPosterior(torch.autograd.Function):
    """The posterior gradient ``g = ∂nll/∂logp_z`` as a differentiable
    function of ``logp_z`` (counterpart of ``_ctc_pair``). The forward
    reuses the tensor K2 computed in :class:`CTCAlphaBeta`'s forward, passed
    in as ``g``: it does not launch K2 again. The backward is K2b: the
    Hessian is symmetric, so the cotangent of ``g`` goes in as the direction.
    First order only: third-order differentiation raises."""

    @staticmethod
    def forward(ctx, logp_z, skip, lens, end, g):
        ctx.save_for_backward(logp_z, skip, lens, end)
        return g.view_as(g)

    @staticmethod
    def backward(ctx, cotangent):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "third-order differentiation of the CTC loss is unsupported: "
                "the Hessian-vector product (K2b) is not differentiable "
                "again; full MAML needs exactly two orders")
        logp_z, skip, lens, end = ctx.saved_tensors
        hv, _ = ctc_hvp(logp_z, skip, lens, end, cotangent.contiguous())
        return hv, None, None, None, None


class CTCAlphaBeta(torch.autograd.Function):
    """nll [B] from K2 in forward; backward scales the kernel's posterior
    gradient ``g`` by the incoming cotangent. Under a plain backward ``g``
    is the saved tensor, a constant. Under a backward that builds a graph
    (``create_graph=True``, as second-order MAML's inner gradient does) ``g``
    goes through :class:`CTCPosterior`, so the outer backward reaches the
    CTC Hessian through K2b instead of silently dropping it.

    The forward cannot know which backward will follow, so it saves K2's
    inputs beside ``g`` on every path: a first-order caller launches exactly
    what it would without K2b, but keeps one more [B, T, S] fp32 tensor
    (``logp_z``) alive per CTC call until its backward has run."""

    @staticmethod
    def forward(ctx, logp_z, skip, lens, end):
        nll, grad = ctc_alpha_beta(logp_z, skip, lens, end)
        ctx.save_for_backward(logp_z, skip, lens, end, grad)
        return nll

    @staticmethod
    def backward(ctx, grad_out):
        logp_z, skip, lens, end, g = ctx.saved_tensors
        if torch.is_grad_enabled():
            g = CTCPosterior.apply(logp_z, skip, lens, end, g)
        return grad_out[:, None, None] * g, None, None, None


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
