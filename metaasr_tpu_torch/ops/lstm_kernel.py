"""K3 / K3b: the LSTM recurrence kernels, their plain PyTorch versions and
the autograd Function over them (counterpart of
``metaasr_tpu/ops/lstm_pallas.py``).

:func:`lstm_recurrence` maps ``gx [T, B, 4H]`` (input projection and bias
already applied) and the recurrent matrix ``u [H, 4H]`` to ``h_seq
[T, B, H]``: per step ``g = gx[t] + h @ u``, gates (i, f, g, o) with +1 on
the forget gate, ``c = f*c + i*g``, ``h = o*tanh(c)``, zero initial state.
On CPU tensors it runs :func:`plain_lstm_forward` and, in backward, the
explicit BPTT of :func:`plain_lstm_backward`; on CUDA tensors it launches
``csrc/lstm.cu`` (K3 forward, K3b backward with the ``dU`` product; the
source's header gives the design and the bound) or raises. There is no size
fallback: the kernels take any T and B and every H that is a multiple of 4.

Length masking is not part of the recurrence: padded steps come after the
valid ones and are run through; callers mask the outputs. The Function is
first order only, as the reference's custom VJP: a backward that builds a
graph (``create_graph=True``) raises; :func:`lstm_scan`, the step loop under
autograd, differentiates to any order.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable


def _gates(g: torch.Tensor, hidden: int):
    i = torch.sigmoid(g[:, :hidden])
    f = torch.sigmoid(g[:, hidden: 2 * hidden] + 1.0)
    gg = torch.tanh(g[:, 2 * hidden: 3 * hidden])
    o = torch.sigmoid(g[:, 3 * hidden:])
    return i, f, gg, o


def plain_lstm_forward(gx: torch.Tensor, u: torch.Tensor):
    """The step loop as torch ops -> (h_seq, c_seq), each [T, B, H]."""
    t_len, bsz, h4 = gx.shape
    hidden = h4 // 4
    h = gx.new_zeros((bsz, hidden))
    c = gx.new_zeros((bsz, hidden))
    hs, cs = [], []
    for t in range(t_len):
        i, f, gg, o = _gates(gx[t] + h @ u, hidden)
        c = f * c + i * gg
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    empty = gx.new_zeros((0, bsz, hidden))
    return (torch.stack(hs) if hs else empty,
            torch.stack(cs) if cs else empty)


def lstm_scan(gx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """h_seq by the step loop under autograd (``lstm_impl: scan``)."""
    return plain_lstm_forward(gx, u)[0]


def plain_lstm_backward(gx, u, h_seq, c_seq, dout):
    """The kernel's BPTT formulas as torch ops, time reversed, gates
    recomputed from ``gx[t] + h[t-1] @ u`` -> (dgx [T, B, 4H], du [H, 4H])."""
    t_len, bsz, h4 = gx.shape
    hidden = h4 // 4
    zeros = gx.new_zeros((bsz, hidden))
    dh, dc = zeros, zeros
    dgx = torch.empty_like(gx)
    du = torch.zeros_like(u)
    for t in range(t_len - 1, -1, -1):
        h_prev = h_seq[t - 1] if t > 0 else zeros
        c_prev = c_seq[t - 1] if t > 0 else zeros
        i, f, gg, o = _gates(gx[t] + h_prev @ u, hidden)
        tc = torch.tanh(c_seq[t])
        dh_tot = dout[t] + dh
        dc_tot = dh_tot * o * (1.0 - tc * tc) + dc
        do_pre = dh_tot * tc * o * (1.0 - o)
        df_pre = dc_tot * c_prev * f * (1.0 - f)
        di_pre = dc_tot * gg * i * (1.0 - i)
        dg_pre = dc_tot * i * (1.0 - gg * gg)
        dgates = torch.cat([di_pre, df_pre, dg_pre, do_pre], dim=1)
        dgx[t] = dgates
        dh = dgates @ u.T
        dc = dc_tot * f
        du = du + h_prev.T @ dgates
    return dgx, du


def _library():
    from metaasr_tpu_torch.ops import _build

    lib = _build.load("lstm")
    lib.metaasr_lstm_forward.restype = ctypes.c_int
    lib.metaasr_lstm_forward.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.metaasr_lstm_backward.restype = ctypes.c_int
    lib.metaasr_lstm_backward.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


def _check(gx: torch.Tensor, u: torch.Tensor, others=()):
    """Validate the recurrence's inputs -> (T, B, H)."""
    if gx.dim() != 3 or gx.shape[2] % 4 or gx.shape[2] == 0:
        raise ValueError(f"gx must be [T, B, 4H], got {tuple(gx.shape)}")
    t_len, bsz, h4 = gx.shape
    hidden = h4 // 4
    if u.shape != (hidden, h4):
        raise ValueError(f"u must be [{hidden}, {h4}], got {tuple(u.shape)}")
    for name, x in others:
        if x.shape != (t_len, bsz, hidden):
            raise ValueError(f"{name} must be [{t_len}, {bsz}, {hidden}], "
                             f"got {tuple(x.shape)}")
    tensors = [gx, u] + [x for _, x in others]
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError("the LSTM recurrence takes float32 tensors")
    if any(x.device != gx.device for x in tensors):
        raise ValueError("all inputs must be on one device")
    if gx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {gx.device}")
    if gx.device.type == "cuda":
        if not all(x.is_contiguous() for x in tensors):
            raise ValueError("inputs must be contiguous")
        if hidden % 4 or u.data_ptr() % 16:
            raise ValueError("the kernels read u in 16-byte groups: H must "
                             "be a multiple of 4 and u 16 bytes aligned")
    return t_len, bsz, hidden


def lstm_forward(gx: torch.Tensor, u: torch.Tensor):
    """gx [T, B, 4H], u [H, 4H] -> (h_seq, c_seq) [T, B, H], no autograd.
    A CPU tensor runs the plain version; a CUDA tensor launches K3 (counted
    in ``lstm_recurrence.launches``) or raises."""
    t_len, bsz, hidden = _check(gx, u)
    if gx.device.type == "cpu":
        return plain_lstm_forward(gx, u)
    h_seq = torch.empty((t_len, bsz, hidden), dtype=torch.float32,
                        device=gx.device)
    c_seq = torch.empty_like(h_seq)
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    rc = _library().metaasr_lstm_forward(
        gx.data_ptr(), u.data_ptr(), h_seq.data_ptr(), c_seq.data_ptr(),
        t_len, bsz, hidden, stream)
    if rc != 0:
        raise RuntimeError(f"lstm forward kernel launch failed: cudaError {rc}")
    lstm_recurrence.launches += 1
    return h_seq, c_seq


def lstm_backward(gx, u, h_seq, c_seq, dout):
    """-> (dgx [T, B, 4H], du [H, 4H]) for the cotangent ``dout`` of h_seq.
    A CPU tensor runs the plain BPTT; a CUDA tensor launches K3b (the
    reversed recurrence, then the ``dU`` product; counted in
    ``lstm_recurrence.bwd_launches``) or raises."""
    t_len, bsz, hidden = _check(gx, u, (("h_seq", h_seq), ("c_seq", c_seq),
                                        ("dout", dout)))
    if gx.device.type == "cpu":
        return plain_lstm_backward(gx, u, h_seq, c_seq, dout)
    dgx = torch.empty_like(gx)
    du = torch.empty_like(u)
    # the reversed recurrence walks rows of u: a transposed copy gives that
    # product the forward's coalesced access (csrc/lstm.cu)
    ut = u.t().contiguous()
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    rc = _library().metaasr_lstm_backward(
        gx.data_ptr(), u.data_ptr(), ut.data_ptr(), h_seq.data_ptr(),
        c_seq.data_ptr(), dout.data_ptr(), dgx.data_ptr(), du.data_ptr(),
        t_len, bsz, hidden, stream)
    if rc != 0:
        raise RuntimeError(f"lstm backward kernel launch failed: cudaError {rc}")
    lstm_recurrence.bwd_launches += 1
    return dgx, du


@once_differentiable
def _bptt(ctx, dout):
    gx, u, h_seq, c_seq = ctx.saved_tensors
    return lstm_backward(gx, u, h_seq, c_seq, dout.contiguous())


class LSTMRecurrence(torch.autograd.Function):
    """h_seq from K3 in forward (gx, u, h_seq, c_seq saved); backward is
    K3b. First order only: a backward that builds a graph for a second one
    raises, since the saved state would enter it as constants."""

    @staticmethod
    def forward(ctx, gx, u):
        h_seq, c_seq = lstm_forward(gx, u)
        ctx.save_for_backward(gx, u, h_seq, c_seq)
        return h_seq

    @staticmethod
    def backward(ctx, dout):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "the LSTM recurrence Function is first order only; a "
                "differentiable backward (create_graph=True) needs "
                "lstm_impl='scan' (ASRTask.require_full_autodiff)")
        return _bptt(ctx, dout)


def lstm_recurrence(gx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """gx [T, B, 4H] f32, u [H, 4H] f32 -> h_seq [T, B, H], differentiable
    (first order) through K3b."""
    return LSTMRecurrence.apply(gx, u)


lstm_recurrence.launches = 0
lstm_recurrence.bwd_launches = 0
