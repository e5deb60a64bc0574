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
source's header gives the cluster design and the bound) or raises. When a
backward can follow, the forward also writes the post-activation gates and
the Function saves them in place of ``gx`` (same size), so the backward
recomputes no ``h @ u``. There is no size fallback: the kernels take any T
and B and every H that is a multiple of 4 up to 5,808, where a batch tile's
h buffers and dh pieces fill a CTA's shared memory.

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
    """The step loop as torch ops -> (h_seq, c_seq [T, B, H], gates
    [T, B, 4H]), the gates post-activation (i, f, g, o)."""
    t_len, bsz, h4 = gx.shape
    hidden = h4 // 4
    h = gx.new_zeros((bsz, hidden))
    c = gx.new_zeros((bsz, hidden))
    hs, cs, gs = [], [], []
    for t in range(t_len):
        i, f, gg, o = _gates(gx[t] + h @ u, hidden)
        c = f * c + i * gg
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
        gs.append(torch.cat([i, f, gg, o], dim=1))
    if not hs:
        empty = gx.new_zeros((0, bsz, hidden))
        return empty, empty, gx.new_zeros((0, bsz, h4))
    return torch.stack(hs), torch.stack(cs), torch.stack(gs)


def lstm_scan(gx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """h_seq by the step loop under autograd (``lstm_impl: scan``)."""
    return plain_lstm_forward(gx, u)[0]


def plain_lstm_backward(gates, u, h_seq, c_seq, dout):
    """The kernel's BPTT formulas as torch ops, time reversed, from the
    forward's saved gates -> (dgx [T, B, 4H], du [H, 4H])."""
    t_len, bsz, h4 = gates.shape
    hidden = h4 // 4
    zeros = gates.new_zeros((bsz, hidden))
    dh, dc = zeros, zeros
    dgx = torch.empty_like(gates)
    du = torch.zeros_like(u)
    for t in range(t_len - 1, -1, -1):
        h_prev = h_seq[t - 1] if t > 0 else zeros
        c_prev = c_seq[t - 1] if t > 0 else zeros
        i, f, gg, o = gates[t].split(hidden, dim=1)
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
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, args in (
            ("metaasr_lstm_plan", [i32] * 3 + [ptr]),
            ("metaasr_lstm_forward", [ptr] * 5 + [i32] * 5 + [ptr]),
            ("metaasr_lstm_bptt", [ptr] * 5 + [i32] * 5 + [ptr]),
            ("metaasr_lstm_du", [ptr] * 3 + [i32] * 4 + [ptr]),
            ("metaasr_lstm_du_splits", [i32] * 3)):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = args
    return lib


PLAN_KEYS = ("cluster", "tile", "smem_fwd_bytes", "smem_bwd_bytes",
             "resident_rows_fwd", "resident_rows_bwd",
             "max_active_clusters_fwd", "max_active_clusters_bwd")
_plans: dict = {}


def plan(bsz: int, hidden: int, device, tile: int = 0) -> dict:
    """Cluster size and batch tile of the kernels for [B, H] on ``device``
    (``tile`` 0: the kernel's own choice), with the shared memory per CTA,
    the rows of U's slice that stay resident and
    ``cudaOccupancyMaxActiveClusters``; cached."""
    key = (bsz, hidden, tile, torch.device(device).index)
    got = _plans.get(key)
    if got is None:
        out = (ctypes.c_int * len(PLAN_KEYS))()
        with torch.cuda.device(device):
            rc = _library().metaasr_lstm_plan(bsz, hidden, tile, out)
        if rc != 0:
            raise RuntimeError(f"no thread-block cluster of the LSTM kernels "
                               f"can run at B={bsz}, H={hidden}: cudaError {rc} "
                               f"(they take H a multiple of 4 up to 5,808)")
        got = _plans[key] = dict(zip(PLAN_KEYS, out))
    return got


def _check(x: torch.Tensor, u: torch.Tensor, others=(), name="gx"):
    """Validate the recurrence's inputs (``x`` is gx or the saved gates,
    [T, B, 4H]) -> (T, B, H)."""
    if x.dim() != 3 or x.shape[2] % 4 or x.shape[2] == 0:
        raise ValueError(f"{name} must be [T, B, 4H], got {tuple(x.shape)}")
    t_len, bsz, h4 = x.shape
    hidden = h4 // 4
    if u.shape != (hidden, h4):
        raise ValueError(f"u must be [{hidden}, {h4}], got {tuple(u.shape)}")
    for other, y in others:
        if y.shape != (t_len, bsz, hidden):
            raise ValueError(f"{other} must be [{t_len}, {bsz}, {hidden}], "
                             f"got {tuple(y.shape)}")
    tensors = [x, u] + [y for _, y in others]
    if any(y.dtype != torch.float32 for y in tensors):
        raise ValueError("the LSTM recurrence takes float32 tensors")
    if any(y.device != x.device for y in tensors):
        raise ValueError("all inputs must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda":
        if not all(y.is_contiguous() for y in tensors):
            raise ValueError("inputs must be contiguous")
        if hidden % 4 or u.data_ptr() % 16:
            raise ValueError("H must be a multiple of 4 (the kernels read h "
                             "in 16-byte groups) and u 16 bytes aligned")
    return t_len, bsz, hidden


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"lstm {what} kernel launch failed: cudaError {rc}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_forward(gx, u, h_seq, c_seq, gates, p) -> None:
    t_len, bsz, h4 = gx.shape
    _raise_on(_library().metaasr_lstm_forward(
        gx.data_ptr(), u.data_ptr(), h_seq.data_ptr(), c_seq.data_ptr(),
        None if gates is None else gates.data_ptr(), t_len, bsz, h4 // 4,
        p["cluster"], p["tile"], _stream(gx)), "forward")


def _launch_bptt(gates, u, c_seq, dout, dgx, p) -> None:
    t_len, bsz, h4 = gates.shape
    _raise_on(_library().metaasr_lstm_bptt(
        gates.data_ptr(), u.data_ptr(), c_seq.data_ptr(), dout.data_ptr(),
        dgx.data_ptr(), t_len, bsz, h4 // 4, p["cluster"], p["tile"],
        _stream(gates)), "backward")


def du_splits(t_len: int, bsz: int, hidden: int, device) -> int:
    """CTAs that split the dU product's sum over T and B (a cluster each
    output tile), as the kernel picks them on ``device``."""
    with torch.cuda.device(device):
        return _library().metaasr_lstm_du_splits(t_len, bsz, hidden)


def _launch_du(h_seq, dgx, du, splits: int = 0) -> None:
    t_len, bsz, hidden = h_seq.shape
    _raise_on(_library().metaasr_lstm_du(
        h_seq.data_ptr(), dgx.data_ptr(), du.data_ptr(), t_len, bsz, hidden,
        splits, _stream(h_seq)), "dU")


def lstm_forward(gx: torch.Tensor, u: torch.Tensor, gates: bool = True):
    """gx [T, B, 4H], u [H, 4H] -> (h_seq, c_seq [T, B, H], gates
    [T, B, 4H] or None when ``gates`` is false), no autograd. A CPU tensor
    runs the plain version; a CUDA tensor launches K3 (counted in
    ``lstm_recurrence.launches``) or raises."""
    t_len, bsz, hidden = _check(gx, u)
    if gx.device.type == "cpu":
        h_seq, c_seq, g = plain_lstm_forward(gx, u)
        return h_seq, c_seq, g if gates else None
    h_seq = torch.empty((t_len, bsz, hidden), dtype=torch.float32,
                        device=gx.device)
    c_seq = torch.empty_like(h_seq)
    g = torch.empty_like(gx) if gates else None
    _launch_forward(gx, u, h_seq, c_seq, g, plan(bsz, hidden, gx.device))
    lstm_recurrence.launches += 1
    return h_seq, c_seq, g


def lstm_backward(gates, u, h_seq, c_seq, dout):
    """-> (dgx [T, B, 4H], du [H, 4H]) for the cotangent ``dout`` of h_seq,
    from the forward's saved ``gates``. A CPU tensor runs the plain BPTT; a
    CUDA tensor launches K3b (the reversed recurrence, then the ``dU``
    product; counted once in ``lstm_recurrence.bwd_launches``) or raises."""
    t_len, bsz, hidden = _check(gates, u, (("h_seq", h_seq),
                                           ("c_seq", c_seq), ("dout", dout)),
                                name="gates")
    if gates.device.type == "cpu":
        return plain_lstm_backward(gates, u, h_seq, c_seq, dout)
    dgx = torch.empty_like(gates)
    du = torch.empty_like(u)
    _launch_bptt(gates, u, c_seq, dout, dgx, plan(bsz, hidden, gates.device))
    _launch_du(h_seq, dgx, du)
    lstm_recurrence.bwd_launches += 1
    return dgx, du


@once_differentiable
def _bptt(ctx, dout):
    gates, u, h_seq, c_seq = ctx.saved_tensors
    return (*lstm_backward(gates, u, h_seq, c_seq, dout.contiguous()), None)


class LSTMRecurrence(torch.autograd.Function):
    """h_seq from K3 in forward; with ``save`` the gates it wrote are saved
    beside u, h_seq and c_seq, and backward is K3b. First order only: a
    backward that builds a graph for a second one raises, since the saved
    state would enter it as constants."""

    @staticmethod
    def forward(ctx, gx, u, save):
        h_seq, c_seq, gates = lstm_forward(gx, u, gates=save)
        if save:
            ctx.save_for_backward(gates, u, h_seq, c_seq)
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
    (first order) through K3b. The gates are written and saved only when a
    backward can follow (grad mode on and gx or u requiring grad)."""
    save = torch.is_grad_enabled() and (gx.requires_grad or u.requires_grad)
    return LSTMRecurrence.apply(gx, u, save)


lstm_recurrence.launches = 0
lstm_recurrence.bwd_launches = 0
