"""Port vs reference: the LSTM recurrence (K3 / K3b).

On the CPU the port's wrapper runs the kernels' plain versions: the step
loop forward and the explicit BPTT formulas backward. They are held against
the reference's Pallas kernel in interpret mode and its ``lax.scan``
formulation at the reference's own tolerances (``tests/test_m3_pallas.py``:
forward rtol 1e-5 / atol 1e-6, dgx rtol 1e-3 / atol 1e-4, dU rtol 1e-3 /
atol 1e-3), and against autograd of the loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.ops.lstm_pallas import lstm_scan_reference, pallas_lstm
from metaasr_tpu_torch.models.vgg_blstm import LSTMLayer
from metaasr_tpu_torch.ops import lstm_kernel
from metaasr_tpu_torch.ops.lstm_kernel import (
    lstm_backward,
    lstm_forward,
    lstm_recurrence,
    lstm_scan,
    plain_lstm_backward,
    plain_lstm_forward,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SHAPES = [(37, 5, 24), (20, 3, 32)]   # the reference's own case; H = 32


def _inputs(shape, seed=0):
    t_len, bsz, hidden = shape
    rng = np.random.default_rng(seed)
    gx = 0.5 * rng.standard_normal((t_len, bsz, 4 * hidden))
    u = 0.3 * rng.standard_normal((hidden, 4 * hidden))
    return gx.astype(np.float32), u.astype(np.float32)


def _port_grads(fn, gx, u, w):
    gx_t = torch.from_numpy(gx).requires_grad_(True)
    u_t = torch.from_numpy(u).requires_grad_(True)
    out = fn(gx_t, u_t)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), gx_t.grad.numpy(), u_t.grad.numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("ref", ["pallas_interpret", "scan"])
def test_recurrence_matches_reference(shape, ref):
    gx, u = _inputs(shape)
    ref_fn = ((lambda g, uu: pallas_lstm(g, uu, True))
              if ref == "pallas_interpret" else lstm_scan_reference)
    w = np.arange(1, shape[0] + 1, dtype=np.float32)[:, None, None] \
        * np.ones(shape, np.float32)
    want = ref_fn(jnp.asarray(gx), jnp.asarray(u))
    want_g = jax.grad(lambda g, uu: (ref_fn(g, uu) * jnp.asarray(w)).sum(),
                      argnums=(0, 1))(jnp.asarray(gx), jnp.asarray(u))
    before = (lstm_recurrence.launches, lstm_recurrence.bwd_launches)
    got, dgx, du = _port_grads(lstm_recurrence, gx, u, w)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dgx, np.asarray(want_g[0]), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(du, np.asarray(want_g[1]), rtol=1e-3,
                               atol=1e-3)
    # CPU tensors never reach the kernels
    assert (lstm_recurrence.launches, lstm_recurrence.bwd_launches) == before


@pytest.mark.parametrize("shape", SHAPES + [(1, 2, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_explicit_bptt_matches_autograd_of_the_loop(shape):
    gx, u = _inputs(shape, seed=1)
    w = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    h_loop, dgx_loop, du_loop = _port_grads(lstm_scan, gx, u, w)
    gx_t, u_t = torch.from_numpy(gx), torch.from_numpy(u)
    h_seq, c_seq, gates = plain_lstm_forward(gx_t, u_t)
    dgx, du = plain_lstm_backward(gates, u_t, h_seq, c_seq,
                                  torch.from_numpy(w))
    np.testing.assert_array_equal(h_seq.numpy(), h_loop)
    np.testing.assert_allclose(dgx.numpy(), dgx_loop, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(du.numpy(), du_loop, rtol=1e-4, atol=1e-5)
    # the wrappers take the plain versions for CPU tensors
    h2, c2, g2 = lstm_forward(gx_t, u_t)
    assert torch.equal(h2, h_seq) and torch.equal(c2, c_seq)
    assert torch.equal(g2, gates)
    assert lstm_forward(gx_t, u_t, gates=False)[2] is None
    dgx2, du2 = lstm_backward(gates, u_t, h_seq, c_seq, torch.from_numpy(w))
    assert torch.equal(dgx2, dgx) and torch.equal(du2, du)


def test_double_backward_raises_and_scan_allows_it():
    gx, u = _inputs((6, 2, 8), seed=3)
    gx_t = torch.from_numpy(gx).requires_grad_(True)
    u_t = torch.from_numpy(u).requires_grad_(True)
    with pytest.raises(RuntimeError, match="first order only"):
        torch.autograd.grad(lstm_recurrence(gx_t, u_t).sum(), gx_t,
                            create_graph=True)
    (g,) = torch.autograd.grad(lstm_scan(gx_t, u_t).sum(), gx_t,
                               create_graph=True)
    (gg,) = torch.autograd.grad(g.square().sum(), u_t)
    assert torch.isfinite(gg).all() and gg.abs().max() > 0


def test_recurrence_checks_inputs():
    gx, u = (torch.from_numpy(a) for a in _inputs((4, 2, 8)))
    with pytest.raises(ValueError, match=r"\[T, B, 4H\]"):
        lstm_forward(gx[0], u)
    with pytest.raises(ValueError, match=r"\[T, B, 4H\]"):
        lstm_forward(gx[:, :, :30], u)
    with pytest.raises(ValueError, match="u must be"):
        lstm_forward(gx, u.T)
    with pytest.raises(ValueError, match="float32"):
        lstm_forward(gx.double(), u.double())
    h, c, g = lstm_forward(gx, u)
    with pytest.raises(ValueError, match="dout must be"):
        lstm_backward(g, u, h, c, h[:2])
    with pytest.raises(ValueError, match="one device"):
        lstm_forward(gx, u.to("meta"))
    # inference mode runs the forward alone
    with torch.inference_mode():
        assert torch.equal(lstm_recurrence(gx, u), h)
    assert lstm_kernel.lstm_recurrence.launches == 0


def test_plain_gates_are_the_activations():
    """The saved gates are sigmoid/tanh of gx[t] + h[t-1] @ u, exactly."""
    gx, u = (torch.from_numpy(a) for a in _inputs((9, 3, 8), seed=6))
    h_seq, c_seq, gates = plain_lstm_forward(gx, u)
    assert gates.shape == gx.shape
    h_prev = torch.cat([torch.zeros_like(h_seq[:1]), h_seq[:-1]])
    for t in range(gx.shape[0]):
        g = gx[t] + h_prev[t] @ u
        want = torch.cat([torch.sigmoid(g[:, :8]), torch.sigmoid(g[:, 8:16] + 1.0),
                          torch.tanh(g[:, 16:24]), torch.sigmoid(g[:, 24:])], 1)
        assert torch.equal(gates[t], want)
        i, f, gg, o = gates[t].split(8, dim=1)
        c = f * (c_seq[t - 1] if t else torch.zeros_like(c_seq[0])) + i * gg
        assert torch.equal(c_seq[t], c)
        assert torch.equal(h_seq[t], o * torch.tanh(c))


@pytest.mark.parametrize("grad", [False, True])
def test_gates_saved_only_when_a_backward_can_follow(grad, monkeypatch):
    """Under no_grad (evaluation, serving) the forward writes no gates and
    the Function saves nothing; with grad it saves (gates, u, h_seq, c_seq)."""
    gx, u = (torch.from_numpy(a) for a in _inputs((5, 2, 8), seed=7))
    gx.requires_grad_(True)
    asked, saved = [], []
    real = lstm_kernel.lstm_forward

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        asked.append((kwargs.get("gates"), out[2] is not None))
        return out

    monkeypatch.setattr(lstm_kernel, "lstm_forward", spy)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append(tuple(x.shape)) or x, lambda x: x):
        with torch.set_grad_enabled(grad):
            h = lstm_recurrence(gx, u)
    assert asked == [(grad, grad)]
    assert h.requires_grad == grad
    if grad:
        assert saved == [(5, 2, 32), (8, 32), (5, 2, 8), (5, 2, 8)]
    else:
        assert saved == []


def test_check_rejects_misshaped_gates():
    gx, u = (torch.from_numpy(a) for a in _inputs((4, 2, 8)))
    h, c, g = lstm_forward(gx, u)
    with pytest.raises(ValueError, match=r"gates must be \[T, B, 4H\]"):
        lstm_backward(g[:, :, :30], u, h, c, h)
    with pytest.raises(ValueError, match=r"gates must be \[T, B, 4H\]"):
        lstm_backward(g[0], u, h, c, h)
    with pytest.raises(ValueError, match="u must be"):
        lstm_backward(g[:, :, :16], u, h, c, h)
    with pytest.raises(ValueError, match="h_seq must be"):
        lstm_backward(g[:3], u, h, c, h)


@pytest.mark.parametrize("reverse", [False, True])
def test_layer_impls_agree(reverse):
    """``lstm_impl`` scan, pallas and auto give the same layer output and
    parameter gradients."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 11, 10)).astype(np.float32))
    lens = torch.tensor([11, 7, 1])
    layers = {impl: LSTMLayer(10, 8, reverse, impl=impl)
              for impl in ("scan", "pallas", "auto")}
    outs, grads = {}, {}
    for impl, layer in layers.items():
        layer.load_state_dict(layers["scan"].state_dict())
        out = layer(x, lens)
        out.square().sum().backward()
        outs[impl] = out.detach()
        grads[impl] = {k: p.grad for k, p in layer.named_parameters()}
    for impl in ("pallas", "auto"):
        torch.testing.assert_close(outs[impl], outs["scan"], rtol=0, atol=1e-6)
        for k, g in grads["scan"].items():
            torch.testing.assert_close(grads[impl][k], g, rtol=1e-4,
                                       atol=1e-5)
    with pytest.raises(ValueError, match="lstm_impl"):
        LSTMLayer(10, 8, impl="cudnn")
