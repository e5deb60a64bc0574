"""Port vs reference: CTC (the scan backend and K2's plain α/β through its
``autograd.Function``) and the joint loss pieces.

The reference side is ``metaasr_tpu.ops.ctc.ctc_loss`` and
``ctc_loss_pallas(interpret=True)``; bars as ``tests/test_m3_pallas.py``:
loss rtol=atol=1e-5, gradient w.r.t. the logits rtol 1e-4, atol 1e-5. One
batch holds ragged T, an empty label, an infeasible row (T too short) and
repeated labels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.models import losses as ref_losses
from metaasr_tpu.ops.ctc import ctc_loss as ref_ctc_loss
from metaasr_tpu.ops.ctc_pallas import ctc_loss_pallas
from metaasr_tpu_torch.models import losses
from metaasr_tpu_torch.ops import ctc, ctc_kernel

B, T, U, V = 6, 24, 6, 9


def _inputs():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    t_lens = np.array([24, 20, 13, 5, 24, 17], np.int32)
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    labels[4, :4] = [3, 3, 3, 5]                  # repeated labels
    labels[5, :3] = [2, 2, 2]
    u_lens = np.array([6, 4, 0, 6, 4, 3], np.int32)  # row 2: empty label
    # row 3: T=5 frames for 6 labels -> infeasible
    return logits, t_lens, labels, u_lens


def _ref(fn):
    logits, t_lens, labels, u_lens = _inputs()

    def total(x):
        return fn(jax.nn.log_softmax(x, -1), jnp.asarray(t_lens),
                  jnp.asarray(labels), jnp.asarray(u_lens))

    x = jnp.asarray(logits)
    return np.asarray(total(x)), np.asarray(
        jax.grad(lambda x: total(x).sum())(x))


@pytest.fixture(scope="module")
def references():
    return {"scan": _ref(ref_ctc_loss),
            "pallas": _ref(lambda *a: ctc_loss_pallas(*a, interpret=True))}


def _port(fn):
    logits, t_lens, labels, u_lens = _inputs()
    x = torch.tensor(logits, requires_grad=True)
    nll = fn(torch.log_softmax(x, -1), torch.from_numpy(t_lens),
             torch.from_numpy(labels), torch.from_numpy(u_lens))
    nll.sum().backward()
    return nll.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("ref", ["scan", "pallas"])
@pytest.mark.parametrize("backend", ["scan", "kernel_plain"])
def test_ctc_matches_reference(references, backend, ref):
    fn = ctc.ctc_loss if backend == "scan" else ctc_kernel.ctc_loss_kernel
    nll, grad = _port(fn)
    want_nll, want_grad = references[ref]
    np.testing.assert_allclose(nll, want_nll, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-4, atol=1e-5)
    assert nll[3] == 0.0 and np.all(grad[3] == 0.0)   # zero_infinity
    assert np.all(grad[1, 20:] == 0.0)                 # frames past T


def test_plain_alpha_beta_posterior_is_the_scan_gradient():
    """K2's posterior -exp(α+β+nll), scattered back through the gather,
    equals autograd through the scan recursion; its nll equals the scan's."""
    logits, t_lens, labels, u_lens = _inputs()
    keep = [0, 1, 2, 4, 5]                             # feasible rows
    lens = torch.from_numpy(t_lens[keep])
    lab = torch.from_numpy(labels[keep])
    ulen = torch.from_numpy(u_lens[keep])
    x = torch.from_numpy(logits[keep]).requires_grad_(True)
    scan_nll = ctc.ctc_forward(torch.log_softmax(x, -1), lens, lab, ulen)
    scan_nll.sum().backward()
    y = torch.from_numpy(logits[keep]).requires_grad_(True)
    z = ctc.extend_labels(lab)
    logp_z = ctc.gather_emissions(torch.log_softmax(y, -1), z)
    nll, g = ctc_kernel.plain_ctc_alpha_beta(
        logp_z.detach().contiguous(), ctc.skip_bias(z), lens, 2 * ulen)
    np.testing.assert_allclose(nll.numpy(), scan_nll.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    logp_z.backward(g)
    np.testing.assert_allclose(y.grad.numpy(), x.grad.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_double_backward_raises():
    """Second order through the Function raises instead of dropping the CTC
    Hessian term."""
    logits, t_lens, labels, u_lens = _inputs()
    x = torch.tensor(logits[:2], requires_grad=True)
    nll = ctc_kernel.ctc_loss_kernel(
        torch.log_softmax(x, -1), torch.from_numpy(t_lens[:2]),
        torch.from_numpy(labels[:2]), torch.from_numpy(u_lens[:2]))
    with pytest.raises(RuntimeError, match="first order only"):
        torch.autograd.grad(nll.sum(), x, create_graph=True)
    (g,) = torch.autograd.grad(nll.sum(), x)          # first order works
    assert torch.isfinite(g).all()


def test_alpha_beta_checks_inputs():
    lp = torch.zeros((2, 4, 5))
    skip = torch.zeros((2, 5))
    lens = torch.full((2,), 4, dtype=torch.int32)
    end = torch.full((2,), 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        ctc_kernel.ctc_alpha_beta(lp.double(), skip, lens, end)
    with pytest.raises(ValueError, match="skip"):
        ctc_kernel.ctc_alpha_beta(lp, skip[:, :4], lens, end)
    with pytest.raises(ValueError, match="lens"):
        ctc_kernel.ctc_alpha_beta(lp, skip, lens[:1], end)
    with pytest.raises(ValueError, match="frame"):
        ctc_kernel.ctc_alpha_beta(lp[:, :0], skip, lens, end)
    before = ctc_kernel.ctc_alpha_beta.launches
    nll, g = ctc_kernel.ctc_alpha_beta(lp, skip, lens, end)
    assert nll.shape == (2,) and g.shape == (2, 4, 5)
    assert ctc_kernel.ctc_alpha_beta.launches == before  # CPU: plain version


# ---------------- the joint loss pieces ----------------

def _targets():
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, V - 1, (3, 5)).astype(np.int32)
    lens = np.array([5, 2, 0], np.int32)
    tokens *= np.arange(5)[None, :] < lens[:, None]
    return tokens, lens


def test_prepare_decoder_targets_matches():
    tokens, lens = _targets()
    want = ref_losses.prepare_decoder_targets(jnp.asarray(tokens),
                                              jnp.asarray(lens), V - 1)
    got = losses.prepare_decoder_targets(torch.from_numpy(tokens),
                                         torch.from_numpy(lens), V - 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("normalize", ["tokens", "batch"])
def test_label_smoothing_loss_matches(normalize):
    tokens, lens = _targets()
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 6, V)).astype(np.float32)
    _, t_out, mask = ref_losses.prepare_decoder_targets(
        jnp.asarray(tokens), jnp.asarray(lens), V - 1)
    want = ref_losses.label_smoothing_loss(jnp.asarray(logits), t_out, mask,
                                           0.1, normalize)
    got = losses.label_smoothing_loss(
        torch.from_numpy(logits), torch.tensor(np.asarray(t_out)),
        torch.tensor(np.asarray(mask)), 0.1, normalize)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


def test_joint_loss_matches():
    tokens, lens = _targets()
    rng = np.random.default_rng(3)
    out_np = {"ctc_logits": rng.standard_normal((3, 16, V)).astype(np.float32),
              "att_logits": rng.standard_normal((3, 6, V)).astype(np.float32),
              "enc_lens": np.array([16, 12, 9], np.int32)}
    want_loss, want_m = ref_losses.joint_ctc_attention_loss(
        {k: jnp.asarray(v) for k, v in out_np.items()}, jnp.asarray(tokens),
        jnp.asarray(lens), V - 1)
    for fn in (ctc.ctc_loss, ctc_kernel.ctc_loss_kernel):
        loss, m = losses.joint_ctc_attention_loss(
            {k: torch.from_numpy(v) for k, v in out_np.items()},
            torch.from_numpy(tokens), torch.from_numpy(lens), V - 1,
            ctc_loss_fn=fn)
        for k in ("loss", "ctc_loss", "att_loss"):
            np.testing.assert_allclose(float(m[k]), float(want_m[k]),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
