"""Port vs reference: CTC (the scan backend, K2's plain α/β and K2b's plain
Hessian-vector product through their ``autograd.Function``s) and the joint
loss pieces.

The reference side is ``metaasr_tpu.ops.ctc.ctc_loss`` and
``ctc_loss_pallas(interpret=True)``; bars as ``tests/test_m3_pallas.py``:
loss rtol=atol=1e-5, gradient w.r.t. the logits rtol 1e-4, atol 1e-5. One
batch holds ragged T, an empty label, an infeasible row (T too short) and
repeated labels. Second order (``tests/test_m3_pallas.py:69-102``'s bar,
rtol 1e-3, atol 1e-5): the Hessian-vector product against the reference's
``jax.jvp(jax.grad(loss))`` and reverse-over-reverse, through the scan and
through the Pallas kernel in interpret mode, at that test's shape and on the
ragged batch.
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


# ---------------- second order: K2b's plain version ----------------

def _m3_inputs():
    """tests/test_m3_pallas.py::test_pallas_ctc_second_order_matches_scan's
    shape: every row feasible, full label lengths drawn at random."""
    bsz, t_len, u_len, vocab = 4, 16, 5, 8
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((bsz, t_len, vocab)).astype(np.float32)
    t_lens = rng.integers(u_len * 2 + 1, t_len + 1, bsz).astype(np.int32)
    labels = rng.integers(1, vocab, (bsz, u_len)).astype(np.int32)
    u_lens = rng.integers(1, u_len + 1, bsz).astype(np.int32)
    return logits, t_lens, labels, u_lens


HVP_INPUTS = {"m3": _m3_inputs, "ragged": _inputs}


def _direction(shape):
    return np.random.default_rng(7).standard_normal(shape).astype(np.float32)


_REF_HVP = {}


def _ref_hvp(which, fn_name, mode, of_logits):
    """The reference's Hessian-vector product along ``_direction``, w.r.t.
    the logits (through log_softmax) or w.r.t. the log-probs taken as free
    inputs; forward-over-reverse (``jvp``) or reverse-over-reverse."""
    key = (which, fn_name, mode, of_logits)
    if key not in _REF_HVP:
        logits, t_lens, labels, u_lens = HVP_INPUTS[which]()
        fn = (ref_ctc_loss if fn_name == "scan"
              else lambda *a: ctc_loss_pallas(*a, interpret=True))

        def loss(x):
            lp = jax.nn.log_softmax(x, -1) if of_logits else x
            return fn(lp, jnp.asarray(t_lens), jnp.asarray(labels),
                      jnp.asarray(u_lens)).sum()

        x = jnp.asarray(logits)
        if not of_logits:
            x = jax.nn.log_softmax(x, -1)
        v = jnp.asarray(_direction(logits.shape))
        if mode == "jvp":
            out = jax.jvp(jax.grad(loss), (x,), (v,))[1]
        else:
            out = jax.grad(lambda y: (jax.grad(loss)(y) * v).sum())(x)
        _REF_HVP[key] = np.asarray(out)
    return _REF_HVP[key]


@pytest.mark.parametrize("mode", ["jvp", "rev_over_rev"])
@pytest.mark.parametrize("ref", ["scan", "pallas"])
@pytest.mark.parametrize("which", list(HVP_INPUTS))
def test_plain_hvp_matches_reference(which, ref, mode):
    """``plain_ctc_hvp`` on the gathered emissions, scattered back through
    the gather (which is linear), against the reference's product w.r.t.
    the log-probs."""
    logits, t_lens, labels, u_lens = HVP_INPUTS[which]()
    lab = torch.from_numpy(labels)
    lp = torch.log_softmax(torch.from_numpy(logits), -1).requires_grad_(True)
    z = ctc.extend_labels(lab)
    logp_z = ctc.gather_emissions(lp, z)
    v_z = ctc.gather_emissions(torch.from_numpy(_direction(logits.shape)), z)
    hv, nll_dot = ctc_kernel.plain_ctc_hvp(
        logp_z.detach().contiguous(), ctc.skip_bias(z),
        torch.from_numpy(t_lens), 2 * torch.from_numpy(u_lens),
        v_z.contiguous())
    assert torch.isfinite(hv).all() and torch.isfinite(nll_dot).all()
    logp_z.backward(hv)
    want = _ref_hvp(which, ref, mode, of_logits=False)
    np.testing.assert_allclose(lp.grad.numpy(), want, rtol=1e-3, atol=1e-5)
    _, g = ctc_kernel.plain_ctc_alpha_beta(
        logp_z.detach().contiguous(), ctc.skip_bias(z),
        torch.from_numpy(t_lens), 2 * torch.from_numpy(u_lens))
    feasible = np.ones(len(t_lens), bool)
    if which == "ragged":
        feasible[3] = False
        assert np.all(hv[3].numpy() == 0.0) and float(nll_dot[3]) == 0.0
        assert np.all(hv[1, 20:].numpy() == 0.0)           # frames past T
    np.testing.assert_allclose(
        nll_dot.numpy()[feasible],
        (g * v_z).sum((1, 2)).numpy()[feasible], rtol=1e-4, atol=1e-5)


def _port_hvp(fn, which, create_graph=False):
    """autograd.grad(<grad(loss), v>) w.r.t. the logits."""
    logits, t_lens, labels, u_lens = HVP_INPUTS[which]()
    x = torch.tensor(logits, requires_grad=True)
    nll = fn(torch.log_softmax(x, -1), torch.from_numpy(t_lens),
             torch.from_numpy(labels), torch.from_numpy(u_lens))
    (g,) = torch.autograd.grad(nll.sum(), x, create_graph=True)
    inner = (g * torch.from_numpy(_direction(logits.shape))).sum()
    (hv,) = torch.autograd.grad(inner, x, create_graph=create_graph)
    return hv


@pytest.mark.parametrize("ref", ["scan", "pallas"])
@pytest.mark.parametrize("which", list(HVP_INPUTS))
def test_functions_hvp_matches_reference(which, ref):
    """The Functions' double backward (CTCAlphaBeta -> CTCPosterior -> K2b's
    plain version), chained through the gather and log_softmax by autograd,
    against the reference's reverse-over-reverse w.r.t. the logits."""
    got = _port_hvp(ctc_kernel.ctc_loss_kernel, which).numpy()
    want = _ref_hvp(which, ref, "rev_over_rev", of_logits=True)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    if which == "ragged":
        assert np.all(got[3] == 0.0)                       # zero_infinity


@pytest.mark.parametrize("which", list(HVP_INPUTS))
def test_functions_hvp_equals_autograd_of_the_scan(which):
    got = _port_hvp(ctc_kernel.ctc_loss_kernel, which).numpy()
    want = _port_hvp(ctc.ctc_loss, which).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    assert np.abs(want).max() > 1e-2                       # not trivially 0


def test_third_order_raises():
    """K2b is not differentiable again: a double backward that itself builds
    a graph raises instead of treating the Hessian as a constant."""
    with pytest.raises(RuntimeError, match="third-order"):
        _port_hvp(ctc_kernel.ctc_loss_kernel, "m3", create_graph=True)


def test_first_order_backward_reuses_the_saved_posterior(monkeypatch):
    """Without create_graph the backward multiplies K2's saved gradient and
    never reaches K2b; with it, K2 is not run again (the posterior is
    reused) and K2b runs once per double backward."""
    calls = {"k2": 0, "k2b": 0}
    plain_ab, plain_hvp = (ctc_kernel.plain_ctc_alpha_beta,
                           ctc_kernel.plain_ctc_hvp)

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(ctc_kernel, "plain_ctc_alpha_beta",
                        count("k2", plain_ab))
    monkeypatch.setattr(ctc_kernel, "plain_ctc_hvp", count("k2b", plain_hvp))
    logits, t_lens, labels, u_lens = _inputs()
    x = torch.tensor(logits, requires_grad=True)
    nll = ctc_kernel.ctc_loss_kernel(
        torch.log_softmax(x, -1), torch.from_numpy(t_lens),
        torch.from_numpy(labels), torch.from_numpy(u_lens))
    (g,) = torch.autograd.grad(nll.sum(), x, retain_graph=True)
    assert calls == {"k2": 1, "k2b": 0} and not g.requires_grad
    (g2,) = torch.autograd.grad(nll.sum(), x, create_graph=True)
    assert calls == {"k2": 1, "k2b": 0}
    torch.testing.assert_close(g2.detach(), g)
    torch.autograd.grad(g2.square().sum(), x)
    assert calls == {"k2": 1, "k2b": 1}
    assert ctc_kernel.ctc_hvp.launches == 0                # CPU: plain version


def test_hvp_checks_inputs():
    lp = torch.zeros((2, 4, 5))
    skip = torch.zeros((2, 5))
    lens = torch.full((2,), 4, dtype=torch.int32)
    end = torch.full((2,), 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="v must be"):
        ctc_kernel.ctc_hvp(lp, skip, lens, end, lp[:, :3])
    with pytest.raises(ValueError, match="v must be"):
        ctc_kernel.ctc_hvp(lp, skip, lens, end, lp.double())
    with pytest.raises(ValueError, match="float32"):
        ctc_kernel.ctc_hvp(lp.double(), skip, lens, end, lp)
    hv, nll_dot = ctc_kernel.ctc_hvp(lp, skip, lens, end, torch.ones_like(lp))
    assert hv.shape == (2, 4, 5) and nll_dot.shape == (2,)


def test_hvp_is_symmetric_and_annihilates_constants():
    """H is symmetric (<u, Hv> = <v, Hu>), which is why one product serves
    forward-over-reverse and reverse-over-reverse."""
    logits, t_lens, labels, u_lens = _m3_inputs()
    lab = torch.from_numpy(labels)
    z = ctc.extend_labels(lab)
    logp_z = ctc.gather_emissions(
        torch.log_softmax(torch.from_numpy(logits), -1), z).contiguous()
    args = (logp_z, ctc.skip_bias(z), torch.from_numpy(t_lens),
            2 * torch.from_numpy(u_lens))
    rng = np.random.default_rng(11)
    u, v = (torch.from_numpy(rng.standard_normal(
        tuple(logp_z.shape)).astype(np.float32)) for _ in range(2))
    hu, _ = ctc_kernel.plain_ctc_hvp(*args, u)
    hv, _ = ctc_kernel.plain_ctc_hvp(*args, v)
    np.testing.assert_allclose(float((u * hv).sum()), float((v * hu).sum()),
                               rtol=1e-4)


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


# ---------------- the kernels' launch plan ----------------

H100_SMEM = 232448  # opt-in shared memory per block of an H100 (227 KB)


@pytest.mark.parametrize("t_len,s_len,k2,k2b", [
    # chip_smoke.py's CTC_SHAPES, [T, S = 2U+1]: fused and per_task
    (99, 65, ("resident", 3, 1, 77220, 0), ("resident", 3, 1, 154440, 0)),
    (50, 15, ("resident", 1, 1, 9000, 0), ("resident", 1, 1, 18000, 0)),
    (1000, 41, ("streamed", 2, 1, 2624, 1), ("streamed", 2, 1, 5248, 3)),
    # wide_s: K2's histories fit, K2b's do not; max_s: four warps a pass
    (99, 121, ("resident", 4, 1, 143748, 0), ("streamed", 4, 1, 15488, 3)),
    (1100, 1023, ("streamed", 8, 4, 65472, 1), ("streamed", 8, 4, 130944, 3)),
])
def test_plan_at_the_checked_shapes(t_len, s_len, k2, k2b):
    """Layout, states per thread, warps per recursion, shared memory and
    scratch arrays for K2 and K2b at chip_smoke.py's CTC_SHAPES on an H100;
    every launch fits the opt-in shared memory with the static part."""
    for tangent, want in ((False, k2), (True, k2b)):
        got = ctc_kernel.plan(t_len, s_len, H100_SMEM, tangent)
        assert (got["layout"], got["k"], got["warps"], got["smem_bytes"],
                got["scratch"]) == want
        assert got["smem_bytes"] + ctc_kernel.STATIC_SMEM <= H100_SMEM


def test_plan_reckons_resident_bytes_against_the_limit():
    """Resident: logp_z (and v) plus alpha and beta (and their tangents) as
    [T, S] f32; one byte short of the limit streams instead."""
    t_len, s_len = 99, 65
    for tangent, arrays in ((False, 1), (True, 2)):
        need = 4 * arrays * 3 * t_len * s_len + ctc_kernel.STATIC_SMEM
        assert ctc_kernel.plan(t_len, s_len, need, tangent)["layout"] == \
            "resident"
        short = ctc_kernel.plan(t_len, s_len, need - 1, tangent)
        assert short["layout"] == "streamed"
        assert short["smem_bytes"] == 4 * arrays * 2 * ctc_kernel.RING * s_len
    with pytest.raises(ValueError, match="shared memory"):
        ctc_kernel.plan(t_len, s_len, 1024, tangent=True)


def test_plan_covers_every_lane_count():
    """For every S the kernel takes: 32 * warps * k states cover S, k <=
    MAX_K, at most four warps a recursion, and several warps only with k >=
    5 (what csrc/ctc.cu's launcher accepts); S > MAX_S raises."""
    for s_len in range(1, ctc_kernel.MAX_S + 1):
        got = ctc_kernel.plan(10, s_len, H100_SMEM)
        k, w = got["k"], got["warps"]
        assert 32 * w * k >= s_len and 1 <= k <= ctc_kernel.MAX_K
        assert 1 <= w <= 4 and (w == 1 or k >= 5)
        assert 32 * w * (k - 1) < s_len              # no state-free round
    with pytest.raises(ValueError, match="exceeds"):
        ctc_kernel.plan(10, ctc_kernel.MAX_S + 1, H100_SMEM)


def test_wrappers_raise_above_the_lane_limit(monkeypatch):
    """A launch with S > 1024 raises before any library call, as it did."""
    class Lib:
        @staticmethod
        def metaasr_ctc_max_lanes():
            return 1024

    monkeypatch.setattr(ctc_kernel, "_check", lambda *a: True)
    monkeypatch.setattr(ctc_kernel, "_library", lambda: Lib)
    s_len = 1025
    lp = torch.zeros((1, 3, s_len))
    skip = torch.zeros((1, s_len))
    lens = torch.full((1,), 3, dtype=torch.int32)
    end = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds"):
        ctc_kernel.ctc_alpha_beta(lp, skip, lens, end)
    with pytest.raises(ValueError, match="exceeds"):
        ctc_kernel.ctc_hvp(lp, skip, lens, end, lp)
    with pytest.raises(ValueError, match="exceeds"):
        ctc_kernel.launch_plan(lp)


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
