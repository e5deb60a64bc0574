"""Port vs reference: full second-order MAML.

``metaasr_tpu_torch.meta.maml.maml_grads(first_order=False)`` against
``metaasr_tpu.meta.maml.maml_grads(first_order=False)``:

- on a linear CTC model (the composition of ``tests/test_m3_pallas.py``'s
  ``test_maml_meta_grads_pallas_vs_scan_ctc``: two inner steps, two tasks),
  with the port's CTC through K2's Functions (K2b's plain version on the
  CPU) and through its scan: meta-loss rtol 1e-5, gradients rtol 1e-3 /
  atol 1e-5;
- on the tiny transformer (d=32, 2 heads, 2+2 layers) over the ASR task,
  from the same Flax weights through ``weights.py``, dropout 0, SpecAugment
  off: worst gradient leaf l2rel <= 1e-3 in fp32, 1e-2 with the bf16
  meta-step (``tests/test_torch_meta.py``'s bars), with Meta-SGD,
  ``inner_clip`` and ``adapt_filter`` as cases;
- on a small VGG-BLSTM (``require_full_autodiff``: the autograd LSTM loop).

Measured on the CPU, worst leaf: fp32 cases 2.0e-5 .. 1.6e-4, the bf16
meta-step 4.4e-3, the VGG-BLSTM 6.4e-6; the port's own K2/K2b path against
its scan 4.8e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.meta import maml as ref_maml
from metaasr_tpu.ops.ctc import ctc_loss as ref_ctc_loss
from metaasr_tpu.ops.ctc_pallas import ctc_loss_pallas
from metaasr_tpu.train.task import ASRTask as RefTask
from metaasr_tpu_torch.meta import maml
from metaasr_tpu_torch.ops import ctc, ctc_kernel
from metaasr_tpu_torch.task import ASRTask
from metaasr_tpu_torch.weights import flatten_tree, flax_to_params, params_to_flax
from tests.test_m2_models import tiny_cfg
from tests.test_torch_meta import (
    GRAD_L2REL,
    LOSS_RTOL,
    VOCAB,
    _l2rel,
    _meta_batch,
    _to_torch,
    port_cfg,
)

# ---------------- the linear CTC model ----------------

LIN = dict(bsz=2, t_len=10, feat=6, vocab=7, u_len=3)


def _linear_problem():
    rng = np.random.default_rng(0)
    d = LIN
    params = {"w": (0.3 * rng.standard_normal((d["feat"], d["vocab"]))
                    ).astype(np.float32),
              "b": np.zeros((d["vocab"],), np.float32)}

    def batch(m):
        t_lens = np.full((m, d["bsz"]), d["t_len"], np.int32)
        t_lens[0, 1] = d["t_len"] - 2                       # ragged T
        return {"feats": rng.standard_normal(
                    (m, d["bsz"], d["t_len"], d["feat"])).astype(np.float32),
                "feat_lens": t_lens,
                "tokens": rng.integers(1, d["vocab"], (m, d["bsz"], d["u_len"])
                                       ).astype(np.int32),
                "token_lens": np.full((m, d["bsz"]), d["u_len"], np.int32)}

    return params, {"support": batch(2), "query": batch(2)}


@pytest.fixture(scope="module")
def linear_reference():
    params, mb = _linear_problem()
    out = {}
    for name, ctc_fn in (("scan", ref_ctc_loss),
                         ("pallas", lambda *a: ctc_loss_pallas(
                             *a, interpret=True))):
        def loss_fn(p, batch, rng_, train, ctc_fn=ctc_fn):
            logits = batch["feats"] @ p["w"] + p["b"]
            lp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
            return ctc_fn(lp, batch["feat_lens"], batch["tokens"],
                          batch["token_lens"]).mean(), {}

        cfg = ref_maml.MetaAlgoConfig(inner_lr=0.05, inner_steps=2,
                                      first_order=False, remat_inner=True)
        g, m = ref_maml.maml_grads(loss_fn, cfg)(
            jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, mb),
            jax.random.PRNGKey(0))
        out[name] = (jax.tree.map(np.asarray, g), float(m["meta_loss"]))
    return out


@pytest.mark.parametrize("ref", ["scan", "pallas"])
@pytest.mark.parametrize("backend", ["scan", "kernel_plain"])
def test_linear_ctc_maml_matches_reference(linear_reference, backend, ref):
    params, mb = _linear_problem()
    ctc_fn = ctc.ctc_loss if backend == "scan" else ctc_kernel.ctc_loss_kernel

    def loss_fn(p, batch, generator, train):
        logits = batch["feats"] @ p["w"] + p["b"]
        lp = torch.log_softmax(logits.float(), -1)
        return ctc_fn(lp, batch["feat_lens"], batch["tokens"],
                      batch["token_lens"]).mean(), {}

    cfg = maml.MetaAlgoConfig(inner_lr=0.05, inner_steps=2, first_order=False)
    got, got_m = maml.maml_grads(loss_fn, cfg)(
        _to_torch(params), _to_torch(mb), 0)
    want, want_loss = linear_reference[ref]
    np.testing.assert_allclose(float(got_m["meta_loss"]), want_loss,
                               rtol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3,
                                   atol=1e-5)


def test_linear_ctc_maml_differs_from_fomaml():
    """The second-order term is not small here: were the CTC Hessian
    dropped, the test above could not tell."""
    params, mb = _linear_problem()

    def loss_fn(p, batch, generator, train):
        lp = torch.log_softmax(batch["feats"] @ p["w"] + p["b"], -1)
        return ctc_kernel.ctc_loss_kernel(
            lp, batch["feat_lens"], batch["tokens"],
            batch["token_lens"]).mean(), {}

    grads = {}
    for first_order in (True, False):
        cfg = maml.MetaAlgoConfig(inner_lr=0.05, inner_steps=2,
                                  first_order=first_order)
        grads[first_order], _ = maml.maml_grads(loss_fn, cfg)(
            _to_torch(params), _to_torch(mb), 0)
    gap = _l2rel(grads[False]["w"].numpy(), grads[True]["w"].numpy())
    assert gap > 1e-2, gap


# ---------------- the whole path: the tiny transformer ----------------

@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg("transformer", vocab=VOCAB)
    ref_task = RefTask(cfg, VOCAB - 1)
    mb = _meta_batch()
    sample = {k: jnp.asarray(v[0]) for k, v in mb["support"].items()}
    params = jax.tree.map(np.asarray, ref_task.init_params(
        jax.random.PRNGKey(0), sample))
    task = ASRTask(port_cfg(cfg), VOCAB - 1, device="cpu")
    return ref_task, task, params, mb


CASES = {
    "plain": {},
    "learn_inner_lr": {"_meta_sgd": True},
    "inner_clip": {"inner_clip": 0.5},
    "adapt_filter": {"adapt_filter": ("decoder", "ctc_head")},
    "grad_dtype_bf16": {"grad_dtype": "bfloat16"},
}


@pytest.mark.parametrize("case", list(CASES))
def test_maml_grads_match_reference(setup, case):
    ref_task, task, params, mb = setup
    kw = dict(CASES[case])
    meta_sgd = kw.pop("_meta_sgd", False)
    common = dict(inner_lr=0.05, inner_steps=2, first_order=False, **kw)
    cfg = maml.MetaAlgoConfig(**common)
    ref_params = ref_maml.wrap_lr(params, 0.05) if meta_sgd else params
    ref_fn = jax.jit(ref_maml.maml_grads(
        ref_task.loss_fn,
        ref_maml.MetaAlgoConfig(learn_inner_lr=meta_sgd, **common),
        ref_task.preprocess))
    want, want_m = ref_fn(ref_params, jax.tree.map(jnp.asarray, mb),
                          jax.random.PRNGKey(0))
    port_params = flax_to_params(jax.tree.map(np.asarray, ref_params))
    got, got_m = maml.maml_grads(task.loss_fn, cfg, task.preprocess)(
        port_params, _to_torch(mb), 0)
    dt = cfg.grad_dtype or "float32"
    for key in ("meta_loss", "query_loss_max", "support_loss_mean"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]),
                                   rtol=LOSS_RTOL[dt])
    want_flat = flatten_tree(jax.tree.map(np.asarray, want))
    got_flat = flatten_tree(params_to_flax(got, num_heads=2))
    assert got_flat.keys() == want_flat.keys()
    worst = max(_l2rel(got_flat[k], want_flat[k]) for k in want_flat)
    assert worst <= GRAD_L2REL[dt], (case, worst)


def test_maml_through_kernel_functions_equals_scan(setup):
    """The port alone: second-order gradients with the CTC term through
    K2's Functions (``ctc_impl: auto``) equal those through the autograd
    scan (``ctc_impl: scan``)."""
    _, task, params, mb = setup
    cfg = maml.MetaAlgoConfig(inner_lr=0.05, inner_steps=2, first_order=False)
    scan_cfg = port_cfg(tiny_cfg("transformer", vocab=VOCAB))
    scan_cfg.model.ctc_impl = "scan"
    scan_task = ASRTask(scan_cfg, VOCAB - 1, device="cpu")
    port_params = flax_to_params(params)
    got, _ = maml.maml_grads(task.loss_fn, cfg, task.preprocess)(
        port_params, _to_torch(mb), 0)
    want, _ = maml.maml_grads(scan_task.loss_fn, cfg, scan_task.preprocess)(
        port_params, _to_torch(mb), 0)
    worst = max(_l2rel(got[k].numpy(), want[k].numpy()) for k in want)
    assert worst <= 1e-4, worst


# ---------------- a small VGG-BLSTM (require_full_autodiff) -------------

def test_vgg_blstm_maml_step_matches_reference():
    cfg = tiny_cfg("vgg_blstm", vocab=VOCAB)
    cfg.meta.algo = "maml"
    task = ASRTask(port_cfg(cfg), VOCAB - 1, device="cpu")
    ref_task = RefTask(cfg, VOCAB - 1)
    ref_task.require_full_autodiff()
    mb = _meta_batch(seed=1)
    sample = {k: jnp.asarray(v[0]) for k, v in mb["support"].items()}
    params = jax.tree.map(np.asarray, ref_task.init_params(
        jax.random.PRNGKey(0), sample))
    common = dict(inner_lr=0.05, inner_steps=2, first_order=False)
    want, want_m = jax.jit(ref_maml.maml_grads(
        ref_task.loss_fn, ref_maml.MetaAlgoConfig(**common),
        ref_task.preprocess))(params, jax.tree.map(jnp.asarray, mb),
                              jax.random.PRNGKey(0))
    assert task.cfg.model.lstm_impl != "scan"
    task.require_full_autodiff()
    assert task.cfg.model.lstm_impl == "scan"
    got, got_m = maml.maml_grads(
        task.loss_fn, maml.MetaAlgoConfig(**common), task.preprocess)(
        flax_to_params(params), _to_torch(mb), 0)
    np.testing.assert_allclose(float(got_m["meta_loss"]),
                               float(want_m["meta_loss"]), rtol=1e-4)
    want_flat = flatten_tree(jax.tree.map(np.asarray, want))
    got_flat = flatten_tree(params_to_flax(got, num_heads=1))
    assert got_flat.keys() == want_flat.keys()
    worst = max(_l2rel(got_flat[k], want_flat[k]) for k in want_flat)
    assert worst <= 1e-3, worst
