"""Port vs reference: ``meta.remat_inner``, each second-order inner step
recomputed once in the outer backward.

The port's ``make_inner_adapt`` / ``maml_grads`` with ``remat_inner`` True
and False against the closed forms and the reference's ``remat_inner=True``
runs (``metaasr_tpu.meta.maml``, which wraps the step in
``jax.checkpoint``):

- the analytic quadratic family of ``tests/test_m5_meta.py:31-70`` and
  Meta-SGD's of ``tests/test_metasgd.py:84``, rtol 1e-5;
- the linear CTC model of ``tests/test_torch_maml.py`` through the port's
  scan and K2's Functions (K2b's plain version on the CPU), against the
  reference's scan and Pallas (interpret mode), at that file's bars;
- the tiny transformer (d=32, 2 heads, 2+2 layers) at dropout 0 against the
  reference (``tests/test_torch_maml.py``'s bars), and port against port
  at dropout 0.1 with ``train=True``: RNG streams cannot match JAX, but a
  recompute that reused the step's generator object instead of its seed
  would draw other dropout masks there;
- Meta-SGD, ``adapt_filter`` (the frozen leaves' second-order terms),
  ``inner_clip`` and the bf16 meta-step, remat against no remat;
- the loss is called M * (2 * inner + 1) times a second-order step with
  remat, M * (inner + 1) without and under FOMAML;
- the tensors the graph still holds after ``inner_adapt`` (saved-tensor
  hooks) take fewer bytes with remat;
- ``algo_config``, ``meta_adapt``, the bench's ``BENCH_NO_REMAT`` and the
  CLI's config4 run carry the flag as the reference's do.

Measured on the CPU: remat and no remat give bit-equal gradients in every
port-against-port case here, dropout 0.1 included.
"""

import os
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.meta import maml as ref_maml
from metaasr_tpu.train.task import ASRTask as RefTask
from metaasr_tpu_torch import cli
from metaasr_tpu_torch.config import load_config
from metaasr_tpu_torch.data import synthetic
from metaasr_tpu_torch.meta import maml
from metaasr_tpu_torch.ops import ctc, ctc_kernel
from metaasr_tpu_torch.scripts import bench
from metaasr_tpu_torch.task import ASRTask
from metaasr_tpu_torch.train import meta_train
from metaasr_tpu_torch.utils.tree import flatten
from metaasr_tpu_torch.weights import flatten_tree, flax_to_params, params_to_flax
from tests.test_m2_models import tiny_cfg
from tests.test_torch_maml import _linear_problem, linear_reference  # noqa: F401
from tests.test_torch_meta import (
    GRAD_L2REL,
    LOSS_RTOL,
    VOCAB,
    _l2rel,
    _meta_batch,
    _to_torch,
    port_cfg,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CONFIG4 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "config4_maml.yaml")
REMAT = [pytest.param(True, id="remat"), pytest.param(False, id="no_remat")]

# ---------------- the quadratic family ----------------

LR, K = 0.1, 3


def quad_loss(params, batch, generator, train):
    """0.5 ||w - c||^2 (``tests/test_m5_meta.py``'s ``quad_loss``)."""
    del generator, train
    diff = params["w"] - batch["c"]
    return 0.5 * torch.sum(diff * diff), {}


def ref_quad_loss(params, batch, rng, train):
    del rng, train
    diff = params["w"] - batch["c"]
    return 0.5 * jnp.sum(diff * diff), {}


def _quad(seed=0):
    """(w, c_s, c_q, w_k) as numpy fp32, ``tests/test_m5_meta.py::_setup``."""
    rng = np.random.default_rng(seed)
    w, c_s, c_q = (rng.standard_normal(5).astype(np.float32)
                   for _ in range(3))
    return w, c_s, c_q, c_s + (1 - LR) ** K * (w - c_s)


def _quad_batch(c_s, c_q):
    return {"support": {"c": c_s[None]}, "query": {"c": c_q[None]}}


@pytest.mark.parametrize("first_order", [True, False])
@pytest.mark.parametrize("remat", REMAT)
def test_quadratic_inner_adapt_closed_form(remat, first_order):
    w, c_s, _, w_k = _quad()
    cfg = maml.MetaAlgoConfig(inner_lr=LR, inner_steps=K,
                              first_order=first_order, remat_inner=remat)
    adapted, losses = maml.make_inner_adapt(quad_loss, cfg)(
        {"w": torch.from_numpy(w)}, {"c": torch.from_numpy(c_s)}, 0)
    np.testing.assert_allclose(adapted["w"].detach().numpy(), w_k, rtol=1e-5)
    np.testing.assert_allclose(float(losses[0]),
                               0.5 * float(np.sum((w - c_s) ** 2)), rtol=1e-5)
    ref_cfg = ref_maml.MetaAlgoConfig(inner_lr=LR, inner_steps=K,
                                      first_order=first_order,
                                      remat_inner=True)
    ref_inner = ref_maml.make_inner_adapt(ref_quad_loss, ref_cfg)
    ref_adapted, ref_losses = ref_inner(
        {"w": jnp.asarray(w)}, {"c": jnp.asarray(c_s)}, jax.random.PRNGKey(0))
    np.testing.assert_allclose(adapted["w"].detach().numpy(),
                               np.asarray(ref_adapted["w"]), rtol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses),
                               rtol=1e-5)


@pytest.mark.parametrize("remat", REMAT)
def test_quadratic_maml_gradient_closed_form(remat):
    """(1 - lr)^k (w_k - c_q): the inner Jacobian, through the recompute."""
    w, c_s, c_q, w_k = _quad()
    cfg = maml.MetaAlgoConfig(inner_lr=LR, inner_steps=K, first_order=False,
                              remat_inner=remat)
    grads, metrics = maml.maml_grads(quad_loss, cfg)(
        {"w": torch.from_numpy(w)}, _to_torch(_quad_batch(c_s, c_q)), 0)
    np.testing.assert_allclose(grads["w"].numpy(),
                               (1 - LR) ** K * (w_k - c_q), rtol=1e-5)
    ref_g, ref_m = ref_maml.maml_grads(ref_quad_loss, ref_maml.MetaAlgoConfig(
        inner_lr=LR, inner_steps=K, first_order=False, remat_inner=True))(
        {"w": jnp.asarray(w)},
        jax.tree.map(jnp.asarray, _quad_batch(c_s, c_q)),
        jax.random.PRNGKey(0))
    np.testing.assert_allclose(grads["w"].numpy(), np.asarray(ref_g["w"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["meta_loss"]),
                               float(ref_m["meta_loss"]), rtol=1e-5)


@pytest.mark.parametrize("remat", REMAT)
def test_quadratic_meta_sgd_closed_form(remat):
    """Meta-SGD at second order (``tests/test_metasgd.py:84``): the model's
    gradient (1 - a)^k (w_k - c_q) and the rate's
    -k (1 - a)^(k-1) (w - c_s) . (w_k - c_q), with the rate an input of
    every recomputed step."""
    w, c_s, c_q, w_k = _quad()
    cfg = maml.MetaAlgoConfig(inner_lr=0.999, inner_steps=K,
                              first_order=False, remat_inner=remat)
    params = maml.wrap_lr({"w": torch.from_numpy(w)}, LR)
    grads, _ = maml.maml_grads(quad_loss, cfg)(
        params, _to_torch(_quad_batch(c_s, c_q)), 0)
    np.testing.assert_allclose(grads["model"]["w"].numpy(),
                               (1 - LR) ** K * (w_k - c_q), rtol=1e-5)
    want_da = -K * (1 - LR) ** (K - 1) * float(np.dot(w - c_s, w_k - c_q))
    np.testing.assert_allclose(float(grads["inner_lr"]["w"]), want_da,
                               rtol=1e-5)
    ref_g, _ = ref_maml.maml_grads(ref_quad_loss, ref_maml.MetaAlgoConfig(
        inner_lr=0.999, inner_steps=K, first_order=False, remat_inner=True,
        learn_inner_lr=True))(
        {"model": {"w": jnp.asarray(w)}, "inner_lr": {"w": jnp.asarray(LR)}},
        jax.tree.map(jnp.asarray, _quad_batch(c_s, c_q)),
        jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(grads["inner_lr"]["w"]),
                               float(ref_g["inner_lr"]["w"]), rtol=1e-5)


@pytest.mark.parametrize("first_order, remat, calls_per_task", [
    (False, True, 2 * K + 1),     # one recompute per inner step
    (False, False, K + 1),
    (True, True, K + 1),          # first order never recomputes
    (True, False, K + 1),
])
def test_one_recompute_per_inner_step(first_order, remat, calls_per_task):
    calls = []

    def counting(*args):
        calls.append(1)
        return quad_loss(*args)

    w, c_s, c_q, _ = _quad()
    mb = _to_torch({"support": {"c": np.stack([c_s, c_q])},
                    "query": {"c": np.stack([c_q, c_s])}})
    cfg = maml.MetaAlgoConfig(inner_lr=LR, inner_steps=K,
                              first_order=first_order, remat_inner=remat)
    maml.maml_grads(counting, cfg)({"w": torch.from_numpy(w)}, mb, 0)
    assert len(calls) == 2 * calls_per_task


# ---------------- linear CTC ----------------

@pytest.mark.parametrize("ref", ["scan", "pallas"])
@pytest.mark.parametrize("backend", ["scan", "kernel_plain"])
@pytest.mark.parametrize("remat", REMAT)
def test_linear_ctc_matches_reference_remat(linear_reference, backend, ref,
                                            remat):
    """The reference's remat runs (``tests/test_torch_maml.py``'s fixture)
    against the port with and without the recompute: meta-loss rtol 1e-5,
    gradients rtol 1e-3 / atol 1e-5."""
    params, mb = _linear_problem()
    ctc_fn = ctc.ctc_loss if backend == "scan" else ctc_kernel.ctc_loss_kernel

    def loss_fn(p, batch, generator, train):
        lp = torch.log_softmax((batch["feats"] @ p["w"] + p["b"]).float(), -1)
        return ctc_fn(lp, batch["feat_lens"], batch["tokens"],
                      batch["token_lens"]).mean(), {}

    cfg = maml.MetaAlgoConfig(inner_lr=0.05, inner_steps=2, first_order=False,
                              remat_inner=remat)
    got, got_m = maml.maml_grads(loss_fn, cfg)(_to_torch(params),
                                               _to_torch(mb), 0)
    want, want_loss = linear_reference[ref]
    np.testing.assert_allclose(float(got_m["meta_loss"]), want_loss,
                               rtol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3,
                                   atol=1e-5)


# ---------------- the tiny transformer ----------------

def _task(dropout=0.0):
    cfg = port_cfg(tiny_cfg("transformer", vocab=VOCAB))
    cfg.model.dropout = dropout
    return ASRTask(cfg, VOCAB - 1, device="cpu")


@pytest.fixture(scope="module")
def reference_grads():
    """The reference's second-order remat step on the tiny transformer,
    dropout 0, and the Flax weights it started from."""
    cfg = tiny_cfg("transformer", vocab=VOCAB)
    ref_task = RefTask(cfg, VOCAB - 1)
    mb = _meta_batch()
    sample = {k: jnp.asarray(v[0]) for k, v in mb["support"].items()}
    params = jax.tree.map(np.asarray, ref_task.init_params(
        jax.random.PRNGKey(0), sample))
    grads, metrics = jax.jit(ref_maml.maml_grads(
        ref_task.loss_fn, ref_maml.MetaAlgoConfig(
            inner_lr=0.05, inner_steps=2, first_order=False,
            remat_inner=True), ref_task.preprocess))(
        params, jax.tree.map(jnp.asarray, mb), jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, grads), metrics


@pytest.mark.parametrize("remat", REMAT)
def test_asr_maml_matches_reference_remat(reference_grads, remat):
    params, want, want_m = reference_grads
    task = _task()
    cfg = maml.MetaAlgoConfig(inner_lr=0.05, inner_steps=2, first_order=False,
                              remat_inner=remat)
    got, got_m = maml.maml_grads(task.loss_fn, cfg, task.preprocess)(
        flax_to_params(params), _to_torch(_meta_batch()), 0)
    for key in ("meta_loss", "query_loss_max", "support_loss_mean"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]),
                                   rtol=LOSS_RTOL["float32"])
    want_flat = flatten_tree(want)
    got_flat = flatten_tree(params_to_flax(got, num_heads=2))
    assert got_flat.keys() == want_flat.keys()
    worst = max(_l2rel(got_flat[k], want_flat[k]) for k in want_flat)
    assert worst <= GRAD_L2REL["float32"], worst


def _port_grads(task, params, remat, inner_scale=None, widen_scale=None,
                **kw):
    cfg = maml.MetaAlgoConfig(inner_lr=0.05, inner_steps=2, first_order=False,
                              remat_inner=remat, **kw)
    return maml.maml_grads(task.loss_fn, cfg, task.preprocess)(
        params, _to_torch(_meta_batch()), 7, inner_scale=inner_scale,
        widen_scale=widen_scale)


def _same(got, want):
    """Worst leaf l2rel of two gradient trees (Meta-SGD's flattened)."""
    g, w = flatten(got), flatten(want)
    assert g.keys() == w.keys()
    return max(_l2rel(g[k].float().numpy(), w[k].float().numpy()) for k in w)


PORT_CASES = {
    "dropout_0.1": dict(_dropout=0.1),
    "meta_sgd": dict(_meta_sgd=True),
    "adapt_filter": dict(adapt_filter=("decoder", "ctc_head")),
    "widen": dict(adapt_filter=("decoder",), _widen=1.0),
    "inner_clip": dict(inner_clip=0.5),
    "grad_dtype_bf16": dict(grad_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(PORT_CASES))
def test_remat_equals_no_remat(case):
    """Port against port, the same seed: the recompute changes no value.
    At dropout 0.1 (``train=True`` in the inner loop) the step's masks come
    from its seed, so the recompute draws the forward's masks."""
    kw = dict(PORT_CASES[case])
    task = _task(kw.pop("_dropout", 0.0))
    params = task.init_params(3)
    if kw.pop("_meta_sgd", False):
        params = maml.wrap_lr(params, 0.05)
    widen = kw.pop("_widen", None)
    (g_on, m_on), (g_off, m_off) = (
        _port_grads(task, params, remat, widen_scale=widen, **kw)
        for remat in (True, False))
    for key in ("meta_loss", "support_loss_mean"):
        assert float(m_on[key]) == float(m_off[key]), key
    assert _same(g_on, g_off) <= 1e-6, case
    if case == "meta_sgd":
        rates = g_on["inner_lr"]
        assert all(bool(torch.isfinite(v)) for v in rates.values())
        assert any(float(v) != 0.0 for v in rates.values())


def test_dropout_draws_are_real():
    """The dropout case above is not vacuous: at 0.1 the gradients differ
    from dropout 0's on the same weights and batch."""
    on, off = (_port_grads(_task(p), _task(0.0).init_params(3), True)[0]
               for p in (0.1, 0.0))
    assert _same(on, off) > 1e-3


def test_frozen_leaves_get_their_second_order_term():
    """Under ANIL a frozen leaf shapes the inner gradient: its MAML gradient
    through the recompute differs from FOMAML's, which sees only the query
    term (``test_remat_equals_no_remat[adapt_filter]`` holds it equal to
    the no-remat one)."""
    task = _task()
    params = task.init_params(3)
    pats = ("decoder", "ctc_head")
    remat, _ = _port_grads(task, params, True, adapt_filter=pats)
    first = maml.maml_grads(task.loss_fn, maml.MetaAlgoConfig(
        inner_lr=0.05, inner_steps=2, adapt_filter=pats), task.preprocess)(
        params, _to_torch(_meta_batch()), 7)[0]
    frozen = [k for k, adapted in maml.adapt_mask(params, pats).items()
              if not adapted and k.startswith("encoder.")]
    assert frozen
    gap = max(_l2rel(remat[k].numpy(), first[k].numpy()) for k in frozen)
    assert gap > 1e-3, gap


# ---------------- what the graph holds ----------------

def _held_bytes(task, params, remat) -> int:
    """Bytes of the distinct storages the autograd graph still holds once
    ``inner_adapt`` has returned (the saved tensors whose pack handles are
    alive)."""
    handles = weakref.WeakSet()

    class Saved:
        def __init__(self, t):
            self.t = t

    def pack(t):
        h = Saved(t)
        handles.add(h)
        return h

    cfg = maml.MetaAlgoConfig(inner_lr=0.05, inner_steps=2, first_order=False,
                              remat_inner=remat)
    work = {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}
    mb = _to_torch(_meta_batch())
    support = task.preprocess({k: v[0] for k, v in mb["support"].items()},
                              maml.make_generator(0, "cpu"), True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda h: h.t):
        adapted, _ = maml.make_inner_adapt(task.loss_fn, cfg)(work, support,
                                                              0)
    storages = {h.t.untyped_storage().data_ptr():
                h.t.untyped_storage().nbytes() for h in list(handles)}
    assert adapted
    return sum(storages.values())


def test_remat_holds_less_than_the_unrolled_step():
    """With remat the graph holds each step's inputs (the parameters), not
    its activations and the inner backward's."""
    task = _task()
    params = task.init_params(0)
    param_bytes = sum(v.numel() * v.element_size() for v in params.values())
    held = {remat: _held_bytes(task, params, remat) for remat in (True, False)}
    assert held[True] < held[False], held
    assert held[True] <= 2 * param_bytes, (held, param_bytes)


# ---------------- the plumbing ----------------

@pytest.mark.parametrize("override, want", [({}, True),
                                            ({"meta.remat_inner": False},
                                             False)])
def test_algo_config_carries_config4s_remat(override, want):
    """``train/meta_train.py:84`` of the reference: config4 (``remat_inner:
    true``) trains second order with remat."""
    algo = meta_train.algo_config(load_config(CONFIG4, override))
    assert (algo.first_order, algo.remat_inner) == (False, want)


def test_meta_adapt_is_first_order_without_remat(monkeypatch):
    """The reference's ``meta_adapt`` (``:443``): first order, no remat."""
    seen = {}

    def fake_inner(loss_fn, cfg, train=True):
        seen["cfg"] = cfg
        return lambda params, batch, seed: (params, None)

    monkeypatch.setattr(meta_train, "make_inner_adapt", fake_inner)
    monkeypatch.setattr(meta_train, "support_query_split",
                        lambda *a, **k: ({"x": np.zeros(2, np.float32)}, [0]))
    cfg = load_config(CONFIG4)
    stub = types.SimpleNamespace(
        cfg=cfg, device="cpu", _num_samples_cap=lambda: 1,
        task=types.SimpleNamespace(loss_fn=None,
                                   preprocess=lambda b, g, t: b))
    model, idx = meta_train.MetaASRTrainer.meta_adapt(
        stub, {"w": torch.ones(2)}, None)
    assert (seen["cfg"].first_order, seen["cfg"].remat_inner) == (True, False)
    assert seen["cfg"].inner_steps == cfg.meta.adapt_steps and idx == [0]


@pytest.mark.parametrize("env, want", [({}, True),
                                       ({"BENCH_NO_REMAT": "1"}, False),
                                       ({"BENCH_NO_REMAT": "0"}, True)])
def test_bench_no_remat_hook(monkeypatch, env, want):
    """``bench.py:118`` of the reference: ``BENCH_NO_REMAT`` turns it off."""
    monkeypatch.delenv("BENCH_NO_REMAT", raising=False)
    monkeypatch.setenv("BENCH_SECOND_ORDER", "1")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    algo = bench.algo_config()
    assert (algo.first_order, algo.remat_inner) == (False, want)


def test_cli_config4_reaches_maml_grads_with_remat(tmp_path, monkeypatch):
    """``--mode train --config configs/config4_maml.yaml`` builds its
    meta-gradient with second order and remat."""
    seen = []

    class Built(Exception):
        pass

    def capture(loss_fn, cfg, preprocess_fn=None):
        seen.append(cfg)
        raise Built

    monkeypatch.setattr(meta_train, "maml_grads", capture)
    data = str(tmp_path / "data")
    synthetic.generate_dataset(data, utts_per_accent=2, words_per_utt=(1, 2),
                               seed=0)
    with pytest.raises(Built):
        cli.main(["--mode", "train", "--config", CONFIG4, "--data-dir", data,
                  "--workdir", str(tmp_path / "wd"), "--device", "cpu",
                  "-o", "model.d_model=32", "-o", "model.num_heads=2",
                  "-o", "model.d_ff=64", "-o", "model.num_encoder_layers=2",
                  "-o", "model.num_decoder_layers=2"])
    assert [(c.first_order, c.remat_inner) for c in seen] == [(False, True)]
