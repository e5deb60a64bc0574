"""Port vs reference: the meta-gradients.

FOMAML's ``maml_grads`` and Reptile's ``reptile_grads`` of
``metaasr_tpu_torch.meta.maml`` against ``metaasr_tpu.meta.maml`` on the
tiny transformer (d=32, 2 heads, 2+2 layers) over the ASR task: 2 tasks x
(2 support + 2 query) utterances of <= 8,000 samples, U <= 6, 2 inner
steps. Dropout 0, SpecAugment off and dither 0, so ``train=True`` is
deterministic in both packages. The same Flax weights go into both through
``weights.py``. Then the analytic quadratic checks on the port alone,
first order and second order (the second-order comparisons with the
reference are in ``tests/test_torch_maml.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.meta import maml as ref_maml
from metaasr_tpu.train.task import ASRTask as RefTask
from metaasr_tpu_torch.meta import maml
from metaasr_tpu_torch.task import ASRTask
from metaasr_tpu_torch.weights import flatten_tree, flax_to_params, params_to_flax
from tests.test_m2_models import tiny_cfg

VOCAB = 30
M_TASKS, K = 2, 2
# Measured on the CPU, worst leaf: fp32 cases 2e-5 .. 7.5e-5 (the front-ends
# differ by ~1e-6: K1's plain version against the reference's fbank), the
# bf16 meta-step 2.6e-3 (bf16 rounds at different places in the two
# frameworks). Bounds: 1e-3 for fp32, 1e-2 for bf16.
GRAD_L2REL = {"float32": 1e-3, "bfloat16": 1e-2}
LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _meta_batch(seed=0):
    rng = np.random.default_rng(seed)

    def part():
        lens = rng.integers(5000, 8001, (M_TASKS, K)).astype(np.int32)
        lens[:, 0] = 8000
        audio = (0.1 * rng.standard_normal((M_TASKS, K, 8000))).astype(
            np.float32)
        audio *= np.arange(8000)[None, None, :] < lens[..., None]
        tok_lens = rng.integers(2, 7, (M_TASKS, K)).astype(np.int32)
        tokens = rng.integers(1, VOCAB - 1, (M_TASKS, K, 6)).astype(np.int32)
        tokens *= np.arange(6)[None, None, :] < tok_lens[..., None]
        return {"audio": audio, "audio_lens": lens, "tokens": tokens,
                "token_lens": tok_lens}

    return {"support": part(), "query": part()}


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg("transformer", vocab=VOCAB)
    ref_task = RefTask(cfg, VOCAB - 1)
    mb = _meta_batch()
    sample = {k: jnp.asarray(v[0]) for k, v in mb["support"].items()}
    params = jax.tree.map(np.asarray, ref_task.init_params(
        jax.random.PRNGKey(0), sample))
    task = ASRTask(port_cfg(cfg), VOCAB - 1, device="cpu")
    return cfg, ref_task, task, params, mb


def port_cfg(ref_cfg):
    """The reference config as the port's Config (every section copied)."""
    from metaasr_tpu_torch.config import Config

    cfg = Config()
    for section in vars(cfg):
        for k, v in vars(getattr(ref_cfg, section)).items():
            setattr(getattr(cfg, section), k, v)
    return cfg


def _to_torch(tree):
    return {k: (_to_torch(v) if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in tree.items()}


def _l2rel(got, want):
    """Per-leaf ||got - want|| / ||want||, with ||want|| floored at 1e-4:
    the cross-attention key biases have an exact gradient of 0 (softmax
    ignores a constant per query), so both sides hold rounding noise
    there, ~1e-9."""
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-4))


CASES = {
    "plain": {},
    "learn_inner_lr": {"_meta_sgd": True},
    "inner_clip": {"inner_clip": 0.5},
    "adapt_filter": {"adapt_filter": ("decoder", "ctc_head")},
    "inner_scale_0": {"_inner_scale": 0.0},
    "grad_dtype_bf16": {"grad_dtype": "bfloat16"},
}


_REF_FNS = {}


def _ref_grad_fn(ref_task, ref_cfg):
    """The reference's jitted grad_fn, compiled once per config (the gate
    is traced, so ``plain`` runs it at 1.0, which is exact, and
    ``inner_scale_0`` at 0.0)."""
    if ref_cfg not in _REF_FNS:
        _REF_FNS[ref_cfg] = jax.jit(ref_maml.maml_grads(
            ref_task.loss_fn, ref_cfg, ref_task.preprocess))
    return _REF_FNS[ref_cfg]


@pytest.mark.parametrize("case", list(CASES))
def test_fomaml_grads_match_reference(setup, case):
    _, ref_task, task, params, mb = setup
    kw = dict(CASES[case])
    inner_scale = kw.pop("_inner_scale", None)
    meta_sgd = kw.pop("_meta_sgd", False)
    common = dict(inner_lr=0.05, inner_steps=2, first_order=True, **kw)
    cfg = maml.MetaAlgoConfig(**common)
    ref_params = ref_maml.wrap_lr(params, 0.05) if meta_sgd else params
    ref_fn = _ref_grad_fn(ref_task, ref_maml.MetaAlgoConfig(
        learn_inner_lr=meta_sgd, **common))
    scale = jnp.float32(1.0 if inner_scale is None else inner_scale)
    want, want_m = ref_fn(ref_params, jax.tree.map(jnp.asarray, mb),
                          jax.random.PRNGKey(0), scale)
    port_params = flax_to_params(jax.tree.map(np.asarray, ref_params))
    got, got_m = maml.maml_grads(task.loss_fn, cfg, task.preprocess)(
        port_params, _to_torch(mb), 0, inner_scale)
    dt = cfg.grad_dtype or "float32"
    for key in ("meta_loss", "query_loss_max", "support_loss_mean"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]),
                                   rtol=LOSS_RTOL[dt])
    want_flat = flatten_tree(jax.tree.map(np.asarray, want))
    got_flat = flatten_tree(params_to_flax(got, num_heads=2))
    assert got_flat.keys() == want_flat.keys()
    worst = max(_l2rel(got_flat[k], want_flat[k]) for k in want_flat)
    assert worst <= GRAD_L2REL[dt], (case, worst)


def test_reptile_delta_matches_reference(setup):
    _, ref_task, task, params, mb = setup
    common = dict(inner_lr=0.05, inner_steps=2, first_order=True)
    want, want_m = jax.jit(ref_maml.reptile_grads(
        ref_task.loss_fn, ref_maml.MetaAlgoConfig(**common),
        ref_task.preprocess))(params, jax.tree.map(jnp.asarray, mb),
                              jax.random.PRNGKey(0))
    got, got_m = maml.reptile_grads(
        task.loss_fn, maml.MetaAlgoConfig(**common), task.preprocess)(
        flax_to_params(params), _to_torch(mb), 0)
    for key in ("meta_loss", "support_loss_mean"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]),
                                   rtol=1e-4)
    want_flat = flatten_tree(jax.tree.map(np.asarray, want))
    got_flat = flatten_tree(params_to_flax(got, num_heads=2))
    worst = max(_l2rel(got_flat[k], want_flat[k]) for k in want_flat)
    assert worst <= 1e-3, worst


def test_adapt_mask_uses_reference_paths(setup):
    _, _, task, _, _ = setup
    model = task.init_params(0)
    mask = maml.adapt_mask(model, ("layer_1/ff",))
    assert {k for k, v in mask.items() if v} == {
        k for k in model if k.startswith(("encoder.layers.1.ff.",
                                          "decoder.layers.1.ff."))}
    with pytest.raises(ValueError, match="matches no parameter"):
        maml.adapt_mask(model, ("nothing",))


# ---------------- analytic quadratic family, on the port alone ----------

def quad_loss(params, batch, generator, train):
    """0.5 * ||w - c||^2 — inner SGD has a closed form."""
    del generator, train
    diff = params["w"] - batch["c"]
    return 0.5 * torch.sum(diff * diff), {}


def _quad(d=5, k=3, lr=0.1, seed=0):
    rng = np.random.default_rng(seed)
    w, c_s, c_q = (torch.tensor(rng.standard_normal(d), dtype=torch.float32)
                   for _ in range(3))
    return w, c_s, c_q, c_s + (1 - lr) ** k * (w - c_s)


def test_quadratic_inner_adapt_closed_form():
    w, c_s, _, w_k = _quad()
    inner = maml.make_inner_adapt(
        quad_loss, maml.MetaAlgoConfig(inner_lr=0.1, inner_steps=3))
    adapted, losses = inner({"w": w}, {"c": c_s}, 0)
    torch.testing.assert_close(adapted["w"], w_k, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(losses[0]),
                               0.5 * float(torch.sum((w - c_s) ** 2)),
                               rtol=1e-5)


def test_quadratic_fomaml_gradient():
    """FOMAML outer grad == query grad at the adapted point, w_k - c_q."""
    w, c_s, c_q, w_k = _quad()
    grads, metrics = maml.maml_grads(
        quad_loss, maml.MetaAlgoConfig(inner_lr=0.1, inner_steps=3))(
        {"w": w}, {"support": {"c": c_s[None]}, "query": {"c": c_q[None]}}, 0)
    torch.testing.assert_close(grads["w"], w_k - c_q, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(metrics["meta_loss"]),
                               0.5 * float(torch.sum((w_k - c_q) ** 2)),
                               rtol=1e-5)


def test_quadratic_meta_loss_and_its_gradient():
    """make_meta_loss: the query loss at w_k, and its backward is the
    FOMAML gradient."""
    w, c_s, c_q, w_k = _quad()
    w = w.clone().requires_grad_(True)
    loss, aux = maml.make_meta_loss(
        quad_loss, maml.MetaAlgoConfig(inner_lr=0.1, inner_steps=3))(
        {"w": w}, {"support": {"c": c_s[None]}, "query": {"c": c_q[None]}}, 0)
    np.testing.assert_allclose(float(loss.detach()),
                               0.5 * float(torch.sum((w_k - c_q) ** 2)),
                               rtol=1e-5)
    assert aux["task_query_losses"].shape == (1,)
    loss.backward()
    torch.testing.assert_close(w.grad, (w_k - c_q).detach())


def test_quadratic_task_mean():
    """Two tasks: the outer grad is the mean of the per-task grads."""
    w, c_s, c_q, _ = _quad()
    c_s2, c_q2 = c_s + 1.0, c_q - 0.5
    cfg = maml.MetaAlgoConfig(inner_lr=0.1, inner_steps=2)
    fn = maml.maml_grads(quad_loss, cfg)
    both, _ = fn({"w": w}, {"support": {"c": torch.stack([c_s, c_s2])},
                            "query": {"c": torch.stack([c_q, c_q2])}}, 0)
    one, _ = fn({"w": w}, {"support": {"c": c_s[None]},
                           "query": {"c": c_q[None]}}, 0)
    two, _ = fn({"w": w}, {"support": {"c": c_s2[None]},
                           "query": {"c": c_q2[None]}}, 0)
    torch.testing.assert_close(both["w"], 0.5 * (one["w"] + two["w"]))


def test_quadratic_inner_clip():
    """A clip below the gradient norm moves exactly lr * clip against the
    gradient; a huge clip is the unclipped step; under FOMAML the outer
    grad is the query grad at the clipped point."""
    w, c_s, c_q, _ = _quad(k=1)
    gnorm = float(torch.linalg.norm(w - c_s))
    clip = 0.25 * gnorm
    step_of = lambda cfg: maml.make_inner_adapt(quad_loss, cfg)(  # noqa: E731
        {"w": w}, {"c": c_s}, 0)[0]["w"] - w
    step = step_of(maml.MetaAlgoConfig(inner_lr=0.1, inner_steps=1,
                                       inner_clip=clip))
    np.testing.assert_allclose(float(torch.linalg.norm(step)), 0.1 * clip,
                               rtol=1e-5)
    g = w - c_s
    torch.testing.assert_close(step / torch.linalg.norm(step),
                               -g / torch.linalg.norm(g))
    torch.testing.assert_close(
        step_of(maml.MetaAlgoConfig(inner_lr=0.1, inner_steps=1,
                                    inner_clip=1e9)),
        step_of(maml.MetaAlgoConfig(inner_lr=0.1, inner_steps=1)))
    cfg = maml.MetaAlgoConfig(inner_lr=0.1, inner_steps=2,
                              inner_clip=0.5 * gnorm)
    grads, _ = maml.maml_grads(quad_loss, cfg)(
        {"w": w}, {"support": {"c": c_s[None]}, "query": {"c": c_q[None]}}, 0)
    adapted, _ = maml.make_inner_adapt(quad_loss, cfg)({"w": w}, {"c": c_s}, 0)
    torch.testing.assert_close(grads["w"], adapted["w"] - c_q)


def test_quadratic_meta_sgd_rate_gradient():
    """Meta-SGD, one inner step: w1 = w - a (w - c_s); the query loss
    0.5||w1 - c_q||^2 has d/da = -(w1 - c_q) . (w - c_s), and the model
    gradient is the first-order w1 - c_q (input-side detach)."""
    w, c_s, c_q, _ = _quad()
    a = 0.1
    cfg = maml.MetaAlgoConfig(inner_lr=a, inner_steps=1)
    params = maml.wrap_lr({"w": w}, a)
    grads, _ = maml.maml_grads(quad_loss, cfg)(
        params, {"support": {"c": c_s[None]}, "query": {"c": c_q[None]}}, 0)
    w1 = w - a * (w - c_s)
    torch.testing.assert_close(grads["model"]["w"], w1 - c_q)
    np.testing.assert_allclose(float(grads["inner_lr"]["w"]),
                               -float(torch.dot(w1 - c_q, w - c_s)),
                               rtol=1e-5)


def test_quadratic_reptile_direction():
    """Reptile's outer gradient is params - adapted on support + query."""
    w, c_s, c_q, _ = _quad(k=2)
    cfg = maml.MetaAlgoConfig(inner_lr=0.1, inner_steps=2)

    def loss(params, batch, generator, train):
        diff = params["w"][None] - batch["c"]
        return 0.5 * torch.sum(diff * diff), {}

    grads, _ = maml.reptile_grads(loss, cfg)(
        {"w": w}, {"support": {"c": c_s[None, None]},
                   "query": {"c": c_q[None, None]}}, 0)
    target = 0.5 * (c_s + c_q)            # the combined loss's minimum
    w2 = target + (1 - 2 * 0.1) ** 2 * (w - target)
    torch.testing.assert_close(grads["w"], w - w2)


def test_quadratic_inner_scale_zero_is_no_op():
    w, c_s, c_q, _ = _quad()
    cfg = maml.MetaAlgoConfig(inner_lr=0.1, inner_steps=3)
    grads, _ = maml.maml_grads(quad_loss, cfg)(
        {"w": w}, {"support": {"c": c_s[None]}, "query": {"c": c_q[None]}},
        0, inner_scale=0.0)
    torch.testing.assert_close(grads["w"], w - c_q)


# ---------------- second order on the quadratic family ----------------

def aquad_loss(params, batch, generator, train):
    """0.5 (w - c)^T A (w - c): one inner step is w - lr A (w - c), whose
    Jacobian is I - lr A."""
    del generator, train
    diff = params["w"] - batch["c"]
    return 0.5 * torch.dot(diff, batch["A"] @ diff), {}


# float64 problems; the outer gradient is accumulated in fp32, hence 1e-6


def _aquad(d=5, seed=0):
    rng = np.random.default_rng(seed)
    w, c_s, c_q = (torch.tensor(rng.standard_normal(d), dtype=torch.float64)
                   for _ in range(3))
    r = torch.tensor(rng.standard_normal((d, d)), dtype=torch.float64)
    a = r @ r.T / d + 0.5 * torch.eye(d, dtype=torch.float64)
    mb = {"support": {"c": c_s[None], "A": a[None]},
          "query": {"c": c_q[None], "A": a[None]}}
    return w, c_s, c_q, a, mb


@pytest.mark.parametrize("k", [1, 2, 3])
def test_quadratic_maml_gradient_closed_form(k):
    """Second-order meta-gradient: (I - lr A)^k applied to the query
    gradient A (w_k - c_q) at the adapted point."""
    w, c_s, c_q, a, mb = _aquad()
    lr = 0.1
    step = torch.eye(5, dtype=torch.float64) - lr * a
    w_k = w
    for _ in range(k):
        w_k = w_k - lr * a @ (w_k - c_s)
    want = torch.linalg.matrix_power(step, k) @ (a @ (w_k - c_q))
    cfg = maml.MetaAlgoConfig(inner_lr=lr, inner_steps=k, first_order=False)
    grads, metrics = maml.maml_grads(aquad_loss, cfg)({"w": w}, mb, 0)
    torch.testing.assert_close(grads["w"], want, rtol=1e-6, atol=1e-7)
    first, _ = maml.maml_grads(aquad_loss, maml.MetaAlgoConfig(
        inner_lr=lr, inner_steps=k))({"w": w}, mb, 0)
    torch.testing.assert_close(first["w"], a @ (w_k - c_q), rtol=1e-6,
                               atol=1e-12)
    assert not torch.allclose(grads["w"], first["w"], rtol=1e-3)
    diff = w_k - c_q
    np.testing.assert_allclose(float(metrics["meta_loss"]),
                               0.5 * float(diff @ a @ diff), rtol=1e-6)


def test_quadratic_maml_meta_loss_is_differentiable_at_second_order():
    w, c_s, c_q, a, mb = _aquad()
    lr, k = 0.1, 2
    w = w.clone().requires_grad_(True)
    cfg = maml.MetaAlgoConfig(inner_lr=lr, inner_steps=k, first_order=False)
    loss, _ = maml.make_meta_loss(aquad_loss, cfg)({"w": w}, mb, 0)
    loss.backward()
    want, _ = maml.maml_grads(aquad_loss, cfg)({"w": w.detach()}, mb, 0)
    torch.testing.assert_close(w.grad, want["w"], rtol=1e-6, atol=1e-7)


def test_quadratic_maml_meta_sgd_gradients():
    """Meta-SGD under second order, one step: w1 = w - a A (w - c_s);
    dL/dw = (I - a A) A (w1 - c_q), dL/da = -(A (w1 - c_q)) . (A (w - c_s))."""
    w, c_s, c_q, a, mb = _aquad()
    rate = 0.1
    cfg = maml.MetaAlgoConfig(inner_lr=rate, inner_steps=1, first_order=False)
    params = maml.wrap_lr({"w": w}, rate)
    grads, _ = maml.maml_grads(aquad_loss, cfg)(params, mb, 0)
    g_s = a @ (w - c_s)
    w1 = w - np.float32(rate).item() * g_s      # the rate is an fp32 leaf
    g_q = a @ (w1 - c_q)
    eye = torch.eye(5, dtype=torch.float64)
    torch.testing.assert_close(
        grads["model"]["w"], (eye - np.float32(rate).item() * a) @ g_q,
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(grads["inner_lr"]["w"]),
                               -float(g_q @ g_s), rtol=1e-6)


def test_quadratic_maml_clip_scale_is_a_constant():
    """Under an active clip the step is lr * s * g with s = clip / |g| held
    constant: the Jacobian is I - lr s A, with no term from d s / d w."""
    w, c_s, c_q, a, mb = _aquad()
    lr = 0.1
    g_s = a @ (w - c_s)
    clip = 0.25 * float(torch.linalg.norm(g_s))
    scale = np.float32(clip / (np.float32(torch.linalg.norm(g_s).item())
                               + np.float32(1e-12))).item()
    w1 = w - lr * scale * g_s
    want = (torch.eye(5, dtype=torch.float64) - lr * scale * a) @ (
        a @ (w1 - c_q))
    cfg = maml.MetaAlgoConfig(inner_lr=lr, inner_steps=1, first_order=False,
                              inner_clip=clip)
    grads, _ = maml.maml_grads(aquad_loss, cfg)({"w": w}, mb, 0)
    torch.testing.assert_close(grads["w"], want, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("gate", ["inner_scale", "widen_scale"])
def test_quadratic_maml_gates_are_constants(gate):
    """inner_scale 0 (and widen_scale 0 on a leaf outside adapt_filter)
    makes the inner loop a no-op: the outer gradient is the query gradient
    at w."""
    w, c_s, c_q, a, mb = _aquad()
    kw = {"inner_scale": 0.0} if gate == "inner_scale" else {"widen_scale": 0.0}

    def loss(params, batch, generator, train):
        base, _ = aquad_loss({"w": params["encoder.w"]}, batch, None, train)
        return base + 0.5 * torch.sum(params["decoder.v"] ** 2), {}

    params = {"encoder.w": w, "decoder.v": torch.ones(2, dtype=torch.float64)}
    cfg = maml.MetaAlgoConfig(inner_lr=0.1, inner_steps=2, first_order=False,
                              adapt_filter=("decoder",))
    grads, _ = maml.maml_grads(loss, cfg)(params, mb, 0, **kw)
    torch.testing.assert_close(grads["encoder.w"], a @ (w - c_q),
                               rtol=1e-6, atol=1e-7)
