"""Port vs reference: the conformer encoder at identical weights.

The same seeded inputs go through ``metaasr_tpu.models.conformer`` (Flax)
and ``metaasr_tpu_torch.models.conformer`` with the Flax tree converted by
``metaasr_tpu_torch.weights``. The reference's small sizes: d=32, 2 heads,
2+2 layers, depthwise kernel 7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.models import conformer as ref
from metaasr_tpu.models.transformer import TransformerASR as FlaxTransformer
from metaasr_tpu_torch.models import conformer
from metaasr_tpu_torch.models.transformer import TransformerASR
from metaasr_tpu_torch.weights import (
    flatten_tree,
    flax_path,
    flax_to_state_dict,
    random_state_dict,
    state_dict_to_flax,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

VOCAB = 30
KERNEL = 7
DIMS = dict(d_model=32, num_heads=2, d_ff=64, num_encoder_layers=2,
            num_decoder_layers=2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _module_sd(prefix: str, flax_params) -> dict:
    """A submodule's Flax params -> its port state_dict (the conversion
    keys on the leaf's module name, so it goes through ``prefix``)."""
    sd = flax_to_state_dict({prefix: jax.tree.map(np.asarray, flax_params)})
    return {k[len(prefix) + 1:]: v for k, v in sd.items()}


def models(dtype="float32", dims=DIMS, t_feat=60, seed=0):
    """(flax model, params as numpy tree, port model with those weights,
    feats [2, t_feat, 80], lens [2])."""
    jdt, tdt = DTYPES[dtype]
    fm = FlaxTransformer(vocab_size=VOCAB, dropout=0.0, dtype=jdt,
                         encoder_type="conformer", conformer_kernel=KERNEL,
                         **dims)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, t_feat, 80)).astype(np.float32)
    lens = np.array([t_feat, t_feat - 17], np.int32)
    toks = rng.integers(1, VOCAB - 1, (2, 5)).astype(np.int32)
    params = fm.init(jax.random.PRNGKey(seed), jnp.asarray(feats),
                     jnp.asarray(lens), jnp.asarray(toks),
                     jnp.array([5, 5]))["params"]
    params = jax.tree.map(np.asarray, params)
    pm = TransformerASR(VOCAB, dtype=tdt, encoder_type="conformer",
                        conformer_kernel=KERNEL, **dims).eval()
    pm.load_state_dict(flax_to_state_dict(params))
    return fm, params, pm, feats, lens


@pytest.fixture(scope="module")
def fp32_models():
    return models("float32")


def test_rel_shift_matches_reference():
    rng = np.random.default_rng(0)
    for t in (1, 7, 14):
        x = rng.standard_normal((2, 3, t, 2 * t - 1)).astype(np.float32)
        want = np.asarray(ref.rel_shift(jnp.asarray(x)))
        np.testing.assert_array_equal(
            conformer.rel_shift(torch.from_numpy(x)).numpy(), want)


def test_relative_table_matches_reference():
    """``relative_positions`` and the encoder's slice of its 4096-offset
    buffer both equal the reference's table exactly."""
    enc = conformer.ConformerEncoder(32, 2, 64, 1, 80, torch.float32,
                                     kernel_size=KERNEL)
    for t in (1, 9, 250):
        want = ref.relative_positions(t, 32)
        np.testing.assert_array_equal(conformer.relative_positions(t, 32),
                                      want)
        np.testing.assert_array_equal(enc.relative_table(t).numpy(), want)


def test_relpos_attention_matches_reference():
    d, heads, t = 32, 2, 9
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    lens = np.array([t, 6])
    bias = np.where(np.arange(t)[None] < lens[:, None], 0.0, -1e9).astype(
        np.float32)[:, None, None, :]
    attn = ref.RelPosSelfAttention(d_model=d, num_heads=heads)
    params = attn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(bias))["params"]
    want = attn.apply({"params": params}, jnp.asarray(x), jnp.asarray(bias))
    pa = conformer.RelPosSelfAttention(d, heads, torch.float32)
    pa.load_state_dict(_module_sd("self_attn", params))
    rel = torch.from_numpy(conformer.relative_positions(t, d))
    with torch.no_grad():
        got = pa(torch.from_numpy(x), torch.from_numpy(bias), rel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("k", [7, 6])
def test_depthwise_conv_matches_reference(k):
    """Forward and the gradients of sum(sin(out)) w.r.t. kernel, bias and
    input; k = 6 checks the even kernel's padding split."""
    b, t, c = 3, 17, 8
    x = np.random.default_rng(k).standard_normal((b, t, c)).astype(np.float32)
    dw = ref.DepthwiseConv1d(features=c, kernel_size=k)
    params = dw.init(jax.random.PRNGKey(k), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"],
              "bias": 0.1 * jax.random.normal(jax.random.PRNGKey(1), (c,))}

    def loss(p, x_):
        return jnp.sum(jnp.sin(dw.apply({"params": p}, x_)))

    want = dw.apply({"params": params}, jnp.asarray(x))
    g_p, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    pd = conformer.DepthwiseConv1d(c, k, torch.float32)
    pd.load_state_dict(_module_sd("depthwise", params))
    assert pd.weight.shape == (c, 1, k)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pd(xt)
    torch.sin(got).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(pd.weight.grad.numpy().transpose(2, 1, 0),
                               np.asarray(g_p["kernel"]), **tol)
    np.testing.assert_allclose(pd.bias.grad.numpy(), np.asarray(g_p["bias"]),
                               **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **tol)


def test_conv_module_matches_reference():
    """Padded frames are zeroed before the depthwise convolution, so the
    valid frames' outputs do not read them."""
    b, t, c = 2, 13, 8
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    mask = (np.arange(t)[None] < np.array([t, 8])[:, None])[..., None]
    mod = ref.ConvModule(d_model=c, kernel_size=KERNEL, dropout=0.0)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                      jnp.asarray(mask), False)["params"]
    want = mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask),
                     False)
    pm = conformer.ConvModule(c, KERNEL, torch.float32)
    pm.load_state_dict(_module_sd("conv", params))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _compare(fm, params, pm, feats, lens, atol):
    """Encoder output, CTC logits and four decoder steps (3 hypotheses a
    row, distinct tokens per row) at ``atol``; -> (reference CTC logits,
    port CTC logits, lengths) as numpy arrays."""
    v = {"params": params}
    enc, enc_lens = fm.apply(v, jnp.asarray(feats), jnp.asarray(lens), False,
                             method=fm.encode)
    ctc = fm.apply(v, enc, method=fm.apply_ctc_head)
    k, n = 3, 6
    caches = fm.apply(v, n, 8, method=fm.decoder_init_state)
    cross = jax.tree.map(lambda x: jnp.repeat(x, k, 0),
                         fm.apply(v, enc, method=fm.decoder_precompute_cross))
    lens_rep = jnp.repeat(enc_lens, k, 0)
    with torch.no_grad():
        penc, plens = pm.encode(torch.from_numpy(feats), torch.from_numpy(lens))
        np.testing.assert_array_equal(plens.numpy(), np.asarray(enc_lens))
        np.testing.assert_allclose(penc.numpy(), np.asarray(enc), atol=atol,
                                   rtol=0)
        pctc = pm.apply_ctc_head(penc)
        np.testing.assert_allclose(pctc.numpy(), np.asarray(ctc), atol=atol,
                                   rtol=0)
        pcaches = pm.decoder_init_state(n, 8)
        pcross = [{name: c.repeat_interleave(k, 0) for name, c in layer.items()}
                  for layer in pm.decoder_precompute_cross(penc)]
        plens_rep = plens.repeat_interleave(k, 0)
        tok = np.full((n, 1), VOCAB - 1, np.int32)
        for step in range(4):
            lp, caches = fm.apply(v, jnp.asarray(tok), step, caches, None,
                                  lens_rep, cross, method=fm.decoder_step)
            plp, pcaches = pm.decoder_step(torch.from_numpy(tok).long(), step,
                                           pcaches, plens_rep, pcross)
            np.testing.assert_allclose(plp.numpy(), np.asarray(lp), atol=atol,
                                       rtol=0)
            tok = ((np.asarray(jnp.argmax(lp, -1)) + np.arange(n)) % (VOCAB - 1)
                   + 1)[:, None].astype(np.int32)
    return np.asarray(ctc), pctc.numpy(), plens.numpy()


def test_fp32_encoder_ctc_and_decoder_step_match_reference(fp32_models):
    fm, params, pm, feats, lens = fp32_models
    _compare(fm, params, pm, feats, lens, atol=1e-4)
    # the standalone encoder (the module the task calls functionally)
    enc = conformer.ConformerEncoder(32, 2, 64, 2, 80, torch.float32,
                                     kernel_size=KERNEL)
    enc.load_state_dict(_module_sd("encoder", params["encoder"]))
    want, _ = fm.apply({"params": params}, jnp.asarray(feats),
                       jnp.asarray(lens), False, method=fm.encode)
    with torch.no_grad():
        got, _ = enc(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_bf16_compute_matches_reference():
    """bf16 compute, fp32 weights (config3's ``model.dtype``). The gap is
    single bf16 ulps, carried through the layers: the reference's bf16
    sigmoid (swish, GLU) rounds its exp, its 1 + exp and its reciprocal
    apart where ``F.silu``/``F.glu`` round once, and its depthwise
    convolution rounds after each of the K multiply-adds where
    ``F.conv1d`` accumulates in fp32. Measured max |diff| at these shapes:
    2.6e-2 on fp32 outputs of magnitude up to ~4 (one bf16 ulp at 2-4 is
    1.6e-2), 2.8e-2-3.2e-2 at seeds 1-2. Bound 5e-2.

    Greedy CTC: the per-frame argmax equals the reference's at every frame
    where the reference's top two logits are more than twice the bound
    apart (its choice is then fixed at this precision): 18 of the 24 valid
    frames here. Random weights leave near-ties at the other 6; at one of
    them the reference's top two are 1.6e-3 apart and the port picks the
    second. There the port must pick a token the reference scores within
    the bound of its best."""
    fm, params, pm, feats, lens = models("bfloat16")
    bound = 5e-2
    ctc, pctc, plens = _compare(fm, params, pm, feats, lens, atol=bound)
    valid = np.arange(ctc.shape[1])[None] < plens[:, None]
    top2 = np.sort(ctc, -1)[..., -2:]
    resolved = valid & (top2[..., 1] - top2[..., 0] > 2 * bound)
    want, got = ctc.argmax(-1), pctc.argmax(-1)
    np.testing.assert_array_equal(got[resolved], want[resolved])
    open_ = valid & ~resolved
    picked = np.take_along_axis(ctc, got[..., None], -1)[..., 0]
    assert np.all(top2[..., 1][open_] - picked[open_] <= bound)


def test_encoder_padding_invariance():
    """Corrupted padding frames leave the valid outputs unchanged (the
    attention mask and the conv module's re-zeroing both hold), and the
    padded encoder frames are zero."""
    enc = conformer.ConformerEncoder(32, 2, 64, 2, 80, torch.float32,
                                     kernel_size=KERNEL).eval()
    enc.load_state_dict(random_state_dict(enc, seed=5))
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal((2, 35, 80)).astype(
        np.float32))
    lens = torch.tensor([35, 19])
    with torch.no_grad():
        out, out_lens = enc(feats, lens)
        feats2 = feats.clone()
        feats2[1, 19:] = 7.0
        out2, _ = enc(feats2, lens)
    assert out.shape == (2, 8, 32) and out_lens.tolist() == [8, 4]
    np.testing.assert_allclose(out[1, :4].numpy(), out2[1, :4].numpy(),
                               rtol=2e-3, atol=2e-4)
    assert float(out[1, 4:].abs().max()) == 0.0


def test_weights_roundtrip_conformer_tree():
    """One encoder and one decoder layer: 70 Flax leaves, every one with a
    home in the port's state_dict (u_bias and v_bias apart), and back
    exactly, with the reference's shapes."""
    dims = dict(DIMS, num_encoder_layers=1, num_decoder_layers=1)
    _, params, pm, _, _ = models(dims=dims, t_feat=40)
    ref_flat = flatten_tree(params)
    sd = flax_to_state_dict(params)
    assert len(ref_flat) == len(sd) == 70
    assert set(sd) == set(pm.state_dict())
    for k in sd:
        assert sd[k].shape == pm.state_dict()[k].shape, k
    back = flatten_tree(state_dict_to_flax(sd, dims["num_heads"]))
    assert back.keys() == ref_flat.keys()
    for k in ref_flat:
        assert back[k].shape == ref_flat[k].shape, k
        np.testing.assert_array_equal(back[k], ref_flat[k])
    # the seeded init: per-head u/v biases at the reference's scale
    rsd = random_state_dict(pm, seed=3)
    again = flax_to_state_dict(state_dict_to_flax(rsd, dims["num_heads"]))
    for k in rsd:
        torch.testing.assert_close(again[k], rsd[k], rtol=0, atol=0)
    u = torch.cat([rsd[k].flatten() for k in rsd if k.endswith("_bias")
                   and "self_attn" in k])
    assert 0.01 < float(u.std()) < 0.04


def test_flax_path_names_every_conformer_leaf(fp32_models):
    """``flax_path`` gives the reference's path for every leaf, so
    ``adapt_filter`` patterns select the same leaves in both packages."""
    _, params, pm, _, _ = fp32_models
    ref_paths = set(flatten_tree(params))
    got = [flax_path(k) for k in pm.state_dict()]
    assert sorted(got) == sorted(ref_paths)
    for pattern in ("decoder", "self_attn", "conv", "u_bias", "depthwise"):
        assert ({p for p in got if pattern in p}
                == {p for p in ref_paths if pattern in p}), pattern
