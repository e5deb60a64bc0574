"""Port vs reference: the transformer at identical weights.

The same seeded inputs go through ``metaasr_tpu.models.transformer`` (Flax)
and ``metaasr_tpu_torch.models.transformer`` with the Flax tree converted by
``metaasr_tpu_torch.weights``. Small shapes: d=32, 2 heads, 2+2 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.models.transformer import TransformerASR as FlaxTransformer
from metaasr_tpu_torch.models.transformer import TransformerASR
from metaasr_tpu_torch.weights import (
    flatten_tree,
    flax_to_state_dict,
    random_state_dict,
    state_dict_to_flax,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

VOCAB = 30
DIMS = dict(d_model=32, num_heads=2, d_ff=64, num_encoder_layers=2,
            num_decoder_layers=2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def flax_and_port(dtype="float32", vocab=VOCAB, dims=DIMS, t_feat=60, seed=0):
    """(flax model, params as numpy tree, port model with those weights,
    feats [2, t_feat, 80], lens [2])."""
    jdt, tdt = DTYPES[dtype]
    fm = FlaxTransformer(vocab_size=vocab, dropout=0.0, dtype=jdt, **dims)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, t_feat, 80)).astype(np.float32)
    lens = np.array([t_feat, t_feat - 17], np.int32)
    toks = rng.integers(1, vocab - 1, (2, 5)).astype(np.int32)
    params = fm.init(jax.random.PRNGKey(seed), jnp.asarray(feats),
                     jnp.asarray(lens), jnp.asarray(toks),
                     jnp.array([5, 5]))["params"]
    params = jax.tree.map(np.asarray, params)
    pm = TransformerASR(vocab, dtype=tdt, **dims).eval()
    pm.load_state_dict(flax_to_state_dict(params))
    return fm, params, pm, feats, lens


def test_weights_roundtrip_flax_tree():
    fm, params, pm, _, _ = flax_and_port()
    sd = flax_to_state_dict(params)
    assert set(sd) == set(pm.state_dict())        # every leaf has a home
    back = flatten_tree(state_dict_to_flax(sd, DIMS["num_heads"]))
    ref = flatten_tree(params)
    assert back.keys() == ref.keys()
    for k in ref:
        assert back[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(back[k], ref[k])
    # flat a/b/c keys (bundle and checkpoint npz layout) convert the same
    flat_sd = flax_to_state_dict(ref)
    for k in sd:
        torch.testing.assert_close(flat_sd[k], sd[k], rtol=0, atol=0)


def test_random_state_dict_roundtrips_through_flax_layout():
    pm = TransformerASR(VOCAB, **DIMS)
    sd = random_state_dict(pm, seed=3)
    again = flax_to_state_dict(state_dict_to_flax(sd, DIMS["num_heads"]))
    for k in sd:
        torch.testing.assert_close(again[k], sd[k], rtol=0, atol=0)
    sd2 = random_state_dict(pm, seed=3)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


def _compare(dtype, atol):
    fm, params, pm, feats, lens = flax_and_port(dtype)
    v = {"params": params}
    enc, enc_lens = fm.apply(v, jnp.asarray(feats), jnp.asarray(lens), False,
                             method=fm.encode)
    ctc = fm.apply(v, enc, method=fm.apply_ctc_head)
    k, steps = 3, 4
    n = 2 * k
    caches = fm.apply(v, n, 8, method=fm.decoder_init_state)
    cross = jax.tree.map(lambda x: jnp.repeat(x, k, 0),
                         fm.apply(v, enc, method=fm.decoder_precompute_cross))
    lens_rep = jnp.repeat(enc_lens, k, 0)
    with torch.no_grad():
        penc, plens = pm.encode(torch.from_numpy(feats), torch.from_numpy(lens))
        np.testing.assert_array_equal(plens.numpy(), np.asarray(enc_lens))
        np.testing.assert_allclose(penc.numpy(), np.asarray(enc), atol=atol,
                                   rtol=0)
        np.testing.assert_allclose(pm.apply_ctc_head(penc).numpy(),
                                   np.asarray(ctc), atol=atol, rtol=0)
        pcaches = pm.decoder_init_state(n, 8)
        pcross = [{name: c.repeat_interleave(k, 0) for name, c in layer.items()}
                  for layer in pm.decoder_precompute_cross(penc)]
        plens_rep = plens.repeat_interleave(k, 0)
        tok = np.full((n, 1), VOCAB - 1, np.int32)
        for step in range(steps):
            lp, caches = fm.apply(v, jnp.asarray(tok), step, caches, None,
                                  lens_rep, cross, method=fm.decoder_step)
            plp, pcaches = pm.decoder_step(torch.from_numpy(tok).long(), step,
                                           pcaches, plens_rep, pcross)
            np.testing.assert_allclose(plp.numpy(), np.asarray(lp), atol=atol,
                                       rtol=0)
            # feed each row a different token so the caches diverge
            tok = ((np.asarray(jnp.argmax(lp, -1)) + np.arange(n)) % (VOCAB - 1)
                   + 1)[:, None].astype(np.int32)
        # coverage signal: head-averaged last-layer cross attention
        lp, _, att = fm.apply(v, jnp.asarray(tok), steps, caches, None,
                              lens_rep, cross, return_attn=True,
                              method=fm.decoder_step)
        plp, _, patt = pm.decoder_step(torch.from_numpy(tok).long(), steps,
                                       pcaches, plens_rep, pcross,
                                       return_attn=True)
        np.testing.assert_allclose(patt.numpy(), np.asarray(att), atol=atol,
                                   rtol=0)


def test_fp32_encoder_ctc_and_decoder_step_match_flax():
    _compare("float32", atol=1e-4)


def test_bf16_compute_matches_flax():
    """bf16 compute, fp32 weights (config3's ``model.dtype``). Measured max
    |diff| at these shapes: 4.8e-7 (fp32 outputs: encoder after its final
    fp32 LayerNorm, CTC logits, decoder log-probs), i.e. both packages
    round to bf16 at the same places; one bf16 ulp at 1.0 is 7.8e-3. The
    bound leaves room for summation order only."""
    _compare("bfloat16", atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ctc_logits_only_and_greedy_match(dtype):
    from metaasr_tpu.decode.greedy import ctc_greedy_decode as jax_greedy
    from metaasr_tpu_torch.decode.greedy import ctc_greedy_decode

    fm, params, pm, feats, lens = flax_and_port(dtype)
    logits, out_lens = fm.apply({"params": params}, jnp.asarray(feats),
                                jnp.asarray(lens), False,
                                method=fm.ctc_logits_only)
    with torch.no_grad():
        plogits, plens = pm.ctc_logits_only(torch.from_numpy(feats),
                                            torch.from_numpy(lens))
    np.testing.assert_allclose(plogits.numpy(), np.asarray(logits), atol=1e-4,
                               rtol=0)
    ids, n = jax_greedy(logits, out_lens)
    pids, pn = ctc_greedy_decode(torch.tensor(np.asarray(logits)), plens)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(n))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(ids))


def test_greedy_left_packs_with_ties_first_index():
    """argmax ties take the first maximum, like jnp.argmax."""
    from metaasr_tpu.decode.greedy import ctc_greedy_decode as jax_greedy
    from metaasr_tpu_torch.decode.greedy import ctc_greedy_decode

    rng = np.random.default_rng(1)
    logits = rng.integers(0, 3, (3, 12, 5)).astype(np.float32)  # many ties
    lens = np.array([12, 7, 1], np.int32)
    ids, n = jax_greedy(jnp.asarray(logits), jnp.asarray(lens))
    pids, pn = ctc_greedy_decode(torch.from_numpy(logits), torch.from_numpy(lens))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(n))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(ids))
