"""Port vs reference: the CTC prefix scorer and the batched joint beam search
(the cases of tests/test_m4_beam.py), tokens and lengths exact, scores to
1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.decode import beam_search as ref_bs
from metaasr_tpu.models.transformer import TransformerASR as FlaxTransformer
from metaasr_tpu_torch.decode import beam_search as bs
from metaasr_tpu_torch.models.transformer import TransformerASR
from metaasr_tpu_torch.weights import flax_to_state_dict
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

VOCAB = 8
EOS = VOCAB - 1


def _models(seed=0, bsz=2, t_feat=35):
    """The tiny model of test_m4_beam.py in both packages, same weights."""
    dims = dict(d_model=16, num_heads=2, d_ff=32, num_encoder_layers=1,
                num_decoder_layers=2)
    fm = FlaxTransformer(vocab_size=VOCAB, dropout=0.0, **dims)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((bsz, t_feat, 80)).astype(np.float32)
    lens = np.array([t_feat, t_feat - 12][:bsz], np.int32)
    tokens = rng.integers(1, EOS, (bsz, 4)).astype(np.int32)
    params = fm.init(jax.random.PRNGKey(seed), jnp.asarray(feats),
                     jnp.asarray(lens),
                     jnp.pad(jnp.asarray(tokens), ((0, 0), (1, 0)),
                             constant_values=EOS),
                     jnp.array([5, 5][:bsz]))["params"]
    pm = TransformerASR(VOCAB, **dims).eval()
    pm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    return fm, params, pm, feats, lens


def _assert_same_search(got, ref):
    ref = {k: np.asarray(v) for k, v in ref.items()}
    np.testing.assert_array_equal(got["lengths"].numpy(), ref["lengths"])
    np.testing.assert_array_equal(got["finished"].numpy(), ref["finished"])
    for b in range(ref["lengths"].shape[0]):
        for j in range(ref["lengths"].shape[1]):
            n = ref["lengths"][b, j]
            np.testing.assert_array_equal(got["tokens"][b, j, :n].numpy(),
                                          ref["tokens"][b, j, :n])
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                               rtol=1e-3, atol=1e-3)


SEARCHES = {
    "full_vocab": dict(beam_size=3, max_len=5, ctc_weight=0.3),
    "pruned_all": dict(beam_size=3, max_len=5, ctc_weight=0.3,
                       ctc_candidates=VOCAB - 2),
    "pruned_2": dict(beam_size=2, max_len=5, ctc_weight=0.3,
                     ctc_candidates=2),
    "coverage": dict(beam_size=3, max_len=5, ctc_weight=0.3,
                     coverage_weight=0.05, coverage_tau=0.1),
    "min_len": dict(beam_size=3, max_len=6, ctc_weight=0.3, min_len=4),
    "normalize_final": dict(beam_size=3, max_len=5, ctc_weight=0.3,
                            normalize_final=True),
    "length_penalty": dict(beam_size=3, max_len=8, ctc_weight=0.5,
                           length_penalty=0.4),
    "beam1_att_only": dict(beam_size=1, max_len=6, ctc_weight=0.0),
}


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_beam_search_matches_reference(name):
    fm, params, pm, feats, lens = _models()
    kw = SEARCHES[name]
    ref = ref_bs.beam_search_transformer(fm, params, jnp.asarray(feats),
                                         jnp.asarray(lens), EOS,
                                         ref_bs.BeamSearchConfig(**kw))
    with torch.no_grad():
        got = bs.beam_search_transformer(pm, torch.from_numpy(feats),
                                         torch.from_numpy(lens), EOS,
                                         bs.BeamSearchConfig(**kw))
    _assert_same_search(got, ref)


@pytest.mark.parametrize("cand", [False, True])
def test_ctc_prefix_step_matches_reference(cand):
    rng = np.random.default_rng(4)
    bsz, t_len, k = 2, 9, 3
    logits = rng.standard_normal((bsz, t_len, VOCAB)).astype(np.float32)
    logp = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
    enc_lens = np.array([9, 6], np.int32)
    r_nb = rng.standard_normal((bsz, k, t_len)).astype(np.float32) - 3.0
    r_b = rng.standard_normal((bsz, k, t_len)).astype(np.float32) - 3.0
    r_nb[0, 1] = bs.NEG                                     # a dead row
    last = np.array([[2, 5, 2], [1, 1, EOS]], np.int32)
    empty = np.array([[False, False, True], [False, True, False]])
    c = (np.sort(rng.permuted(np.tile(np.arange(1, VOCAB), (bsz, k, 1)),
                              axis=2)[:, :, :4], axis=2).astype(np.int32)
         if cand else None)
    ref = ref_bs.ctc_prefix_step(jnp.asarray(logp), jnp.asarray(enc_lens),
                                 jnp.asarray(r_nb), jnp.asarray(r_b),
                                 jnp.asarray(last), jnp.asarray(empty), 0,
                                 cand=None if c is None else jnp.asarray(c))
    got = bs.ctc_prefix_step(torch.from_numpy(logp),
                             torch.from_numpy(enc_lens).long(),
                             torch.from_numpy(r_nb), torch.from_numpy(r_b),
                             torch.from_numpy(last).long(),
                             torch.from_numpy(empty), 0,
                             cand=None if c is None
                             else torch.from_numpy(c).long())
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-4)
    init = ref_bs.ctc_prefix_init(jnp.asarray(logp), jnp.asarray(enc_lens), k, 0)
    pinit = bs.ctc_prefix_init(torch.from_numpy(logp),
                               torch.from_numpy(enc_lens).long(), k, 0)
    for g, r in zip(pinit, init):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_topk_breaks_ties_like_lax_top_k():
    x = np.array([[1.0, 3.0, 3.0, bs.NEG, 3.0, 2.0, bs.NEG, 2.0],
                  [bs.NEG] * 8], np.float32)
    vals, idx = bs._topk(torch.from_numpy(x), 5)
    rvals, ridx = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))


@pytest.mark.parametrize("vocab,req", [(30, 0), (128, 0), (563, 0), (563, -1),
                                       (563, 40), (30, 99)])
def test_effective_ctc_candidates_matches(vocab, req):
    assert (bs.effective_ctc_candidates(vocab, req)
            == ref_bs.effective_ctc_candidates(vocab, req))

