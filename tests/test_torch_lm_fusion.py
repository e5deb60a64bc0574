"""Port vs reference: LM shallow fusion in the joint beam search
(``decode/beam_search.py``). Each search runs in both packages with the
same decoder and an LM at the same weights (a Markov table, or the LSTM LM
carried across by ``weights.py``).

Bars: tokens and lengths exact; scores 1e-5 (rtol = atol), 1e-4 where the
LSTM LM's state is regathered over a whole search (the reference's own bar,
``tests/test_lm_fusion.py:237``). Bundles that carry an LM, the trainer and
the CLI are in ``tests/test_torch_lm_bundles.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.decode import beam_search as ref_bs
from metaasr_tpu.models import lm as ref_lm
from metaasr_tpu_torch.decode import beam_search as bs
from metaasr_tpu_torch.models import lm
from tests.test_m4_beam import _host_ctc_prefix_scores
from tests.test_torch_beam import EOS as T_EOS
from tests.test_torch_beam import _assert_same_search, _models
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _ref_lm(vocab, embed=6, hidden=8, layers=2, seed=0):
    model = ref_lm.LSTMLM(vocab_size=vocab, embed_dim=embed, hidden=hidden,
                          layers=layers)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 2), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _decoders(vocab, k, bsz=1, t_len=6, seed=0, uniform=True):
    """A decoder in both packages: uniform log-probs (all ranking weight on
    CTC and the LM), or a Markov table over the last token; CTC logits from
    a numpy seed. -> (ref step fn, ref caches, port step fn, port caches,
    enc_lens, ctc_logits as numpy)."""
    rng = np.random.default_rng(seed)
    table = (np.zeros((vocab, vocab), np.float32) if uniform
             else 2.0 * rng.standard_normal((vocab, vocab)).astype(np.float32))
    table = np.array(jax.nn.log_softmax(jnp.asarray(table), -1))
    ctc = rng.standard_normal((bsz, t_len, vocab)).astype(np.float32)
    enc_lens = np.full((bsz,), t_len, np.int32)

    def ref_step(tokens, step, caches):
        return jnp.asarray(table)[tokens[:, 0]], caches

    def port_step(tokens, step, caches):
        return torch.from_numpy(table)[tokens[:, 0]], caches

    return (ref_step, {"d": jnp.zeros((bsz * k, 1))}, port_step,
            [{"d": torch.zeros((bsz * k, 1))}], enc_lens, ctc)


def _chain_table(vocab, chain, strength=8.0):
    table = np.zeros((vocab, vocab), np.float32)
    for src, dst in chain.items():
        table[src, dst] = strength
    return np.array(jax.nn.log_softmax(jnp.asarray(table), -1))


def _run(which, dec, cfg_kw, eos, lm_kind=None, k=3):
    """One search in ``which`` package; ``lm_kind``: None, ("table", logp
    [V, V]) or ("lstm", (ref model, Flax params))."""
    ref_step, ref_caches, port_step, port_caches, enc_lens, ctc = dec
    if which == "ref":
        lm_fn = state = None
        if lm_kind and lm_kind[0] == "table":
            tab = jnp.asarray(lm_kind[1])
            lm_fn = lambda t, s: (tab[t[:, 0]], s + 1)  # noqa: E731
            state = jnp.zeros((k * len(enc_lens),), jnp.float32)
        elif lm_kind:
            model, params = lm_kind[1]
            lm_fn = ref_lm.make_lm_step_fn(model, params)
            state = model.init_state(k * len(enc_lens))
        out = ref_bs.batched_beam_search(
            ref_step, ref_caches, jnp.asarray(enc_lens), jnp.asarray(ctc),
            eos, ref_bs.BeamSearchConfig(beam_size=k, **cfg_kw),
            lm_step_fn=lm_fn, init_lm_state=state)
        return {key: np.asarray(v) for key, v in out.items()}
    lm_fn = state = None
    if lm_kind and lm_kind[0] == "table":
        tab = torch.from_numpy(lm_kind[1])
        lm_fn = lambda t, s: (tab[t[:, 0]], {"n": s["n"] + 1})  # noqa: E731
        state = {"n": torch.zeros(k * len(enc_lens))}
    elif lm_kind:
        model = lm.lm_from_flax(lm_kind[1][1])
        lm_fn = lm.make_lm_step_fn(model)
        state = model.init_state(k * len(enc_lens))
    with torch.no_grad():
        out = bs.batched_beam_search(
            port_step, port_caches, torch.from_numpy(enc_lens).long(),
            torch.from_numpy(ctc), eos, bs.BeamSearchConfig(beam_size=k,
                                                            **cfg_kw),
            lm_step_fn=lm_fn, init_lm_state=state)
    return {key: v.numpy() for key, v in out.items()}


def _assert_same(got, want, rtol):
    for key in ("tokens", "lengths", "finished"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=rtol,
                               atol=rtol)


def test_fusion_follows_lm_and_score_is_cumulative():
    """Uniform attention and ctc_weight 0: the LM alone ranks, the winner
    walks its chain, and the score is the cumulative LM log-prob (a
    per-step-only term would give another total)."""
    vocab, eos, k = 5, 4, 3
    dec = _decoders(vocab, k)
    table = _chain_table(vocab, {eos: 1, 1: 2, 2: 3, 3: eos})
    kw = dict(max_len=6, ctc_weight=0.0, lm_weight=0.7)
    got = _run("port", dec, kw, eos, ("table", table))
    _assert_same(got, _run("ref", dec, kw, eos, ("table", table)), 1e-5)
    assert got["lengths"][0, 0] == 3 and list(got["tokens"][0, 0, :3]) == \
        [1, 2, 3]
    lm_cum = table[eos, 1] + table[1, 2] + table[2, 3] + table[3, eos]
    np.testing.assert_allclose(got["scores"][0, 0],
                               4 * -np.log(vocab) + 0.7 * lm_cum, rtol=1e-5)


def test_zero_weight_is_noop():
    """lm_weight 0 with an LM attached is exactly the search without one."""
    vocab, eos, k = 5, 4, 3
    dec = _decoders(vocab, k)
    table = _chain_table(vocab, {eos: 1, 1: 2})
    kw = dict(max_len=6, ctc_weight=0.5)
    base = _run("port", dec, kw, eos)
    fused = _run("port", dec, kw, eos, ("table", table))
    for key in base:
        np.testing.assert_array_equal(fused[key], base[key])
    _assert_same(base, _run("ref", dec, kw, eos), 1e-5)


def test_lm_state_regathered_like_caches():
    """A real LSTM LM under fusion: the port's search equals the
    reference's, and the best finished hypothesis' score equals an
    independent rescore of exactly its tokens (a wrong parent gather or an
    unfrozen finished row would change the LM conditionals it saw)."""
    vocab, eos, k = 6, 5, 4
    ref_model, params = _ref_lm(vocab, seed=3)
    dec = _decoders(vocab, k)
    kw = dict(max_len=8, ctc_weight=0.3, lm_weight=0.9)
    got = _run("port", dec, kw, eos, ("lstm", (ref_model, params)), k=k)
    _assert_same(got, _run("ref", dec, kw, eos, ("lstm", (ref_model, params)),
                           k=k), 1e-4)
    base = _run("port", dec, kw, eos, k=k)
    assert not np.allclose(got["scores"], base["scores"])

    finished = got["finished"][0]
    assert finished.any()
    hyp = int(np.argmax(finished))
    length = int(got["lengths"][0, hyp])
    seq = [int(t) for t in got["tokens"][0, hyp, :length]]
    model = lm.lm_from_flax(params)
    step = lm.make_lm_step_fn(model)
    state, prev, lm_cum = model.init_state(1), eos, 0.0
    with torch.no_grad():
        for tok in seq + [eos]:
            logp, state = step(torch.tensor([[prev]]), state)
            lm_cum += float(logp[0, tok])
            prev = tok
    ctc_logp = np.asarray(jax.nn.log_softmax(dec[5], -1))[0]
    _, gamma = _host_ctc_prefix_scores(ctc_logp, int(dec[4][0]), seq)
    want = (0.7 * (length + 1) * -np.log(vocab) + 0.3 * gamma
            + 0.9 * lm_cum)
    np.testing.assert_allclose(got["scores"][0, hyp], want, rtol=1e-4)


@pytest.mark.parametrize("n_cand", [0, 4, 2])
def test_fused_search_matches_reference(n_cand):
    """A Markov-table decoder and the LSTM LM, full vocabulary and
    candidate-pruned (4 = every non-blank token but eos: equal to the full
    search; 2: a real cut), two utterances."""
    vocab, eos, k = 6, 5, 3
    ref_model, params = _ref_lm(vocab, seed=5)
    dec = _decoders(vocab, k, bsz=2, seed=6, uniform=False)
    kw = dict(max_len=6, ctc_weight=0.3, lm_weight=0.8,
              ctc_candidates=n_cand)
    lstm = ("lstm", (ref_model, params))
    got = _run("port", dec, kw, eos, lstm)
    _assert_same(got, _run("ref", dec, kw, eos, lstm), 1e-5)
    if n_cand == vocab - 2:
        full = _run("port", dec, dict(kw, ctc_candidates=0), eos, lstm)
        for key in ("tokens", "lengths"):
            np.testing.assert_array_equal(got[key], full[key])
        np.testing.assert_allclose(got["scores"], full["scores"], rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(beam_size=3, max_len=5, ctc_weight=0.3, lm_weight=0.5),
    dict(beam_size=2, max_len=6, ctc_weight=0.3, lm_weight=0.3,
         ctc_candidates=2, length_penalty=0.2),
    dict(beam_size=3, max_len=5, ctc_weight=0.3, lm_weight=0.4,
         coverage_weight=0.05, coverage_tau=0.1, min_len=2)],
    ids=["full", "pruned_lp", "coverage_min_len"])
def test_fused_transformer_search_matches_reference(kw):
    """``beam_search_transformer`` with ``lm_model`` on the tiny
    transformer of ``test_torch_beam.py`` against the reference's with
    ``lm_model``/``lm_params``."""
    fm, fparams, pm, feats, lens = _models()
    ref_model, params = _ref_lm(T_EOS + 1, embed=8, hidden=12, seed=7)
    want = ref_bs.beam_search_transformer(
        fm, fparams, jnp.asarray(feats), jnp.asarray(lens), T_EOS,
        ref_bs.BeamSearchConfig(**kw), lm_model=ref_model, lm_params=params)
    with torch.no_grad():
        got = bs.beam_search_transformer(
            pm, torch.from_numpy(feats), torch.from_numpy(lens), T_EOS,
            bs.BeamSearchConfig(**kw), lm_model=lm.lm_from_flax(params))
        base = bs.beam_search_transformer(
            pm, torch.from_numpy(feats), torch.from_numpy(lens), T_EOS,
            bs.BeamSearchConfig(**dict(kw, lm_weight=0.0)),
            lm_model=lm.lm_from_flax(params))
    _assert_same_search(got, want)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(got["scores"].numpy(), base["scores"].numpy())


def test_lm_weight_without_state_raises():
    vocab, eos, k = 5, 4, 3
    dec = _decoders(vocab, k)
    table = torch.from_numpy(_chain_table(vocab, {eos: 1}))
    with pytest.raises(ValueError, match="init_lm_state"):
        bs.batched_beam_search(
            dec[2], dec[3], torch.from_numpy(dec[4]).long(),
            torch.from_numpy(dec[5]), eos,
            bs.BeamSearchConfig(beam_size=k, max_len=4, lm_weight=0.5),
            lm_step_fn=lambda t, s: (table[t[:, 0]], s))
