"""Port vs reference: the shallow-fusion LSTM LM (``models/lm.py``).

``LSTMLM``'s sequence mode (the recurrence through ``lstm_recurrence``: its
plain version on the CPU) and step mode against the reference's
``__call__``/``step`` at the same Flax weights, ``lm_nll``, the npz both
ways, ``train_char_lm``'s batch stream and one Adam step against
``jax.value_and_grad(lm_nll)`` + ``optax.adam``, and
``scripts/train_lm.py`` end to end. Bars: logits 1e-5 (the reference's own
scan/step bar, ``tests/test_lm_fusion.py:53``), NLL rtol 1e-5, one step's
loss, gradients and updated weights 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metaasr_tpu.models import lm as ref_lm
from metaasr_tpu.train.checkpoint import load_params_npz as ref_load_npz
from metaasr_tpu.train.checkpoint import save_params_npz as ref_save_npz
from metaasr_tpu_torch.models import lm
from metaasr_tpu_torch.train.checkpoint import load_params_npz, save_tree_npz
from metaasr_tpu_torch.weights import (
    flax_to_lm_state_dict,
    lm_state_dict_to_flax,
)

TOL = 1e-5


def _ref_lm(vocab=7, embed=8, hidden=12, layers=2, seed=0):
    model = ref_lm.LSTMLM(vocab_size=vocab, embed_dim=embed, hidden=hidden,
                          layers=layers)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 2), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _port_steps(model, toks):
    state = model.init_state(toks.shape[0])
    out = []
    for t in range(toks.shape[1]):
        logits, state = model.step(_t(toks[:, t: t + 1]), state)
        out.append(logits)
    return torch.stack(out, 1).detach().numpy()


@pytest.mark.parametrize("dims", [(7, 8, 12, 2), (9, 6, 10, 3),
                                  (30, 16, 16, 1)])
def test_forward_and_step_match_reference(dims):
    vocab, embed, hidden, layers = dims
    ref, params = _ref_lm(vocab, embed, hidden, layers, seed=1)
    port = lm.lm_from_flax(params)
    toks = _tokens(vocab, (3, 6), seed=2)
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = port(_t(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    state = ref.init_state(3)
    steps = []
    for t in range(6):
        logits, state = ref.apply({"params": params}, jnp.asarray(
            toks[:, t: t + 1]), state, method=ref.step)
        steps.append(np.asarray(logits))
    with torch.no_grad():
        np.testing.assert_allclose(_port_steps(port, toks),
                                   np.stack(steps, 1), rtol=TOL, atol=TOL)
    assert port.init_state(4)["h"].shape == (4, layers, hidden)


def test_scan_step_parity():
    """The port's own two call surfaces over one set of weights."""
    model = lm.LSTMLM(11, 8, 12, 2,
                      generator=torch.Generator().manual_seed(3)).eval()
    toks = _tokens(11, (4, 7), seed=4)
    with torch.no_grad():
        np.testing.assert_allclose(model(_t(toks)).numpy(),
                                   _port_steps(model, toks), rtol=TOL,
                                   atol=TOL)


def test_init_is_seeded_and_orthogonal():
    a = lm.LSTMLM(30, 16, 24, 2, generator=torch.Generator().manual_seed(5))
    b = lm.LSTMLM(30, 16, 24, 2, generator=torch.Generator().manual_seed(5))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
        assert v.is_contiguous() and v.dtype == torch.float32
    u = a.recurrent_1
    torch.testing.assert_close(u @ u.T, torch.eye(24), rtol=0, atol=1e-5)
    assert int(torch.count_nonzero(a.input_proj_0.bias)) == 0


@pytest.mark.parametrize("lens", [(3, 5), (0, 5), (5, 5)])
def test_lm_nll_matches_reference(lens):
    ref, params = _ref_lm(vocab=7, seed=6)
    toks = _tokens(7, (2, 5), seed=7)
    lens = np.asarray(lens, np.int32)
    want = float(ref_lm.lm_nll(ref, params, jnp.asarray(toks),
                               jnp.asarray(lens), 6))
    got = lm.lm_nll(lm.lm_from_flax(params), None, _t(toks), _t(lens), 6)
    np.testing.assert_allclose(float(got.detach()), want, rtol=TOL)


def test_lm_dims_from_params():
    _, params = _ref_lm(vocab=9, embed=6, hidden=10, layers=3)
    want = {"vocab_size": 9, "embed_dim": 6, "hidden": 10, "layers": 3}
    assert lm.lm_dims_from_params(params) == want
    assert ref_lm.lm_dims_from_params(params) == want
    port = lm.LSTMLM(**want)
    assert lm.lm_dims_from_params(
        lm_state_dict_to_flax(port.state_dict())) == want


def test_npz_round_trip_both_ways(tmp_path):
    """A port-written npz loads in the reference (load_params_npz +
    lm_dims_from_params + apply) with the port's logits, and a
    reference-written one in the port."""
    toks = _tokens(9, (2, 4), seed=8)
    port = lm.LSTMLM(9, 6, 12, 2, generator=torch.Generator().manual_seed(9))
    save_tree_npz(str(tmp_path / "port.npz"),
                  lm_state_dict_to_flax(port.state_dict()))
    loaded = ref_load_npz(str(tmp_path / "port.npz"))
    ref = ref_lm.LSTMLM(**ref_lm.lm_dims_from_params(loaded))
    with torch.no_grad():
        np.testing.assert_allclose(
            np.asarray(ref.apply({"params": loaded}, jnp.asarray(toks))),
            port(_t(toks)).numpy(), rtol=TOL, atol=TOL)

    ref, params = _ref_lm(vocab=9, embed=6, hidden=10, layers=3, seed=10)
    ref_save_npz(str(tmp_path / "ref.npz"), params)
    back = lm.lm_from_flax(load_params_npz(str(tmp_path / "ref.npz")))
    with torch.no_grad():
        np.testing.assert_allclose(
            back(_t(toks)).numpy(),
            np.asarray(ref.apply({"params": params}, jnp.asarray(toks))),
            rtol=TOL, atol=TOL)
    sd = flax_to_lm_state_dict(params)
    assert all(v.is_contiguous() and v.dtype == torch.float32
               for v in sd.values())


class _Tokenizer:
    """A char tokenizer of 12 symbols (sos/eos 11), the same in both
    packages' calls."""
    vocab_size = 12
    sos_eos_id = 11

    @staticmethod
    def encode(text):
        return np.asarray([1 + (ord(c) % 10) for c in text], np.int32)


TEXTS = ["abc", "hello", "", "xyzzy plugh", "aa", "lmnop", "q"]


def test_batch_index_stream_matches_reference(monkeypatch):
    """Both packages draw each step's rows with the reference's
    ``np.random.default_rng(seed).integers``: the recorded draws agree."""
    draws = {}
    real = np.random.default_rng

    class Recorder:
        def __init__(self, seed, log):
            self._rng, self._log = real(seed), log

        def integers(self, *args, **kw):
            out = self._rng.integers(*args, **kw)
            self._log.append(np.array(out))
            return out

    for who, fn in (("ref", ref_lm.train_char_lm), ("port", lm.train_char_lm)):
        log = draws[who] = []
        monkeypatch.setattr(np.random, "default_rng",
                            lambda seed, log=log: Recorder(seed, log))
        fn(TEXTS, _Tokenizer(), embed_dim=4, hidden=8, layers=1, steps=4,
           batch_size=4, seed=3)
        monkeypatch.setattr(np.random, "default_rng", real)
    assert len(draws["port"]) == 4
    for a, b in zip(draws["port"], draws["ref"], strict=True):
        np.testing.assert_array_equal(a, b)


def test_train_step_matches_reference():
    """One step at identical weights: loss, gradients and the Adam update
    against jax.value_and_grad(lm_nll) + optax.adam(lr)."""
    ref, params = _ref_lm(vocab=12, embed=8, hidden=12, layers=2, seed=11)
    toks = _tokens(11, (4, 6), seed=12)
    lens = np.asarray([6, 2, 0, 4], np.int32)
    lr = 3e-2
    opt = optax.adam(lr)
    (loss, grads) = jax.value_and_grad(lambda p: ref_lm.lm_nll(
        ref, p, jnp.asarray(toks), jnp.asarray(lens), 11))(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    want_new = optax.apply_updates(params, updates)

    model = lm.lm_from_flax(params)
    p = {k: v.detach().clone().requires_grad_()
         for k, v in model.named_parameters()}
    port_opt = lm.lm_optimizer(lr)
    new, _, got_loss, got_grads = lm.lm_train_step(
        model, port_opt, p, port_opt.init(p), _t(toks), _t(lens), 11)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=TOL)
    want_g = flax_to_lm_state_dict(jax.tree.map(np.asarray, grads))
    want_p = flax_to_lm_state_dict(jax.tree.map(np.asarray, want_new))
    for k in p:
        np.testing.assert_allclose(got_grads[k].numpy(), want_g[k].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_allclose(new[k].detach().numpy(),
                                   want_p[k].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_train_char_lm_learns_and_returns_its_weights():
    """30 steps lower the corpus NLL below the seeded start's, and the
    returned weights are the model's."""
    enc = [_Tokenizer.encode(t) for t in TEXTS if t]
    toks = np.zeros((len(enc), max(map(len, enc))), np.int64)
    for i, e in enumerate(enc):
        toks[i, :len(e)] = e
    lens = _t([len(e) for e in enc])
    start = lm.LSTMLM(12, 8, 12, 2, generator=torch.Generator().manual_seed(0))
    model, params, nll = lm.train_char_lm(
        TEXTS, _Tokenizer(), embed_dim=8, hidden=12, layers=2, steps=30,
        batch_size=8, lr=3e-2, seed=0)
    with torch.no_grad():
        before = float(lm.lm_nll(start, None, _t(toks), lens, 11))
        after = float(lm.lm_nll(model, None, _t(toks), lens, 11))
    assert np.isfinite(nll) and after < before
    assert all(torch.equal(model.state_dict()[k], v)
               for k, v in params.items())
    with pytest.raises(ValueError, match="empty"):
        lm.train_char_lm(["", ""], _Tokenizer(), steps=1)


def test_train_lm_script_end_to_end(tmp_path, synthetic_data_dir):
    """The CLI script on the CPU: corpus without the held-out accent,
    training, an npz both packages read."""
    from metaasr_tpu.data.dataset import Manifest
    from metaasr_tpu_torch.scripts import train_lm

    out = str(tmp_path / "lm.npz")
    path = train_lm.main(["--config", "configs/config3_fomaml.yaml",
                          "--out", out, "--steps", "5", "--hidden", "8",
                          "--embed-dim", "4", "--layers", "1",
                          "--device", "cpu",
                          "-o", f"data.data_dir={synthetic_data_dir}",
                          "-o", "data.heldout_accents=delta"])
    assert path == out
    for loaded in (load_params_npz(out), ref_load_npz(out)):
        dims = lm.lm_dims_from_params(loaded)
        assert dims == {"vocab_size": 30, "embed_dim": 4, "hidden": 8,
                        "layers": 1}
    texts = train_lm.lm_corpus(synthetic_data_dir, ("delta",))
    delta = {u.text for u in Manifest.load(
        os.path.join(synthetic_data_dir, "delta.jsonl")).utts}
    others = {u.text for a in ("alpha", "bravo", "echo")
              for u in Manifest.load(os.path.join(
                  synthetic_data_dir, f"{a}.jsonl")).utts}
    assert (delta - others).isdisjoint(texts) and set(texts) == others


def test_train_lm_defaults_to_cuda_without_fallback(synthetic_data_dir):
    from metaasr_tpu_torch.scripts import train_lm

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for a machine without")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_lm.main(["--config", "configs/config3_fomaml.yaml",
                       "--steps", "1",
                       "-o", f"data.data_dir={synthetic_data_dir}"])
