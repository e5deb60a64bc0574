"""Port vs reference: serving bundles that carry a shallow-fusion LM.

Bundles the JAX package exported with an LM (``export_bundle(...,
lm_params=...)``, fp32 and bf16, the LM under ``__lm__`` in
``params.npz``) are served by the port's ``ServingDecoder(device="cpu")``
and by the JAX ``ServingDecoder``, also with hot-swapped adapted trees with
and without ``__lm__``; then the port's own LM bundles
(``write_bundle(..., lm_params=...)``). Texts exact; scores 1e-4 (the
serving bar), and 2e-3 for the bf16 bundle: the reference computes the LM's
first input projection in bf16 there (its embedding and kernel are bf16
leaves), the port in fp32 from the same bf16 values."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metaasr_tpu.data.tokenizer import CharTokenizer
from metaasr_tpu.models.lm import LSTMLM as RefLM
from metaasr_tpu.serve import ExportSpec, export_bundle
from metaasr_tpu.serve import ServingDecoder as RefDecoder
from metaasr_tpu.serve.export import _load_bundle_params
from metaasr_tpu.train.task import ASRTask as RefTask
from metaasr_tpu_torch.data.tokenizer import CharTokenizer as PortChars
from metaasr_tpu_torch.serve.export import (
    ServingDecoder,
    load_bundle_params,
    write_bundle,
)
from metaasr_tpu_torch.weights import split_lm
from tests.test_m2_models import tiny_cfg
from tests.test_torch_serve import _port_cfg, _waves

BUCKET = (3, 8000)
LM_WEIGHT = 0.5
TOL = {"float32": 1e-4, "bfloat16": 2e-3}


@pytest.fixture(scope="module")
def trees():
    """(run config, ASR params, LM params), the reference's trees."""
    tok = CharTokenizer.ascii_default()
    cfg = tiny_cfg("transformer", vocab=tok.vocab_size)
    cfg.data.max_tokens = 8
    cfg.train.beam_size = 3
    cfg.train.lm_weight = LM_WEIGHT
    rng = np.random.default_rng(0)
    batch = {"audio": 0.1 * rng.standard_normal((2, 8000)).astype(np.float32),
             "audio_lens": np.array([8000, 5000], np.int32),
             "tokens": rng.integers(1, 29, (2, 6)).astype(np.int32),
             "token_lens": np.array([6, 4], np.int32)}
    params = RefTask(cfg, tok.sos_eos_id).init_params(
        jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, batch))
    lm = RefLM(vocab_size=tok.vocab_size, embed_dim=8, hidden=12, layers=2)
    lm_params = lm.init(jax.random.PRNGKey(1),
                        jnp.zeros((1, 2), jnp.int32))["params"]
    # a peaked LM, so fusion moves the beam: scale the output projection
    lm_params = jax.tree.map(np.asarray, lm_params)
    lm_params["out_proj"]["kernel"] = 8.0 * lm_params["out_proj"]["kernel"]
    return cfg, jax.tree.map(np.asarray, params), lm_params


@pytest.fixture(scope="module")
def ref_bundles(trees, tmp_path_factory):
    cfg, params, lm_params = trees
    out = {}
    for wd in ("float32", "bfloat16"):
        out[wd] = str(tmp_path_factory.mktemp(wd))
        export_bundle(cfg, params, CharTokenizer.ascii_default(), out[wd],
                      spec=ExportSpec(buckets=(BUCKET,), platforms=("cpu",),
                                      weights_dtype=wd),
                      lm_params=lm_params)
    return out


def _assert_same(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["text"] == w["text"]
        np.testing.assert_allclose(g["score"], w["score"], rtol=tol, atol=tol)
        for gn, wn in zip(g.get("nbest", []), w.get("nbest", []),
                          strict=True):
            assert gn["hyp"] == wn["hyp"]
            np.testing.assert_allclose(gn["score"], wn["score"], rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("wd", ["float32", "bfloat16"])
def test_reference_lm_bundle_served_by_port(wd, trees, ref_bundles):
    cfg, params, lm_params = trees
    path = ref_bundles[wd]
    meta = json.loads(open(os.path.join(path, "meta.json")).read())
    assert meta["has_lm"] and meta["beam"]["lm_weight"] == LM_WEIGHT
    ref = RefDecoder(path)
    dec = ServingDecoder(path, _port_cfg(cfg), device="cpu")
    assert dec.lm is not None and dec.beam_cfg.lm_weight == LM_WEIGHT
    waves = _waves(1)
    got = dec.transcribe(waves, nbest=3)
    _assert_same(got, ref.transcribe(waves, nbest=3), TOL[wd])
    # the LM moves the search: unfused, the port's scores differ
    fused_lm, dec.lm = dec.lm, None
    assert any(abs(a["score"] - b["score"]) > 1e-3
               for a, b in zip(got, dec.transcribe(waves, nbest=3)))
    dec.lm = fused_lm
    # an adapted tree without __lm__ is served with the bundle's LM
    adapted = jax.tree.map(lambda a: np.asarray(a) + 0.01, params)
    _assert_same(dec.transcribe(waves, params=adapted, nbest=2),
                 ref.transcribe(waves, params=adapted, nbest=2), TOL[wd])
    # and a tree with its own __lm__ replaces it
    other = dict(adapted, __lm__=jax.tree.map(lambda a: 0.9 * a, lm_params))
    _assert_same(dec.transcribe(waves, params=other, nbest=2),
                 ref.transcribe(waves, params=other, nbest=2), TOL[wd])


def test_port_lm_bundle(trees, ref_bundles, tmp_path):
    """The port's LM bundle holds the reference's leaves and serves what
    the reference's bundle serves; hot swaps keep its LM; a greedy bundle
    refuses an LM and weight 0 stores none."""
    cfg, params, lm_params = trees
    pcfg = _port_cfg(cfg)
    out = str(tmp_path / "port")
    manifest = write_bundle(out, pcfg, params, PortChars.ascii_default(),
                            [BUCKET], lm_params=lm_params)
    assert manifest["has_lm"] and manifest["beam"]["lm_weight"] == LM_WEIGHT
    ours = load_bundle_params(os.path.join(out, "params.npz"))
    theirs = _load_bundle_params(os.path.join(ref_bundles["float32"],
                                              "params.npz"))
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(ours)] == [p for p, _ in flat(theirs)]
    for (_, a), (_, b) in zip(flat(ours), flat(theirs)):
        np.testing.assert_array_equal(a, np.asarray(b))
    asr, lm_tree = split_lm(ours)
    assert "__lm__" not in {k.split("/")[0] for k in asr}
    assert set(lm_tree) == set(lm_params)

    dec = ServingDecoder(out, device="cpu")
    ref_dec = ServingDecoder(ref_bundles["float32"], pcfg, device="cpu")
    waves = _waves(2)
    assert dec.transcribe(waves, nbest=2) == ref_dec.transcribe(waves,
                                                                 nbest=2)
    adapted = jax.tree.map(lambda a: np.asarray(a) - 0.01, params)
    _assert_same(dec.transcribe(waves, params=adapted),
                 RefDecoder(ref_bundles["float32"]).transcribe(
                     waves, params=adapted), TOL["float32"])

    with pytest.raises(ValueError, match="greedy"):
        write_bundle(str(tmp_path / "greedy"), pcfg, params,
                     PortChars.ascii_default(), [BUCKET], mode="greedy",
                     lm_params=lm_params)
    pcfg.train.lm_weight = 0.0
    off = write_bundle(str(tmp_path / "off"), pcfg, params,
                       PortChars.ascii_default(), [BUCKET],
                       lm_params=lm_params)
    assert not off["has_lm"] and off["beam"]["lm_weight"] == 0.0
    assert split_lm(load_bundle_params(
        str(tmp_path / "off" / "params.npz")))[1] is None
