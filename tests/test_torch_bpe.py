"""Port vs reference: the BPE tokenizer (``metaasr_tpu_torch/data/bpe.py``
against ``metaasr_tpu/data/bpe.py``).

Training gives the same base symbols and the same merges in the same order
(exact), encode/decode give the same ids and texts on every utterance, the
vocabulary JSON written by either package loads in the other, the CLI's
``build_tokenizer`` with ``data.vocab=bpe`` writes the reference's file,
and BPE serving bundles cross between the packages: one the reference
exported is served by the port with the reference's texts, one the port
wrote serves on the CPU and its tokenizer loads in the reference.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest

from metaasr_tpu import cli as ref_cli
from metaasr_tpu.config import Config as RefConfig
from metaasr_tpu.data import bpe as ref_bpe
from metaasr_tpu.serve import ExportSpec, export_bundle
from metaasr_tpu.serve import ServingDecoder as RefDecoder
from metaasr_tpu.serve.export import _load_tokenizer as ref_load_tokenizer
from metaasr_tpu.train.task import ASRTask as RefTask
from metaasr_tpu_torch import cli
from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.data import bpe
from metaasr_tpu_torch.data.synthetic import generate_dataset
from metaasr_tpu_torch.data.tokenizer import _BaseTokenizer
from metaasr_tpu_torch.serve.export import ServingDecoder, write_bundle
from tests.test_m2_models import tiny_cfg
from tests.test_torch_serve import _assert_same, _port_cfg, _waves

# tests/test_m0_substrate.py::test_bpe_tokenizer's corpus
SMALL_CORPUS = ["the cat sat on the mat", "the cat ran", "a cat and the mat",
                "the the the cat cat"] * 5


@pytest.fixture(scope="module")
def bpe_corpus(tmp_path_factory):
    """The synthetic corpus of the ``bpe`` profile (the big lexicon): its
    directory and its texts."""
    d = str(tmp_path_factory.mktemp("bpe_corpus"))
    generate_dataset(d, accents=("alpha", "bravo", "echo"),
                     utts_per_accent=40, words_per_utt=(2, 5), seed=0,
                     write_wavs=False, profile="bpe")
    return d, cli._corpus_texts(d, "text")


def _corpora(bpe_corpus):
    return {"small": (SMALL_CORPUS, 30), "synthetic_bpe": (bpe_corpus[1], 200)}


@pytest.mark.parametrize("name", ["small", "synthetic_bpe"])
def test_train_bpe_matches_reference(bpe_corpus, name):
    texts, merges = _corpora(bpe_corpus)[name]
    base, got = bpe.train_bpe(texts, merges)
    want_base, want = ref_bpe.train_bpe(texts, merges)
    assert base == want_base
    assert got == want
    # the synthetic corpus runs all 200 merges; the small one stops at the
    # frequency floor
    assert (len(got) == 200) == (name == "synthetic_bpe")
    tok = bpe.BPETokenizer.from_corpus(texts, merges)
    ref = ref_bpe.BPETokenizer.from_corpus(texts, merges)
    assert tok.symbols == ref.symbols and tok.merges == ref.merges
    assert (tok.vocab_size, tok.blank_id, tok.sos_eos_id) == (
        ref.vocab_size, ref.blank_id, ref.sos_eos_id)


@pytest.mark.parametrize("name", ["small", "synthetic_bpe"])
def test_encode_decode_match_reference(bpe_corpus, name):
    texts, merges = _corpora(bpe_corpus)[name]
    tok = bpe.BPETokenizer.from_corpus(texts, merges)
    ref = ref_bpe.BPETokenizer.from_corpus(texts, merges)
    # an unseen word and a blank, sos/eos and negative id on the decode side
    for text in [*texts, "zebra cat", ""]:
        ids = tok.encode(text)
        want = ref.encode(text)
        assert ids.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(ids, want)
        assert tok.decode(ids) == ref.decode(want)
        if text in texts:
            assert tok.decode(ids) == text
    ids = [0, *tok.encode(texts[0]).tolist(), tok.sos_eos_id, -1]
    assert tok.decode(ids) == ref.decode(ids) == texts[0]


def test_vocab_json_loads_across_packages(bpe_corpus, tmp_path):
    texts = bpe_corpus[1]
    tok = bpe.BPETokenizer.from_corpus(texts)
    ref = ref_bpe.BPETokenizer.from_corpus(texts)
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    tok.save(ours)
    ref.save(theirs)
    with open(ours) as f, open(theirs) as g:
        assert f.read() == g.read()
    assert ref_bpe.BPETokenizer.load(ours) == ref
    assert bpe.BPETokenizer.load(theirs) == tok
    # the port's generic loader dispatches on the recorded type
    assert _BaseTokenizer.load(theirs) == tok


def test_build_tokenizer_bpe_writes_the_reference_vocabulary(bpe_corpus,
                                                             tmp_path):
    src = bpe_corpus[0]
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    for d in (ours, theirs):
        shutil.copytree(src, d)
    cfg, ref_cfg = Config(), RefConfig()
    cfg.data.vocab = ref_cfg.data.vocab = "bpe"
    cfg.data.data_dir, ref_cfg.data.data_dir = ours, theirs
    tok = cli.build_tokenizer(cfg)
    ref = ref_cli.build_tokenizer(ref_cfg)
    with open(os.path.join(ours, "vocab_bpe.json")) as f, \
            open(os.path.join(theirs, "vocab_bpe.json")) as g:
        assert f.read() == g.read()
    assert isinstance(tok, bpe.BPETokenizer) and tok.symbols == ref.symbols
    assert len(tok.merges) == 200
    # a second call loads the saved file, including one the reference wrote
    os.remove(os.path.join(ours, "vocab_bpe.json"))
    shutil.copy(os.path.join(theirs, "vocab_bpe.json"), ours)
    assert cli.build_tokenizer(cfg) == tok


@pytest.fixture(scope="module")
def bpe_bundles(bpe_corpus, tmp_path_factory):
    """A tiny transformer over a 30-merge BPE vocabulary: the reference's
    exported bundle (CPU programs) and the port's bundle of the same
    weights."""
    texts = bpe_corpus[1]
    ref_tok = ref_bpe.BPETokenizer.from_corpus(texts, num_merges=30)
    cfg = tiny_cfg("transformer", vocab=ref_tok.vocab_size)
    cfg.data.vocab = "bpe"
    cfg.data.max_tokens = 8
    cfg.train.beam_size = 3
    task = RefTask(cfg, ref_tok.sos_eos_id)
    rng = np.random.default_rng(0)
    batch = {"audio": 0.1 * rng.standard_normal((2, 8000)).astype(np.float32),
             "audio_lens": np.array([8000, 5000], np.int32),
             "tokens": rng.integers(1, ref_tok.vocab_size - 1,
                                    (2, 6)).astype(np.int32),
             "token_lens": np.array([6, 4], np.int32)}
    params = jax.tree.map(np.asarray, task.init_params(
        jax.random.PRNGKey(0), jax.tree.map(jax.numpy.asarray, batch)))
    theirs = str(tmp_path_factory.mktemp("ref_bpe_bundle"))
    export_bundle(cfg, params, ref_tok, theirs,
                  spec=ExportSpec(buckets=((2, 6000), (3, 8000)),
                                  platforms=("cpu",)))
    ours = str(tmp_path_factory.mktemp("port_bpe_bundle"))
    tok = bpe.BPETokenizer.from_corpus(texts, num_merges=30)
    write_bundle(ours, _port_cfg(cfg), params, tok, ((2, 6000), (3, 8000)))
    return cfg, tok, theirs, ours


def test_reference_bpe_bundle_serves_in_the_port(bpe_bundles):
    cfg, tok, theirs, _ = bpe_bundles
    dec = ServingDecoder(theirs, _port_cfg(cfg), device="cpu")
    assert dec.tokenizer == tok
    waves = _waves(5)
    _assert_same(dec.transcribe(waves, nbest=2),
                 RefDecoder(theirs).transcribe(waves, nbest=2))


def test_port_bpe_bundle_serves_and_loads_in_the_reference(bpe_bundles):
    cfg, tok, theirs, ours = bpe_bundles
    with open(os.path.join(ours, "meta.json")) as f:
        meta = json.load(f)
    assert meta["vocab_kind"] == "bpe" and meta["vocab_size"] == tok.vocab_size
    assert ref_load_tokenizer(ours, meta["vocab_kind"]) == \
        ref_load_tokenizer(theirs, "bpe")
    # the port's bundle records its config: served without one, it decodes
    # as the reference's bundle of the same weights does
    dec = ServingDecoder(ours, device="cpu")
    assert dec.tokenizer == tok
    waves = _waves(6, (7000, 3000))
    got = dec.transcribe(waves)
    _assert_same(got, ServingDecoder(theirs, _port_cfg(cfg),
                                     device="cpu").transcribe(waves))
    assert all(isinstance(r["text"], str) for r in got)
