"""Port vs reference: serving. Bundles exported by the JAX package
(``export_bundle(..., platforms=("cpu",))``) are served by the port's
``ServingDecoder(device="cpu")`` and by the JAX ``ServingDecoder``; texts
must agree exactly and scores to 1e-4."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from metaasr_tpu.data.tokenizer import CharTokenizer
from metaasr_tpu.serve import ExportSpec, export_bundle
from metaasr_tpu.serve import ServingDecoder as RefDecoder
from metaasr_tpu.train.task import ASRTask as RefTask
from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.serve.batcher import DynamicBatcher
from metaasr_tpu_torch.serve.export import (
    ServingDecoder,
    load_bundle_params,
    write_bundle,
)
from tests.test_m2_models import tiny_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = ((2, 6000), (3, 8000))


def _port_cfg(ref_cfg) -> Config:
    """The run's config as the port reads it (same dims and beam options)."""
    cfg = Config()
    for section in ("model", "frontend", "data", "train"):
        src, dst = getattr(ref_cfg, section), getattr(cfg, section)
        for k, v in vars(src).items():
            setattr(dst, k, v)
    return cfg


def _setup(tmp_path_factory, name, weights_dtype="float32", mode="beam",
           from_feats=False):
    tok = CharTokenizer.ascii_default()
    cfg = tiny_cfg("transformer", vocab=tok.vocab_size)
    cfg.data.max_tokens = 8
    cfg.train.beam_size = 3
    task = RefTask(cfg, tok.sos_eos_id)
    rng = np.random.default_rng(0)
    batch = {"audio": 0.1 * rng.standard_normal((2, 8000)).astype(np.float32),
             "audio_lens": np.array([8000, 5000], np.int32),
             "tokens": rng.integers(1, tok.vocab_size - 1, (2, 6)).astype(np.int32),
             "token_lens": np.array([6, 4], np.int32)}
    params = task.init_params(jax.random.PRNGKey(0),
                              jax.tree.map(jax.numpy.asarray, batch))
    out = str(tmp_path_factory.mktemp(name))
    buckets = ((2, 40), (3, 50)) if from_feats else BUCKETS
    export_bundle(cfg, params, tok, out,
                  spec=ExportSpec(buckets=buckets, platforms=("cpu",),
                                  weights_dtype=weights_dtype, mode=mode,
                                  from_feats=from_feats))
    return cfg, params, out


@pytest.fixture(scope="module")
def fp32_bundle(tmp_path_factory):
    return _setup(tmp_path_factory, "fp32")


@pytest.fixture(scope="module")
def bf16_bundle(tmp_path_factory):
    return _setup(tmp_path_factory, "bf16", weights_dtype="bfloat16")


def _waves(seed, lens=(8000, 5000, 3000)):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in lens]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["text"] == w["text"]
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-4, atol=1e-4)
        assert ("nbest" in g) == ("nbest" in w)
        for gn, wn in zip(g.get("nbest", []), w.get("nbest", [])):
            assert gn["hyp"] == wn["hyp"]
            np.testing.assert_allclose(gn["score"], wn["score"], rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("which", ["fp32", "bf16"])
def test_serving_matches_reference_bundle(which, fp32_bundle, bf16_bundle):
    cfg, params, path = fp32_bundle if which == "fp32" else bf16_bundle
    ref = RefDecoder(path)
    dec = ServingDecoder(path, _port_cfg(cfg), device="cpu")
    assert dec.weights_dtype == ("float32" if which == "fp32" else "bfloat16")
    for seed, lens in ((1, (8000, 5000, 3000)), (2, (5900,))):
        waves = _waves(seed, lens)
        _assert_same(dec.transcribe(waves, nbest=3),
                     ref.transcribe(waves, nbest=3))
    # hot-swapped adapted weights (fp32 trees; bf16 bundles round them)
    adapted = jax.tree.map(lambda a: np.asarray(a) + 0.01, params)
    waves = _waves(3)
    got = dec.transcribe(waves, params=adapted, nbest=2)
    _assert_same(got, ref.transcribe(waves, params=adapted, nbest=2))
    assert any(abs(g["score"] - b["score"]) > 1e-6
               for g, b in zip(got, dec.transcribe(waves, nbest=2)))


def test_hot_swap_converted_once_per_tree(fp32_bundle, monkeypatch):
    cfg, params, path = fp32_bundle
    dec = ServingDecoder(path, _port_cfg(cfg), device="cpu")
    calls = []
    real = dec._build_model
    monkeypatch.setattr(dec, "_build_model",
                        lambda tree: (calls.append(1), real(tree))[1])
    adapted = jax.tree.map(lambda a: np.asarray(a) + 0.01, params)
    waves = _waves(4, (4000, 2000))
    first = dec.transcribe(waves, params=adapted)
    assert dec.transcribe(waves, params=adapted) == first
    assert len(calls) == 1
    dec.transcribe(waves, params=jax.tree.map(lambda a: np.asarray(a) + 0.02,
                                              params))
    assert len(calls) == 2


def test_buckets_stream_and_batcher(fp32_bundle):
    cfg, _, path = fp32_bundle
    dec = ServingDecoder(path, _port_cfg(cfg), device="cpu")
    assert dec._pick_bucket(1, 5000) == (2, 6000)
    assert dec._pick_bucket(3, 5000) == (3, 8000)
    for n, width in ((4, 5000), (1, 9000)):
        with pytest.raises(ValueError):
            dec._pick_bucket(n, width)
    batches = [_waves(5, (8000, 4000)), _waves(6, (3000,))]
    sync = [dec.transcribe(b) for b in batches]
    assert list(dec.transcribe_stream(iter(batches))) == sync
    singles = _waves(7, (7000, 3000, 6500, 900))
    want = [dec.transcribe([w])[0] for w in singles]
    with DynamicBatcher(dec, max_wait_ms=20.0) as batcher:
        futs = batcher.submit_many(singles)
        too_wide = batcher.submit(np.zeros(9000, np.float32))
        got = [f.result(timeout=120) for f in futs]
        with pytest.raises(ValueError):
            too_wide.result(timeout=120)
    for g, w in zip(got, want):
        assert g["text"] == w["text"]
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-4,
                                   atol=1e-4)
    assert batcher.stats["requests"] == len(singles)


def test_greedy_bundle_matches_reference(tmp_path_factory):
    cfg, _, path = _setup(tmp_path_factory, "greedy", mode="greedy")
    waves = _waves(8)
    got = ServingDecoder(path, _port_cfg(cfg), device="cpu").transcribe(waves)
    _assert_same(got, RefDecoder(path).transcribe(waves))


def test_feature_bundle_matches_reference(tmp_path_factory):
    cfg, _, path = _setup(tmp_path_factory, "feats", from_feats=True)
    rng = np.random.default_rng(11)
    feats = [rng.standard_normal((n, 80)).astype(np.float32)
             for n in (50, 31, 44)]
    dec = ServingDecoder(path, _port_cfg(cfg), device="cpu")
    _assert_same(dec.transcribe(feats, nbest=2),
                 RefDecoder(path).transcribe(feats, nbest=2))
    with pytest.raises(ValueError):
        dec.transcribe_files(["unused.wav"])


def test_port_written_bundle_reads_in_both_packages(fp32_bundle, tmp_path):
    from metaasr_tpu.serve.export import _load_bundle_params
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer as PortChars

    cfg, params, path = fp32_bundle
    ref_dec = ServingDecoder(path, _port_cfg(cfg), device="cpu")
    for wd in ("float32", "bfloat16"):
        out = str(tmp_path / wd)
        write_bundle(out, _port_cfg(cfg), load_bundle_params(
            os.path.join(path, "params.npz")), PortChars.ascii_default(),
            BUCKETS, weights_dtype=wd)
        theirs = jax.tree.map(lambda a: np.asarray(a, np.float32),
                              _load_bundle_params(os.path.join(out, "params.npz")))
        ours = load_bundle_params(os.path.join(out, "params.npz"))
        flat = jax.tree_util.tree_leaves_with_path
        assert [p for p, _ in flat(theirs)] == [p for p, _ in flat(ours)]
        for (_, a), (_, b) in zip(flat(theirs), flat(ours)):
            np.testing.assert_array_equal(a, b)
        dec = ServingDecoder(out, _port_cfg(cfg), device="cpu")
        waves = _waves(9)
        if wd == "float32":  # same weights, same program
            assert dec.transcribe(waves) == ref_dec.transcribe(waves)
        else:
            assert len(dec.transcribe(waves)) == 3


def test_bundle_gates(fp32_bundle, tmp_path):
    cfg, _, path = fp32_bundle
    meta = json.loads(open(os.path.join(path, "meta.json")).read())
    # the version gate, and has_lm on a bundle without __lm__ leaves
    for name, edit, err in (
            ("v99", {"version": 99}, "version 99"),
            ("lm", {"has_lm": True}, "holds no __lm__ leaves")):
        d = tmp_path / name
        d.mkdir()
        for f in ("params.npz", "tokenizer.json"):
            (d / f).write_bytes(open(os.path.join(path, f), "rb").read())
        (d / "meta.json").write_text(json.dumps({**meta, **edit}))
        with pytest.raises(ValueError, match=err):
            ServingDecoder(str(d), _port_cfg(cfg), device="cpu")
    # a BPE vocabulary file loads as the BPE tokenizer it records
    bpe = tmp_path / "tok.json"
    bpe.write_text(json.dumps({"type": "BPETokenizer",
                               "symbols": ["\u2581a", "b", "\u2581ab"],
                               "merges": [["\u2581a", "b"]]}))
    from metaasr_tpu_torch.data.bpe import BPETokenizer
    from metaasr_tpu_torch.data.tokenizer import _BaseTokenizer

    tok = _BaseTokenizer.load(str(bpe))
    assert isinstance(tok, BPETokenizer) and tok.vocab_size == 5
    assert tok.encode("ab a").tolist() == [3, 1]


def test_default_device_is_cuda_without_fallback(fp32_bundle):
    cfg, _, path = fp32_bundle
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for a machine without")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingDecoder(path, _port_cfg(cfg))


def test_cli_serve_wav(fp32_bundle, tmp_path):
    from metaasr_tpu.data.audio_io import write_wav

    cfg, _, path = fp32_bundle
    waves = _waves(10, (6000, 2500))
    wavs = []
    for i, w in enumerate(waves):
        p = str(tmp_path / f"u{i}.wav")
        write_wav(p, w, rate=16000)
        wavs.append(p)
    cfg_path = str(tmp_path / "run.yaml")
    from metaasr_tpu_torch.config import save_config

    save_config(_port_cfg(cfg), cfg_path)
    out = str(tmp_path / "out.jsonl")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "metaasr_tpu_torch.cli", "--mode", "serve",
         "--bundle", path, "--config", cfg_path, "--device", "cpu",
         "--serve-out", out, "--wav", *wavs],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(x) for x in open(out)]
    want = RefDecoder(path).transcribe_files(wavs)
    assert [x["file"] for x in lines] == wavs
    _assert_same(lines, want)
