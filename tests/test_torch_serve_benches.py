"""Port vs reference: the serving benches (``metaasr_tpu_torch/scripts/
{serve,batcher}_bench.py`` against ``scripts/{serve,batcher}_bench.py``)
and what they need from ``serve/``.

- The constants, read from the reference scripts with ``ast``; the bench
  configs (flagship and ``--tiny``) equal the reference's ``Config`` as its
  scripts build it; the requests are the reference's numpy draws, byte for
  byte.
- ``pack_decode_outputs`` equals the reference's on the same outputs byte
  for byte, and the round trip is bit-exact, ``NEG`` scores included.
- A feature-mode bundle the port writes (``write_bundle(from_feats=True)``,
  beam and greedy) serves the texts and scores of a direct decode of the
  same features, with and without the run's config.
- ``_load_leg`` on a tiny CPU ``ServingDecoder`` for 1.5 s: every request
  completes, the percentiles follow the reference's index rule and
  ``mean_group`` its arithmetic; ``serve_bench.measure`` end to end at
  tiny width; the records' keys and arithmetic from injected timings; the
  no-card exits.
"""

import ast
import dataclasses
import json
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.config import Config as RefConfig
from metaasr_tpu.data.tokenizer import CharTokenizer as RefChars
from metaasr_tpu.serve.export import pack_decode_outputs as ref_pack
from metaasr_tpu.serve.export import unpack_decode_outputs as ref_unpack
from metaasr_tpu_torch.decode.beam_search import NEG
from metaasr_tpu_torch.scripts import batcher_bench as bb
from metaasr_tpu_torch.scripts import serve_bench as sb
from metaasr_tpu_torch.serve import (
    DynamicBatcher,
    ServingDecoder,
    pack_decode_outputs,
    unpack_decode_outputs,
)
from metaasr_tpu_torch.serve.export import (
    beam_config_from_train,
    decode_features,
    load_bundle_params,
    read_decoded,
)
from metaasr_tpu_torch.task import ASRTask
from metaasr_tpu_torch.weights import flax_to_state_dict
from tests.test_torch_decode_bench import reference_ast, reference_constants

# runtime backends a bundle does not record (serve/export.py)
UNRECORDED_MODEL_KEYS = ("ctc_impl", "lstm_impl")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the search is ~10^5
    small ops a decode, and with the suite's workers sharing the cores
    torch's thread pool only waits on them (full-vocab scoring ran ~200x
    slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_constants_match_the_reference():
    ref = reference_constants("serve_bench.py")
    assert (sb.T_FEAT, sb.BSZ, sb.BATCHES, sb.STEPS) == (
        ref["T_FEAT"], ref["BSZ"], ref["BATCHES"], ref["STEPS"])
    ref = reference_constants("batcher_bench.py")
    assert (bb.T_FEAT, bb.BSZ) == (ref["T_FEAT"], ref["BSZ"])
    assert ref["STEPS"] == sb.STEPS    # the batcher's bundle is serve_bench's


def _reference_config(tiny: bool):
    """The reference scripts' Config (serve_bench.main; batcher_bench's
    _build_bundle with and without --tiny), verbatim."""
    tok = RefChars.ascii_default()
    cfg = RefConfig()
    cfg.model.arch = "transformer"
    cfg.model.vocab_size = tok.vocab_size
    if tiny:
        cfg.model.d_model, cfg.model.num_heads = 32, 2
        cfg.model.d_ff = 64
        cfg.model.num_encoder_layers, cfg.model.num_decoder_layers = 2, 2
        cfg.model.dtype = "float32"
        cfg.train.beam_size = 3
        cfg.data.max_tokens = 8
        cfg.train.beam_min_len = 8
    else:
        cfg.model.d_model, cfg.model.num_heads = 256, 4
        cfg.model.d_ff = 2048
        cfg.model.num_encoder_layers, cfg.model.num_decoder_layers = 12, 6
        cfg.model.dtype = "bfloat16"
        cfg.data.max_tokens = 48
        cfg.train.beam_size = 10
        cfg.train.beam_min_len = 48
    cfg.model.dropout = 0.0
    return cfg


def test_bench_config_is_the_reference_scripts():
    cfg, tok = sb.bench_config()
    ref = _reference_config(tiny=False)
    for section in ("model", "data", "train", "frontend"):
        assert dataclasses.asdict(getattr(cfg, section)) \
            == dataclasses.asdict(getattr(ref, section)), section
    assert tok.vocab_size == RefChars.ascii_default().vocab_size


def test_batcher_flagship_bundle_is_the_reference_spec(monkeypatch):
    """The flagship config and buckets _build_bundle writes (the weights
    are not drawn: numpy draws of 27 M parameters are not what this
    checks)."""
    monkeypatch.setattr(
        bb, "write_seeded_bundle",
        lambda d, cfg, tok, buckets: {"cfg": cfg, "buckets": buckets})
    got = bb._build_bundle("unused", tiny=False)
    ref = _reference_config(tiny=False)
    for section in ("model", "data", "train"):
        assert dataclasses.asdict(getattr(got["cfg"], section)) \
            == dataclasses.asdict(getattr(ref, section)), section
    assert got["buckets"] == ((1, 400), (4, 400), (16, 400))


def test_batcher_tiny_bundle_is_the_reference_spec(tmp_path):
    """--tiny's bundle: the reference's buckets, feature mode, its model
    and its beam options."""
    meta = bb._build_bundle(str(tmp_path), tiny=True)
    ref = _reference_config(tiny=True)
    assert meta["from_feats"] and meta["mode"] == "beam"
    assert meta["buckets"] == [[1, 400], [4, 400], [16, 400]]
    want = {k: v for k, v in dataclasses.asdict(ref.model).items()
            if k not in UNRECORDED_MODEL_KEYS}
    assert meta["model"] == want
    assert meta["beam"]["beam_size"] == 3
    assert meta["beam"]["max_len"] == meta["beam"]["min_len"] == 8


def test_requests_are_the_reference_draws():
    """serve_bench.main's draws: the init batch, then the requests."""
    vocab = RefChars.ascii_default().vocab_size
    rng = np.random.default_rng(0)
    rng.standard_normal((2, 400, 80))
    rng.integers(1, vocab - 1, (2, 8))
    want = [[np.asarray(rng.standard_normal((400, 80)), np.float32)
             for _ in range(16)] for _ in range(3)]
    got = sb.draw_batches(vocab, 3)
    assert len(got) == 3 and all(len(b) == 16 for b in got)
    for gb, wb in zip(got, want):
        assert [g.tobytes() for g in gb] == [w.tobytes() for w in wb]


def _decode_outputs(seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 30, (3, 4, 7))
    lengths = rng.integers(0, 8, (3, 4))
    scores = (10 * rng.standard_normal((3, 4))).astype(np.float32)
    scores[0, 1:] = NEG
    scores[2, 3] = -0.0
    return tokens, lengths, scores


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_matches_the_reference_byte_for_byte(seed):
    tokens, lengths, scores = _decode_outputs(seed)
    ref = np.asarray(ref_pack({"tokens": jnp.asarray(tokens, jnp.int32),
                               "lengths": jnp.asarray(lengths, jnp.int32),
                               "scores": jnp.asarray(scores)}))
    # the port's search gives int64 tokens and lengths
    got = pack_decode_outputs({"tokens": torch.from_numpy(tokens),
                               "lengths": torch.from_numpy(lengths),
                               "scores": torch.from_numpy(scores)})
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    assert got.numpy().tobytes() == ref.tobytes()
    want = ref_unpack(ref)
    for packed in (got, got.numpy()):
        back = unpack_decode_outputs(packed)
        np.testing.assert_array_equal(back["tokens"], tokens)
        np.testing.assert_array_equal(back["lengths"], lengths)
        assert back["scores"].dtype == np.float32
        assert back["scores"].tobytes() == scores.tobytes()
        for k in ("tokens", "lengths", "scores"):
            assert back[k].tobytes() == np.asarray(want[k]).tobytes(), k


FLAGSHIP_CONFIG = sb.bench_config


def _tiny_bench_config():
    cfg, tok = FLAGSHIP_CONFIG()
    m = cfg.model
    m.d_model, m.num_heads, m.d_ff = 32, 2, 64
    m.num_encoder_layers, m.num_decoder_layers = 2, 2
    m.dtype = "float32"
    cfg.train.beam_size = 3
    cfg.data.max_tokens = cfg.train.beam_min_len = 8
    return cfg, tok


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_feature_bundle_serves_the_direct_decode(mode, tmp_path):
    cfg, tok = _tiny_bench_config()
    meta = sb.write_seeded_bundle(str(tmp_path), cfg, tok, [(2, 40)])
    if mode == "greedy":   # the same weights, written as a greedy bundle
        from metaasr_tpu_torch.serve import write_bundle

        tree = load_bundle_params(str(tmp_path / "params.npz"))
        meta = write_bundle(str(tmp_path), cfg, tree, tok, [(2, 40)],
                            mode="greedy", from_feats=True)
    assert meta["from_feats"] and meta["mode"] == mode
    rng = np.random.default_rng(3)
    feats = [rng.standard_normal((40, 80)).astype(np.float32)
             for _ in range(2)]
    task = ASRTask(cfg, tok.sos_eos_id, device="cpu")
    model = task.build_model()
    model.load_state_dict(flax_to_state_dict(
        load_bundle_params(str(tmp_path / "params.npz"))))
    out = decode_features(task, model, torch.from_numpy(np.stack(feats)),
                          torch.full((2,), 40, dtype=torch.int32), mode,
                          beam_config_from_train(cfg))
    want = read_decoded(out, 2, tok, nbest=2)
    if mode == "beam":
        assert out["lengths"].min() == 8      # the forced length held
    for dec in (ServingDecoder(str(tmp_path), device="cpu"),
                ServingDecoder(str(tmp_path), cfg, device="cpu")):
        assert dec.from_feats
        assert dec.transcribe(feats, nbest=2) == want
        with pytest.raises(ValueError):
            dec.transcribe_files(["unused.wav"])


@pytest.fixture(scope="module")
def tiny_decoder():
    with tempfile.TemporaryDirectory() as d:
        bb._build_bundle(d, tiny=True)
        dec = ServingDecoder(d, device="cpu")
    for b, _ in dec.buckets:
        dec.transcribe([np.zeros((400, 80), np.float32)] * b)
    return dec


def test_load_leg_on_a_tiny_cpu_decoder(tiny_decoder):
    lat = []
    with DynamicBatcher(tiny_decoder, max_wait_ms=10.0) as batcher:
        batcher.submit(np.zeros((400, 80), np.float32)).result(timeout=60)
        b0 = dict(batcher.stats)
        row = bb._load_leg(batcher, 4.0, 1.5, np.random.default_rng(0),
                           latencies=lat)
        stats = dict(batcher.stats)
    ref_fn = next(n for n in reference_ast("batcher_bench.py").body
                  if getattr(n, "name", None) == "_load_leg")
    ref_keys = {k.value for n in ref_fn.body if isinstance(n, ast.Return)
                for k in n.value.keys}
    assert set(row) == ref_keys
    assert row["sent"] >= 1 and row["completed"] == row["sent"] == len(lat)
    assert lat == sorted(lat)

    def pct(p):   # batcher_bench.py's rule, verbatim
        return round(1e3 * lat[min(len(lat) - 1, int(p / 100 * len(lat)))],
                     1)

    assert [row["p50_ms"], row["p95_ms"], row["p99_ms"]] == [
        pct(50), pct(95), pct(99)]
    batches = stats["batches"] - b0["batches"]
    assert row["batches"] == batches >= 1
    assert row["mean_group"] == round(
        (stats["requests"] - b0["requests"]) / max(batches, 1), 2)
    assert row["offered_utts_per_sec"] == 4.0


def test_serve_bench_measure_at_tiny_width(monkeypatch):
    monkeypatch.setattr(sb, "bench_config", _tiny_bench_config)
    monkeypatch.setattr(sb, "BSZ", 2)
    r = sb.measure(batches=1, device="cpu")
    assert r["sync_pipelined_texts_equal"] is True
    assert r["batches"] == 1 and r["batch"] == 2
    assert 0 < r["bf16_params_npz_mb"] < r["params_npz_mb"]


def _record_keys():
    """The keys of the record serve_bench.main prints (the dict literal
    holding "mode")."""
    keys = set()
    for n in ast.walk(reference_ast("serve_bench.py")):
        if isinstance(n, ast.Dict):
            ks = {k.value for k in n.keys if hasattr(k, "value")}
            if "mode" in ks:
                keys |= ks
    return keys


def test_serve_record_from_injected_timings():
    r = sb.record(8, t_sync=13.0, t_pipe=12.5, t_pipe16=12.0,
                  npz_bytes=108_462_320, npz16_bytes=54_231_160)
    assert set(r) == _record_keys()
    n = 16 * 8
    assert r == {"mode": "exported-bundle serving", "batch": 16,
                 "batches": 8, "beam": 10, "steps": 48,
                 "sync_utts_per_sec": round(n / 13.0, 1),
                 "pipelined_utts_per_sec": round(n / 12.5, 1),
                 "pipelined_speedup": round(13.0 / 12.5, 2),
                 "bf16_pipelined_utts_per_sec": round(n / 12.0, 1),
                 "bf16_vs_fp32_weights": round(12.5 / 12.0, 2),
                 "params_npz_mb": round(108_462_320 / 1e6, 1),
                 "bf16_params_npz_mb": round(54_231_160 / 1e6, 1)}


@pytest.mark.parametrize("mod,argv", [(sb, []), (bb, []), (bb, ["--tiny"]),
                                      (bb, ["--loads", "2,4", "--secs",
                                            "5"])])
def test_no_card_exit(mod, argv, capsys):
    assert not torch.cuda.is_available()
    assert mod.main(argv) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["bench"] == mod.__name__.rsplit(".", 1)[1]
    assert "no CUDA" in line["error"]


def test_serve_package_reexports():
    import metaasr_tpu_torch.serve as serve
    from metaasr_tpu_torch.serve import batcher, export

    assert serve.__all__ == ["DynamicBatcher", "ServingDecoder",
                             "pack_decode_outputs", "unpack_decode_outputs",
                             "write_bundle"]
    assert serve.DynamicBatcher is batcher.DynamicBatcher
    for name in serve.__all__[1:]:
        assert getattr(serve, name) is getattr(export, name)
    assert os.path.basename(serve.__file__) == "__init__.py"

