"""Port vs reference: the decode bench (``metaasr_tpu_torch/scripts/
decode_bench.py`` against ``scripts/decode_bench.py``).

- The constants, read from the reference script with ``ast`` (importing it
  sets JAX's compilation cache and ``sys.path``).
- The inputs: ``_setup``'s feats, lens and tokens and the pipelined row's
  further batches are the reference's numpy draws, byte for byte.
- One forced-length decode per row configuration at tiny width (d 32, 2
  heads, 2 + 2 layers, fp32, beam 3, B 2; 400 frames, 48 forced steps): the
  reference's Flax weights (``PRNGKey(0)`` on the reference's draws; the LM
  ``PRNGKey(1)``) carried into the bench's model through ``weights.py``, the
  port's search against the reference's ``beam_search_transformer``: tokens
  and lengths exact, scores at ``tests/test_torch_beam.py``'s bar (rtol =
  atol = 1e-3), every hypothesis 48 tokens long. Plain and LM-fused at
  vocab 30; vocab 512 with 40 and with -1 (all) CTC candidates.
- The rows' keys are the reference's and their arithmetic its own, from
  injected timings; the repeat rule; the packed read-back check; the
  no-card exit.
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.decode import beam_search as ref_bs
from metaasr_tpu.models.lm import LSTMLM as RefLM
from metaasr_tpu.models.transformer import TransformerASR as RefModel
from metaasr_tpu_torch.scripts import decode_bench as db
from metaasr_tpu_torch.weights import flax_to_lm_state_dict, flax_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"d_model": 32, "num_heads": 2, "d_ff": 64, "num_encoder_layers": 2,
        "num_decoder_layers": 2}
TINY_LM = {"embed_dim": 8, "hidden": 16, "layers": 2}
SCORE_TOL = 1e-3        # tests/test_torch_beam.py:49


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


def reference_ast(name: str) -> ast.Module:
    with open(os.path.join(REPO, "scripts", name)) as f:
        return ast.parse(f.read())


def reference_constants(name: str) -> dict:
    """Top-level ``NAME = <literal>`` assignments of a reference script."""
    out = {}
    for node in reference_ast(name).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def reference_keys(name: str, func: str) -> set:
    """Every string key a reference function puts in a dict: dict literals
    and ``out["key"] = ...`` assignments."""
    fn = next(n for n in ast.walk(reference_ast(name))
              if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Dict):
            keys |= {k.value for k in n.keys
                     if isinstance(k, ast.Constant) and isinstance(k.value,
                                                                   str)}
        if isinstance(n, ast.Assign) and isinstance(n.targets[0],
                                                    ast.Subscript):
            sl = n.targets[0].slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                keys.add(sl.value)
    return keys


def test_constants_match_the_reference():
    ref = reference_constants("decode_bench.py")
    assert {k: ref[k] for k in ("VOCAB", "T_FEAT", "AUDIO_SEC", "STEPS")} \
        == {"VOCAB": db.VOCAB, "T_FEAT": db.T_FEAT,
            "AUDIO_SEC": db.AUDIO_SEC, "STEPS": db.STEPS}
    assert db.MODEL == {"d_model": 256, "num_heads": 4, "d_ff": 2048,
                        "num_encoder_layers": 12, "num_decoder_layers": 6,
                        "dtype": "bfloat16"}
    assert db.LM == {"embed_dim": 128, "hidden": 256, "layers": 2}


def _reference_draws(bsz, vocab):
    """scripts/decode_bench.py:_setup's draws, verbatim but for numpy."""
    rng = np.random.default_rng(0)
    eos = vocab - 1
    feats = np.asarray(rng.standard_normal((bsz, 400, 80)), np.float32)
    lens = np.full((bsz,), 400, np.int32)
    toks = np.asarray(rng.integers(1, eos, (bsz, 8)), np.int32)
    return feats, lens, toks


@pytest.mark.parametrize("bsz,vocab", [(16, 30), (64, 30), (4, 512)])
def test_inputs_are_the_reference_draws(bsz, vocab):
    for got, want in zip(db.draw_inputs(bsz, vocab),
                         _reference_draws(bsz, vocab)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    rng = np.random.default_rng(1)      # measure_pipelined's further batches
    want = [np.asarray(rng.standard_normal((bsz, 400, 80)), np.float32)
            for _ in range(3)]
    got = db.pipelined_feats(bsz, 4)
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]


@pytest.fixture
def tiny_bench(monkeypatch):
    monkeypatch.setattr(db, "MODEL", {**TINY, "dtype": "float32"})
    monkeypatch.setattr(db, "LM", TINY_LM)
    return db


ROWS = {"plain": dict(vocab=30), "lm": dict(vocab=30, lm_weight=0.3),
        "bpe_c40": dict(vocab=512, ctc_candidates=40),
        "bpe_full": dict(vocab=512, ctc_candidates=-1)}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_forced_length_decode_matches_reference(name, tiny_bench):
    kw = ROWS[name]
    vocab, lm_weight = kw["vocab"], kw.get("lm_weight", 0.0)
    cand = kw.get("ctc_candidates", 0)
    bsz, beam = 2, 3
    feats, lens, toks = _reference_draws(bsz, vocab)
    eos = vocab - 1
    model = RefModel(vocab_size=vocab, dropout=0.0, dtype=jnp.float32, **TINY)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                        jnp.asarray(lens),
                        jnp.pad(jnp.asarray(toks), ((0, 0), (1, 0)),
                                constant_values=eos),
                        jnp.full((bsz,), 9, jnp.int32))["params"]
    lm_model = lm_params = None
    if lm_weight:
        lm_model = RefLM(vocab_size=vocab, **TINY_LM)
        lm_params = lm_model.init(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 2), jnp.int32))["params"]
    cfg = ref_bs.BeamSearchConfig(beam_size=beam, max_len=48, min_len=48,
                                  ctc_weight=0.3, lm_weight=lm_weight,
                                  ctc_candidates=cand)
    ref = ref_bs.beam_search_transformer(model, params, jnp.asarray(feats),
                                         jnp.asarray(lens), eos, cfg,
                                         lm_model=lm_model,
                                         lm_params=lm_params)
    ref = {k: np.asarray(v) for k, v in ref.items()}

    run = db.Decode(bsz, beam, lm_weight, vocab, cand, "cpu")
    assert run.cfg == ref_port_cfg(cfg)
    run.model.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, params)))
    if lm_weight:
        run.lm.load_state_dict(flax_to_lm_state_dict(
            jax.tree.map(np.asarray, lm_params)))
    out = run()
    got = {k: v.numpy() for k, v in out.items()}
    np.testing.assert_array_equal(ref["lengths"], db.STEPS)
    np.testing.assert_array_equal(got["lengths"], ref["lengths"])
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    np.testing.assert_array_equal(got["finished"], ref["finished"])
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    assert db.same_readback(out)


def ref_port_cfg(cfg):
    """The reference's search options as the port's dataclass."""
    from metaasr_tpu_torch.decode.beam_search import BeamSearchConfig

    return BeamSearchConfig(**{k: getattr(cfg, k) for k in
                               BeamSearchConfig.__dataclass_fields__})


def test_measure_runs_the_forced_length_on_the_cpu(tiny_bench):
    """measure end to end at tiny width: the reference's keys, every
    hypothesis 48 tokens long."""
    r = db.measure(2, beam=3, device="cpu")
    assert reference_keys("decode_bench.py", "measure") - {
        "lm_weight", "vocab", "ctc_candidates"} <= set(r)
    assert r["hyp_lengths"] == [48, 48] and r["decode_steps"] == 48


def test_rows_from_injected_timings():
    want = reference_keys("decode_bench.py", "measure")
    r = db.row(16, 10, 1.5, lm_weight=0.3, vocab=512, ctc_candidates=40)
    assert set(r) == want
    assert r == {"batch": 16, "beam": 10, "decode_steps": 48,
                 "ms_per_batch": round(1.5 * 1e3, 1),
                 "utts_per_sec": round(16 / 1.5, 1),
                 "rtf": round(1.5 / (16 * 4.0), 5), "lm_weight": 0.3,
                 "vocab": 512, "ctc_candidates": 40}
    assert set(db.row(16, 10, 1.5)) == want - {"lm_weight", "vocab",
                                               "ctc_candidates"}
    p = db.pipelined_row(16, 10, 8, dt_sync=12.0, dt_pipe=11.0,
                         dt_packed=10.5)
    assert set(p) == reference_keys("decode_bench.py", "measure_pipelined")
    assert p == {"batch": 16, "beam": 10, "decode_steps": 48,
                 "mode": "pipelined", "nbatches": 8,
                 "ms_per_batch": round(11.0 / 8 * 1e3, 1),
                 "utts_per_sec": round(8 * 16 / 11.0, 1),
                 "sync_read_utts_per_sec": round(8 * 16 / 12.0, 1),
                 "speedup_vs_sync_read": round(12.0 / 11.0, 2),
                 "packed_readback_utts_per_sec": round(8 * 16 / 10.5, 1),
                 "packed_vs_dict_readback": round(11.0 / 10.5, 2),
                 "rtf": round(11.0 / (8 * 16 * 4.0), 5)}


def test_median_of_three(monkeypatch):
    clock = iter([0.0, 3.0, 10.0, 11.0, 20.0, 22.0])
    monkeypatch.setattr(db.time, "perf_counter", lambda: next(clock))
    assert db.median3(lambda: None) == 2.0


def test_same_readback_of_int64_tokens_and_neg_scores():
    out = {"tokens": torch.tensor([[[3, 4, 0], [5, 0, 0]]]),
           "lengths": torch.tensor([[2, 1]]),
           "scores": torch.tensor([[-1.25, -1.0e9]])}
    assert db.same_readback(out)


@pytest.mark.parametrize("argv", [[], ["--bpe-only"]])
def test_no_card_exit(argv, capsys):
    assert not torch.cuda.is_available()
    assert db.main(argv) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["bench"] == "decode_bench" and "no CUDA" in line["error"]
