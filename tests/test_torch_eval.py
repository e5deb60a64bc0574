"""Port vs reference: the meta-test path of the meta trainer.

``MetaASRTrainer.decode`` (greedy CTC and the joint beam search, with its
hypothesis dumps), ``support_query_split`` and ``eval_heldout`` of
``metaasr_tpu_torch.train.meta_train`` against ``metaasr_tpu.train.
meta_train`` on the tiny transformer (d 32, 2 heads, 2 + 2 layers, beam 3)
over a synthetic corpus that both packages generate from one seed, with the
port's seeded weights carried across by ``weights.py``. Dropout 0,
SpecAugment off and dither 0, so the adaptation's ``train=True`` draws
nothing in either package. Then the port alone: ``average_checkpoints``
against a float64 mean of what is on disk, and ``meta_train``'s
``eval_every`` branch (best checkpoint, stale evaluations, early stop, a
resume that keeps ``best``).
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from metaasr_tpu.cli import make_trainer as ref_make_trainer
from metaasr_tpu.data import sampler as ref_sampler
from metaasr_tpu.data import synthetic as ref_synthetic
from metaasr_tpu_torch import cli
from metaasr_tpu_torch.data import sampler, synthetic
from metaasr_tpu_torch.meta.maml import wrap_lr
from metaasr_tpu_torch.train.checkpoint import (
    CheckpointManager,
    average_checkpoints,
)
from metaasr_tpu_torch.weights import params_to_flax
from tests.test_m2_models import tiny_cfg
from tests.test_torch_meta import port_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ACCENTS = ("alpha", "bravo", "echo", "delta")
SCORE_RTOL = 1e-4


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    ref_dir = str(tmp_path_factory.mktemp("ref_corpus"))
    dir_ = str(tmp_path_factory.mktemp("port_corpus"))
    # the held-out accent's first 7 utterances: 5,008 - 16,276 samples, so
    # decode's batches of 4 pad to two waveform buckets (32,000, 16,000)
    kw = dict(accents=ACCENTS, utts_per_accent=10, words_per_utt=(1, 3),
              seed=5)
    ref_synthetic.generate_dataset(ref_dir, **kw)
    synthetic.generate_dataset(dir_, **kw)
    return ref_dir, dir_


def eval_cfg(data_dir: str):
    """The reference's tiny transformer as a meta-test run: k = 2 support
    utterances, 2 adaptation steps, beam 3, batches of 4."""
    cfg = tiny_cfg("transformer", vocab=30)
    cfg.frontend.dither = 0.0
    m = cfg.meta
    m.algo, m.k_support, m.k_query, m.tasks_per_batch = "fomaml", 2, 2, 2
    m.adapt_steps, m.inner_lr = 2, 0.05
    d = cfg.data
    d.data_dir, d.heldout_accents, d.batch_size = data_dir, ("delta",), 4
    d.max_frames, d.max_tokens = 200, 16
    t = cfg.train
    t.beam_size, t.eval_support_draws, t.eval_max_utts = 3, 2, 4
    return cfg


@pytest.fixture(scope="module")
def trainers(corpora, tmp_path_factory):
    """(reference trainer, port trainer, reference params, port params)
    at the same weights."""
    ref_dir, dir_ = corpora
    ref, _ = ref_make_trainer(eval_cfg(ref_dir),
                              str(tmp_path_factory.mktemp("ref_wd")))
    port, _ = cli.make_trainer(port_cfg(eval_cfg(dir_)),
                               str(tmp_path_factory.mktemp("port_wd")),
                               device="cpu")
    params = port.init_state()["params"]
    return ref, port, params_to_flax(params, num_heads=2), params


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _assert_same_dump(got_path, want_path):
    got, want = _records(got_path), _records(want_path)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert (g["hyp"], g["ref"]) == (w["hyp"], w["ref"])
        if "score" in w:
            np.testing.assert_allclose(g["score"], w["score"],
                                       rtol=SCORE_RTOL)
        if "nbest" in w:
            assert [h["hyp"] for h in g["nbest"]] == \
                [h["hyp"] for h in w["nbest"]]
            np.testing.assert_allclose([h["score"] for h in g["nbest"]],
                                       [h["score"] for h in w["nbest"]],
                                       rtol=SCORE_RTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_support_query_split_matches_reference(trainers, seed):
    ref, port, _, _ = trainers
    cap, u = port._num_samples_cap(), port.cfg.data.max_tokens
    want, want_idx = ref_sampler.support_query_split(
        ref.heldout_datasets["delta"], 2, cap, u, seed=seed)
    got, got_idx = sampler.support_query_split(
        port.heldout_datasets["delta"], 2, cap, u, seed=seed)
    assert got_idx == want_idx
    assert got["texts"] == want["texts"]
    for k, v in want.items():
        if k != "texts":
            np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_decode_matches_reference(trainers, tmp_path, mode):
    """Zero-shot decode of the held-out accent in batches of 4 and 3, each
    padded to its own waveform bucket: texts exact, WER/CER equal, the
    3-best lists' hypotheses exact and scores to 1e-4."""
    ref, port, ref_params, params = trainers
    ds_ref, ds = ref.heldout_datasets["delta"], port.heldout_datasets["delta"]
    want = ref.decode(ref_params, ds_ref, max_utts=7, mode=mode,
                      dump_path=str(tmp_path / "want.jsonl"), dump_nbest=3)
    got = port.decode(params, ds, max_utts=7, mode=mode,
                      dump_path=str(tmp_path / "got.jsonl"), dump_nbest=3)
    _assert_same_dump(tmp_path / "got.jsonl", tmp_path / "want.jsonl")
    assert got == want
    recs = _records(tmp_path / "got.jsonl")
    assert len(recs) == 7
    if mode == "beam":
        assert all(len(r["nbest"]) == 3 and r["nbest"][0]["hyp"] == r["hyp"]
                   and math.isfinite(r["score"]) for r in recs)
    else:
        assert all(r.keys() == {"hyp", "ref"} for r in recs)


def test_eval_heldout_matches_reference(trainers):
    """k-shot adaptation + beam decode, two support draws: the same keys
    and the same values (the hypotheses are equal, so the WER/CER are
    exactly equal)."""
    ref, port, ref_params, params = trainers
    want = ref.eval_heldout(ref_params)
    got = port.eval_heldout(params)
    assert set(got) == {"heldout_delta_wer", "heldout_delta_cer",
                        "heldout_delta_wer_std", "heldout_wer_mean"}
    assert got == want


def test_eval_heldout_without_heldout_accents(trainers):
    _, port, _, params = trainers
    held = port.heldout_datasets
    port.heldout_datasets = {}
    try:
        assert port.eval_heldout(params) == {"heldout_wer_mean": 1.0}
    finally:
        port.heldout_datasets = held


# ---------------- average_checkpoints ----------------

def _random_params(rng, meta_sgd: bool):
    model = {"a.weight": torch.from_numpy(rng.standard_normal((3, 4))
                                          .astype(np.float32)),
             "b.bias": torch.from_numpy(rng.standard_normal(5)
                                        .astype(np.float32))}
    return wrap_lr(model, float(rng.uniform(0.01, 0.1))) if meta_sgd \
        else model


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: v})
    return out


@pytest.mark.parametrize("meta_sgd", [False, True])
def test_average_checkpoints_is_the_float64_mean(tmp_path, meta_sgd):
    """The mean of what is on disk: keep 3 of 4 saved steps, so last 2
    averages steps 3 and 4, last 5 the three kept; the Meta-SGD tree is
    averaged whole."""
    rng = np.random.default_rng(7)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    saved = {}
    for step in range(1, 5):
        saved[step] = _random_params(rng, meta_sgd)
        mgr.save(step, {"params": saved[step], "step": step})
    assert mgr.all_steps() == [2, 3, 4]
    for last_n, steps in ((2, [3, 4]), (5, [2, 3, 4]), (0, [2, 3, 4])):
        got = average_checkpoints(mgr, last_n=last_n)
        assert got.keys() == saved[4].keys()
        got_flat = _flat(got)
        for k, v in got_flat.items():
            want = np.mean([_flat(saved[s])[k].numpy().astype(np.float64)
                            for s in steps], axis=0)
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=1e-7)
    got = average_checkpoints(mgr, steps=[2])
    for k, v in _flat(got).items():
        assert torch.equal(v, _flat(saved[2])[k])


def test_average_checkpoints_raises_without_checkpoints(tmp_path):
    with pytest.raises(ValueError, match="no checkpoints to average"):
        average_checkpoints(CheckpointManager(str(tmp_path)), last_n=2)


# ---------------- meta_train's eval_every branch ----------------

def _scripted_trainer(dir_, workdir, wers, patience=0):
    """A port trainer that evaluates every 2 steps, checkpoints every 3
    steps that it does not evaluate, and scores its evaluations from
    ``wers`` in turn (the evaluation itself is held against the reference
    above)."""
    cfg = port_cfg(eval_cfg(dir_))
    cfg.train.eval_every, cfg.train.ckpt_every = 2, 3
    cfg.train.log_every, cfg.train.keep_ckpts = 1, 10
    cfg.train.early_stop_patience = patience
    trainer, _ = cli.make_trainer(cfg, workdir, device="cpu")
    script = iter(wers)
    calls = []

    def fake_eval(params):
        calls.append({k: v.clone() for k, v in params.items()})
        return {"heldout_delta_wer": (w := next(script)),
                "heldout_wer_mean": w}

    trainer.eval_heldout = fake_eval
    return trainer, calls


def test_eval_every_tracks_best_and_stops_early(corpora, tmp_path):
    _, dir_ = corpora
    trainer, calls = _scripted_trainer(dir_, str(tmp_path),
                                       [0.6, 0.4, 0.5, 0.45, 0.3],
                                       patience=2)
    state = trainer.meta_train(max_steps=20)
    # evaluations at steps 2, 4, 6, 8: best at 4, then 2 stale -> stop at 8
    assert len(calls) == 4 and state["step"] == 8
    assert state["best_metric"] == 0.4 and state["stale_evals"] == 2
    best = trainer.ckpt.restore_best()
    assert best["step"] == 4
    for k, v in calls[1].items():
        assert torch.equal(best["params"][k], v)
    with open(tmp_path / "ckpts" / "best" / "metrics.json") as f:
        assert json.load(f)["heldout_wer_mean"] == 0.4
    assert trainer.ckpt.all_steps() == [2, 3, 4, 6, 8]
    with open(tmp_path / "ckpts" / "step_6.metrics.json") as f:
        assert json.load(f)["heldout_wer_mean"] == 0.5
    with open(tmp_path / "logs" / "scalars.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "early_stop" in r] == [8]
    assert [r["heldout_wer_mean"] for r in recs
            if "heldout_wer_mean" in r] == [0.6, 0.4, 0.5, 0.45]


def test_resume_keeps_the_best_checkpoint(corpora, tmp_path):
    """The best metric lives in the checkpointed state: a resumed run whose
    first evaluation is worse leaves ``best`` as it was, and a better one
    replaces it."""
    _, dir_ = corpora
    first, _ = _scripted_trainer(dir_, str(tmp_path), [0.5])
    first.meta_train(max_steps=2)
    best = first.ckpt.restore_best()
    assert best["step"] == 2 and best["best_metric"] == 0.5
    resumed, calls = _scripted_trainer(dir_, str(tmp_path), [0.7, 0.2])
    state = resumed.meta_train(max_steps=4)
    assert len(calls) == 1 and state["best_metric"] == 0.5
    assert state["stale_evals"] == 1
    kept = resumed.ckpt.restore_best()
    assert kept["step"] == 2
    for k, v in best["params"].items():
        assert torch.equal(kept["params"][k], v)
    state = resumed.meta_train(max_steps=6)
    assert resumed.ckpt.restore_best()["step"] == 6
    assert state["best_metric"] == 0.2 and state["stale_evals"] == 0
    assert os.path.exists(tmp_path / "ckpts" / "best" / "metrics.json")
