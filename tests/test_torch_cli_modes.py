"""The port's CLI modes: train (the default), adapt, test, transcribe,
export and serve.

First the port against the reference's CLI: a workdir of each package holds
one checkpoint of the same weights (the reference's, carried across by
``weights.py``) and the same recorded config (the tiny transformer of
``tests/test_torch_eval.py``); ``--mode test`` and ``--mode adapt`` write
the same results and the same hypothesis files. Then the port alone, on
the CPU: train (with held-out evaluation every 2 steps) -> adapt
``--use-best`` with 3-best beam dumps -> test ``--avg-last 2`` ->
transcribe -> export -> serve without ``--config``; the baseline's test and
transcribe (on manifests without transcripts); the refused flags and
modes; the default device.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from metaasr_tpu.cli import main as ref_main
from metaasr_tpu.cli import make_trainer as ref_make_trainer
from metaasr_tpu.config import save_config as ref_save_config
from metaasr_tpu.data import synthetic as ref_synthetic
from metaasr_tpu.train.task import ASRTask as RefTask
from metaasr_tpu_torch import cli
from metaasr_tpu_torch.config import save_config
from metaasr_tpu_torch.data import synthetic
from metaasr_tpu_torch.serve.export import ServingDecoder
from metaasr_tpu_torch.train.checkpoint import average_checkpoints
from metaasr_tpu_torch.weights import flax_to_params
from tests.test_torch_eval import eval_cfg
from tests.test_torch_meta import port_cfg
from tests.test_torch_serve import _setup as jax_bundle
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ACCENTS = ("alpha", "bravo", "echo", "delta")


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _results(workdir, mode):
    with open(os.path.join(workdir, f"{mode}_results.json")) as f:
        return json.load(f)


# ---------------- against the reference's CLI ----------------

@pytest.fixture(scope="module")
def workdirs(tmp_path_factory, monkeypatch_module):
    """A reference and a port workdir: the same corpus, config and
    weights, one checkpoint each."""
    ref_dir = str(tmp_path_factory.mktemp("ref_corpus"))
    dir_ = str(tmp_path_factory.mktemp("port_corpus"))
    kw = dict(accents=ACCENTS, utts_per_accent=10, words_per_utt=(1, 3),
              seed=5)
    ref_synthetic.generate_dataset(ref_dir, **kw)
    synthetic.generate_dataset(dir_, **kw)
    # the reference CLI builds an initial state as its restore template:
    # jitted, its tiny model's init takes 6 s instead of 16
    monkeypatch_module.setattr(
        RefTask, "init_params", jax.jit(RefTask.init_params,
                                        static_argnums=0))
    ref_wd = str(tmp_path_factory.mktemp("ref_wd"))
    ref_cfg = eval_cfg(ref_dir)
    ref_cfg.train.prng_impl = ref_cfg.train.compile_cache_dir = ""
    ref, _ = ref_make_trainer(ref_cfg, ref_wd)
    state = ref.init_state()
    ref.ckpt.save(1, state)
    ref.ckpt.wait()
    ref_save_config(ref_cfg, os.path.join(ref_wd, "config.yaml"))

    wd = str(tmp_path_factory.mktemp("port_wd"))
    cfg = port_cfg(eval_cfg(dir_))
    port, _ = cli.make_trainer(cfg, wd, device="cpu")
    port.ckpt.save(1, dict(port.init_state(), params=flax_to_params(
        jax.tree.map(np.asarray, state.params))))
    save_config(cfg, os.path.join(wd, "config.yaml"))
    return ref_wd, wd


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.mark.parametrize("mode", ["test", "adapt"])
def test_cli_modes_match_reference(workdirs, mode):
    """Greedy decode of the held-out accent, zero-shot (test) or after the
    2-step adaptation on the seed-0 support draw (adapt): the same results
    file and the same hypotheses."""
    ref_wd, wd = workdirs
    assert ref_main(["--mode", mode, "--workdir", ref_wd]) == 0
    assert cli.main(["--mode", mode, "--workdir", wd, "--device", "cpu"]) == 0
    want = _results(ref_wd, mode)
    assert list(want) == ["delta"]
    assert _results(wd, mode) == want
    assert _records(os.path.join(wd, "hyps_delta.jsonl")) == \
        _records(os.path.join(ref_wd, "hyps_delta.jsonl"))


# ---------------- the port's chain ----------------

SMALL = ["-o", "model.d_model=32", "-o", "model.num_heads=2",
         "-o", "model.d_ff=64", "-o", "model.num_encoder_layers=2",
         "-o", "model.num_decoder_layers=2", "-o", "model.dtype=float32",
         "-o", "model.dropout=0.0", "-o", "specaug.enabled=false",
         "-o", "meta.tasks_per_batch=2", "-o", "meta.k_support=2",
         "-o", "meta.k_query=2", "-o", "meta.inner_steps=1",
         "-o", "meta.adapt_steps=2",
         "-o", "data.max_frames=200", "-o", "data.max_tokens=16",
         "-o", "data.heldout_accents=delta",
         "-o", "optimizer.schedule=constant", "-o", "optimizer.lr=0.001",
         "-o", "train.eval_every=2", "-o", "train.eval_support_draws=2",
         "-o", "train.eval_max_utts=4", "-o", "train.beam_size=3",
         "-o", "train.log_every=1", "-o", "train.keep_ckpts=3"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """4 FOMAML steps through the CLI, with no --mode: (data dir, workdir,
    the recorded config's bytes)."""
    data = str(tmp_path_factory.mktemp("corpus"))
    synthetic.generate_dataset(data, accents=ACCENTS, utts_per_accent=8,
                               words_per_utt=(1, 2), seed=3)
    wd = str(tmp_path_factory.mktemp("wd"))
    assert cli.main(["--device", "cpu", "--data-dir", data, "--workdir", wd,
                     "--max-steps", "4", *SMALL]) == 0
    with open(os.path.join(wd, "config.yaml"), "rb") as f:
        return data, wd, f.read()


def _trainer(wd):
    from metaasr_tpu_torch.config import load_config

    return cli.make_trainer(load_config(os.path.join(wd, "config.yaml")),
                            wd, device="cpu")[0]


def test_mode_defaults_to_train(run):
    _, wd, _ = run
    trainer = _trainer(wd)
    assert trainer.ckpt.all_steps() == [2, 4]
    best = trainer.ckpt.restore_best()
    with open(os.path.join(wd, "logs", "scalars.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if "heldout_wer_mean" in r]
    assert [r["step"] for r in evals] == [2, 4]
    assert best["best_metric"] == min(r["heldout_wer_mean"] for r in evals)
    assert {"heldout_delta_wer", "heldout_delta_cer",
            "heldout_delta_wer_std"} <= set(evals[0])


def test_adapt_uses_the_best_checkpoint(run):
    """--use-best, beam, 3-best dumps: the results of meta_adapt + decode
    on the best state, and the recorded config left byte for byte."""
    _, wd, recorded = run
    assert cli.main(["--mode", "adapt", "--workdir", wd, "--device", "cpu",
                     "--use-best", "--decode-mode", "beam",
                     "--dump-nbest", "3"]) == 0
    with open(os.path.join(wd, "config.yaml"), "rb") as f:
        assert f.read() == recorded
    trainer = _trainer(wd)
    ds = trainer.heldout_datasets["delta"]
    adapted, test_idx = trainer.meta_adapt(
        trainer.ckpt.restore_best()["params"], ds)
    want = trainer.decode(adapted, ds, test_idx, mode="beam")
    assert _results(wd, "adapt") == {"delta": want}
    recs = _records(os.path.join(wd, "hyps_delta.jsonl"))
    assert len(recs) == len(test_idx) == 6
    for r in recs:
        assert r.keys() == {"hyp", "ref", "score", "nbest"}
        assert len(r["nbest"]) == 3 and r["nbest"][0]["hyp"] == r["hyp"]
        assert all(np.isfinite(h["score"]) for h in r["nbest"])
        assert r["nbest"][0]["score"] == r["score"]


def test_test_averages_the_last_checkpoints(run):
    _, wd, recorded = run
    assert cli.main(["--mode", "test", "--workdir", wd, "--device", "cpu",
                     "--avg-last", "2"]) == 0
    trainer = _trainer(wd)
    params = average_checkpoints(trainer.ckpt, last_n=2)
    want = trainer.decode(params, trainer.heldout_datasets["delta"])
    assert _results(wd, "test") == {"delta": want}
    with open(os.path.join(wd, "config.yaml"), "rb") as f:
        assert f.read() == recorded


def test_transcribe_decodes_every_accent(run):
    _, wd, _ = run
    assert cli.main(["--mode", "transcribe", "--workdir", wd,
                     "--device", "cpu"]) == 0
    results = _results(wd, "transcribe")
    assert list(results) == ["alpha", "bravo", "echo", "delta"]
    for name, r in results.items():
        assert r["utts"] == 8 and r["dump"].endswith(f"hyps_{name}.jsonl")
        assert {"wer", "cer"} <= set(r)
        assert len(_records(r["dump"])) == 8


def test_export_serves_without_config(run, tmp_path, capsys):
    """The exported bundle records its config: served without --config it
    gives the transcripts it gives with it."""
    data, wd, _ = run
    bundle = str(tmp_path / "bundle")
    assert cli.main(["--mode", "export", "--workdir", wd, "--device", "cpu",
                     "--export-dir", bundle,
                     "--export-buckets", "2x32000"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == {"export_dir": bundle, "files": {}, "mode": "beam",
                   "platforms": []}
    wavs = [os.path.join(data, "wav", "delta", f"delta_000{i}.wav")
            for i in range(2)]
    served = []
    for extra in ([], ["--config", os.path.join(wd, "config.yaml")]):
        assert cli.main(["--mode", "serve", "--bundle", bundle, "--wav",
                         *wavs, "--device", "cpu", "--dump-nbest", "2",
                         *extra]) == 0
        served.append([json.loads(line) for line in
                       capsys.readouterr().out.splitlines()])
    assert served[0] == served[1] and len(served[0]) == 2
    assert all(len(r["nbest"]) == 2 for r in served[0])


def test_bundle_without_recorded_config_needs_config(tmp_path_factory):
    """A bundle the JAX package exported keeps its dims in its programs:
    without a config it is refused with a message that names --config."""
    _, _, bundle = jax_bundle(tmp_path_factory, "jax_greedy", mode="greedy")
    with pytest.raises(ValueError, match="--config"):
        ServingDecoder(bundle, device="cpu")
    with pytest.raises(ValueError, match="--config"):
        cli.main(["--mode", "serve", "--bundle", bundle, "--wav", "x.wav",
                  "--device", "cpu"])


def test_baseline_test_and_transcribe(tmp_path):
    """A few --algo no steps of a small VGG-BLSTM; test scores the dev set
    through MonoASRTrainer.evaluate; transcribe decodes through a
    decode-only meta trainer and, on manifests without transcripts, writes
    hypotheses and reports no WER; adapt is refused."""
    data = str(tmp_path / "data")
    synthetic.generate_dataset(data, accents=("alpha",), utts_per_accent=10,
                               words_per_utt=(1, 2), seed=4)
    wd = str(tmp_path / "wd")
    assert cli.main(["--mode", "train", "--algo", "no", "--device", "cpu",
                     "--data-dir", data, "--workdir", wd, "--max-steps", "2",
                     "-o", "model.arch=vgg_blstm", "-o", "data.vocab=phone",
                     "-o", "model.blstm_hidden=16",
                     "-o", "model.blstm_layers=1",
                     "-o", "model.vgg_channels=4,8", "-o", "data.batch_size=4",
                     "-o", "data.dev_fraction=0.3", "-o", "train.eval_every=0",
                     "-o", "optimizer.name=adadelta"]) == 0
    assert cli.main(["--mode", "test", "--workdir", wd,
                     "--device", "cpu"]) == 0
    trainer = _trainer(wd)
    params = trainer.ckpt.restore()[0]["params"]
    assert _results(wd, "test") == {
        "dev": trainer.evaluate(params, trainer.dev_dataset)}
    with pytest.raises(SystemExit, match="baseline"):
        cli.main(["--mode", "adapt", "--workdir", wd, "--device", "cpu"])

    bare = str(tmp_path / "bare")
    shutil.copytree(data, bare)
    with open(os.path.join(data, "alpha.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(bare, "alpha.jsonl"), "w") as f:
        for r in recs:
            f.write(json.dumps({k: v for k, v in r.items()
                                if k not in ("text", "phones")}) + "\n")
    assert cli.main(["--mode", "transcribe", "--workdir", wd,
                     "--device", "cpu", "--data-dir", bare]) == 0
    results = _results(wd, "transcribe")
    assert list(results) == ["alpha"]
    assert results["alpha"] == {
        "utts": 7, "dump": os.path.join(wd, "hyps_alpha.jsonl")}
    hyps = _records(results["alpha"]["dump"])
    assert len(hyps) == 7 and all(h["ref"] == "" for h in hyps)
    assert all(isinstance(h["hyp"], str) for h in hyps)


def test_profile_and_debug_nans(run, tmp_path):
    """--profile writes a Chrome trace of the training run; --debug-nans
    turns on autograd's anomaly detection."""
    data, _, _ = run
    trace_dir = tmp_path / "trace"
    try:
        assert cli.main(["--device", "cpu", "--data-dir", data,
                         "--workdir", str(tmp_path / "wd"), "--max-steps", "1",
                         "--profile", str(trace_dir), "--debug-nans",
                         *SMALL]) == 0
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


@pytest.mark.parametrize("argv,message", [
    (["--use-best", "--avg-last", "2"], "mutually exclusive"),
    (["--export-platforms", "cpu"], "StableHLO"),
    (["--mesh-tasks", "2"], "--mode export runs in one process"),
], ids=["use_best_with_avg_last", "export_platforms", "mesh_tasks"])
def test_refused_flags(tmp_path, argv, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(["--mode", "export", "--workdir", str(tmp_path),
                  "--device", "cpu", *argv])


@pytest.mark.parametrize("mode", ["adapt", "test", "transcribe", "export"])
def test_meta_test_modes_default_to_cuda(run, mode):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    _, wd, _ = run
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--mode", mode, "--workdir", wd])
