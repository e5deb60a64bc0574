"""Port vs reference: the baseline trainers and what they stand on.

Metrics, the greedy text helpers, the phone vocabulary and the bucketed
batcher against the reference's on seeded inputs; then the slice as a whole
on a small synthetic corpus (phone vocabulary; hidden 32, 2 layers, channels
(8, 16)): three Adadelta steps of ``MonoASRTrainer`` from identical weights,
``evaluate`` on the same weights, checkpoint -> restore -> resume, a greedy
serving bundle, and the ``--mode train --algo no|multi`` CLI.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu import cli as ref_cli
from metaasr_tpu.config import Config as RefConfig
from metaasr_tpu.data import sampler as ref_sampler
from metaasr_tpu.decode import greedy as ref_greedy
from metaasr_tpu.serve import ExportSpec, export_bundle
from metaasr_tpu.serve import ServingDecoder as RefDecoder
from metaasr_tpu.train import metrics as ref_metrics
from metaasr_tpu.train.mono import device_batch
from metaasr_tpu_torch import cli
from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.data import sampler, synthetic
from metaasr_tpu_torch.data.audio_io import load_wav
from metaasr_tpu_torch.decode import greedy
from metaasr_tpu_torch.serve.export import ServingDecoder, write_bundle
from metaasr_tpu_torch.train import metrics
from metaasr_tpu_torch.train.meta_train import to_device
from metaasr_tpu_torch.train.mono import MonoASRTrainer, MultitaskASRTrainer
from metaasr_tpu_torch.weights import (
    flatten_tree,
    flax_to_state_dict,
    params_to_flax,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACCENTS = ("alpha", "bravo", "echo")


# ---------------- metrics and text helpers ----------------

def test_metrics_equal_reference():
    rng = np.random.default_rng(0)
    words = ["alpha", "bravo", "kilo", "lima", "x", "yz", ""]
    hyps = [" ".join(rng.choice(words, rng.integers(0, 7))) for _ in range(40)]
    refs = [" ".join(rng.choice(words, rng.integers(0, 7))) for _ in range(40)]
    assert metrics.compute_wer(hyps, refs) == ref_metrics.compute_wer(hyps, refs)
    assert metrics.compute_cer(hyps, refs) == ref_metrics.compute_cer(hyps, refs)
    for _ in range(30):
        a = rng.integers(0, 6, rng.integers(0, 12)).tolist()
        b = rng.integers(0, 6, rng.integers(0, 12)).tolist()
        want = ref_metrics.edit_distance(a, b)
        assert metrics.edit_distance(a, b) == want
        assert metrics._edit_distance_py(a, b) == want
    assert metrics.edit_distance("kitten", "sitting") == 3
    assert metrics.edit_distance([], [1, 2]) == 2
    acc = metrics.ErrorRate()
    acc.update([1, 2, 3], [1, 3])
    assert (acc.errors, acc.total, acc.rate) == (1, 2, 0.5)
    assert metrics.ErrorRate().rate == 0.0


def test_greedy_text_helpers_equal_reference():
    from metaasr_tpu.data.tokenizer import PhoneTokenizer as RefPhones
    from metaasr_tpu_torch.data.tokenizer import PhoneTokenizer

    rng = np.random.default_rng(1)
    tok, ref_tok = PhoneTokenizer.arpabet_default(), RefPhones.arpabet_default()
    logits = rng.standard_normal((4, 15, tok.vocab_size)).astype(np.float32)
    lens = np.array([15, 9, 1, 0], np.int32)
    want = ref_greedy.ctc_greedy_decode(jnp.asarray(logits), jnp.asarray(lens))
    got = greedy.ctc_greedy_decode(torch.from_numpy(logits),
                                   torch.from_numpy(lens))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    texts = greedy.greedy_to_texts(got[0], got[1], tok)
    assert texts == ref_greedy.greedy_to_texts(want[0], want[1], ref_tok)
    assert texts == greedy.greedy_to_texts(got[0].numpy(), got[1].numpy(), tok)
    ids = logits.argmax(-1)
    for b in range(4):
        row = ids[b, : lens[b]]
        assert greedy.collapse_ctc(row) == ref_greedy.collapse_ctc(row)
        assert greedy.collapse_ctc(row) == \
            got[0][b, : int(got[1][b])].tolist()


# ---------------- corpus, vocabulary, batcher ----------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mono_corpus"))
    synthetic.generate_dataset(d, accents=ACCENTS, utts_per_accent=14,
                               words_per_utt=(1, 3), seed=3)
    return d


def _cfg(cls, data_dir: str):
    cfg = cls()
    m = cfg.model
    m.arch, m.dtype = "vgg_blstm", "float32"
    m.blstm_hidden, m.blstm_layers, m.vgg_channels = 32, 2, (8, 16)
    cfg.meta.algo = "no"
    cfg.data.vocab, cfg.data.batch_size = "phone", 4
    cfg.data.data_dir = data_dir
    cfg.data.accents = ("alpha", "bravo")
    cfg.data.heldout_accents = ("echo",)
    cfg.optimizer.name, cfg.optimizer.lr = "adadelta", 1.0
    cfg.optimizer.schedule = "constant"
    cfg.specaug.enabled = False
    cfg.frontend.use_pallas = False      # the reference's jnp front-end
    cfg.train.log_every = 1
    cfg.train.keep_ckpts = 3
    return cfg


def test_phone_tokenizer_built_saved_and_loaded(corpus, tmp_path):
    import shutil

    work = str(tmp_path / "data")
    shutil.copytree(corpus, work)
    vocab_path = os.path.join(work, "vocab_phone.json")
    if os.path.exists(vocab_path):
        os.remove(vocab_path)
    tok = cli.build_tokenizer(_cfg(Config, work))
    assert os.path.exists(vocab_path)
    os.remove(vocab_path)
    want = ref_cli.build_tokenizer(_cfg(RefConfig, work))
    assert tok.symbols == want.symbols and len(tok.symbols) > 0
    assert cli.build_tokenizer(_cfg(Config, work)).symbols == tok.symbols
    # data.vocab=bpe builds the reference's BPE vocabulary beside it
    cfg, ref_cfg = _cfg(Config, work), _cfg(RefConfig, work)
    cfg.data.vocab = ref_cfg.data.vocab = "bpe"
    bpe_path = os.path.join(work, "vocab_bpe.json")
    bpe = cli.build_tokenizer(cfg)
    with open(bpe_path) as f:
        ours = f.read()
    os.remove(bpe_path)
    ref_bpe = ref_cli.build_tokenizer(ref_cfg)
    with open(bpe_path) as f:
        assert f.read() == ours
    assert bpe.symbols == ref_bpe.symbols and bpe.merges == ref_bpe.merges
    assert len(bpe.merges) > 0 and bpe.symbols != tok.symbols
    # manifests without phones fall back to ARPAbet
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "a.jsonl").write_text(json.dumps(
        {"id": "a0", "wav": "a0.wav", "text": "hi", "num_samples": 16000}) + "\n")
    assert "AA" in cli.build_tokenizer(_cfg(Config, str(bare))).symbols


def test_bucket_batcher_matches_reference(corpus):
    from metaasr_tpu.data.dataset import load_accent_datasets as ref_load
    from metaasr_tpu_torch.data.dataset import load_accent_datasets

    tok = cli.build_tokenizer(_cfg(Config, corpus))
    ref_tok = ref_cli.build_tokenizer(_cfg(RefConfig, corpus))
    sets = load_accent_datasets(corpus, tok, ACCENTS, vocab="phone")
    ref_sets = ref_load(corpus, ref_tok, ACCENTS, vocab="phone")
    kw = dict(batch_size=4, sample_buckets=(16000, 24000, 48000),
              token_buckets=(8, 16, 32), seed=5)
    for drop_last, with_tok in ((True, True), (False, False)):
        got = sampler.BucketBatcher(list(sets.values()), drop_last=drop_last,
                                    tokenizer=tok if with_tok else None, **kw)
        ref = ref_sampler.BucketBatcher(
            list(ref_sets.values()), drop_last=drop_last,
            tokenizer=ref_tok if with_tok else None, **kw)
        assert got.batches_per_epoch == ref.batches_per_epoch > 1
        assert got.index == ref.index
        n = 0
        for g, w in zip(got, ref):
            assert g["texts"] == w["texts"]
            for k in ("audio", "audio_lens", "tokens", "token_lens"):
                assert g[k].shape == w[k].shape
                np.testing.assert_array_equal(g[k], w[k])
            n += 1
        assert n == got.batches_per_epoch
    # iter_from(k) resumes the same stream, across the epoch boundary
    bpe = got.batches_per_epoch
    stream, ref_stream = got.iter_from(0), ref.iter_from(0)
    head = [next(stream) for _ in range(bpe + 3)]
    for b in head:
        assert next(ref_stream)["texts"] == b["texts"]
    for k in (2, bpe - 1, bpe + 1):
        resumed = got.iter_from(k)
        for want in head[k:]:
            b = next(resumed)
            assert b["texts"] == want["texts"]
            np.testing.assert_array_equal(b["audio"], want["audio"])
    item = sets["alpha"][0]
    assert sampler.item_samples(item) == ref_sampler.item_samples(item) \
        == len(item["audio"])
    assert sampler.item_samples({"feats": np.zeros((7, 80))}) == 7 * 160 + 240
    small = sampler.BucketBatcher(sets["alpha"], batch_size=64)
    with pytest.raises(ValueError, match="zero batches"):
        next(small.iter_from(0))


# ---------------- the slice as a whole ----------------

def _ref_trainer(corpus, workdir):
    cfg = _cfg(RefConfig, corpus)
    return ref_cli.make_trainer(cfg, workdir)


def test_three_steps_and_evaluate_match_reference(corpus, tmp_path):
    ref, _ = _ref_trainer(corpus, str(tmp_path / "ref"))
    cfg = _cfg(Config, corpus)
    trainer, tok = cli.make_trainer(cfg, str(tmp_path / "wd"), device="cpu")
    assert isinstance(trainer, MonoASRTrainer)
    assert [d.accent for d in trainer.train_datasets] == ["alpha"]
    assert trainer.dev_dataset.accent == "echo"
    assert sorted(trainer.heldout_datasets) == ["echo"]

    ref_state = ref.init_state()
    start = jax.tree.map(np.asarray, ref_state.params)
    state = trainer.init_state()
    assert set(state["params"]) == set(flax_to_state_dict(start))
    state["params"] = flax_to_state_dict(start)
    state["opt_state"] = trainer.optimizer.init(state["params"])

    dev = ref.evaluate(ref_state.params, ref.dev_dataset)
    got_dev = trainer.evaluate(state["params"], trainer.dev_dataset)
    assert got_dev == dev and 0.0 < dev["cer"] <= 1.0

    feed, ref_feed = trainer.batcher.iter_from(0), ref.batcher.iter_from(0)
    for _ in range(3):
        batch, ref_batch = next(feed), next(ref_feed)
        np.testing.assert_array_equal(batch["audio"], ref_batch["audio"])
        ref_state, ref_m = ref._jit_step(
            ref_state, jax.device_put(device_batch(ref_batch)))
        state, m = trainer.step(state, to_device(batch, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-3)
    assert state["step"] == 3 == int(ref_state.step)
    want = flatten_tree(jax.tree.map(np.asarray, ref_state.params))
    got = flatten_tree(params_to_flax(state["params"], 1))
    first = flatten_tree(start)
    for k, w in want.items():
        l2rel = np.linalg.norm(got[k] - w) / np.linalg.norm(w)
        # a bias starts at zero: its value is the sum of three normalised
        # Adadelta updates and carries the gradient's own relative error,
        # held to 1e-3 in tests/test_torch_vgg.py (measured here: 2.0e-4
        # on the first conv block's biases, <= 1.7e-5 elsewhere)
        tol = 1e-3 if k.endswith("/bias") else 1e-4
        assert l2rel <= tol, (k, l2rel)
        assert np.linalg.norm(w - first[k]) > 0, k     # every leaf trained


def test_train_evaluates_checkpoints_and_resumes_exactly(corpus, tmp_path):
    def make(workdir):
        cfg = _cfg(Config, corpus)
        cfg.specaug.enabled = True            # the step's generators resume
        cfg.frontend.dither = 1e-3
        cfg.data.dev_fraction = 0.25
        cfg.train.eval_every, cfg.train.ckpt_every = 2, 1
        return cli.make_trainer(cfg, str(tmp_path / workdir), device="cpu")[0]

    whole = make("whole").train(max_steps=4)
    part = make("part")
    assert len(part.dev_dataset) == 3 and len(part.train_datasets[0]) == 11
    assert part.train(max_steps=2)["step"] == 2
    assert part.ckpt.all_steps() == [1, 2]
    with open(os.path.join(part.ckpt.ckpt_dir, "step_2.metrics.json")) as f:
        saved = json.load(f)
    assert set(saved) == {"wer", "cer"}
    best = part.ckpt.restore_best()
    assert best["step"] == 2 and best["best_metric"] == saved["wer"]
    resumed = make("part").train(max_steps=4)        # a new process's view
    assert resumed["step"] == 4
    for k, v in whole["params"].items():
        assert torch.equal(resumed["params"][k], v), k
    assert resumed["best_metric"] == whole["best_metric"] <= saved["wer"]
    recs = [json.loads(line) for line in
            open(tmp_path / "part" / "logs" / "scalars.jsonl")]
    assert [r["step"] for r in recs if "dev_wer" in r] == [2, 4]
    assert any(r.get("tag") == "sample_0" for r in recs)
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)


def test_early_stopping_and_unported_loader(corpus, tmp_path):
    cfg = _cfg(Config, corpus)
    cfg.optimizer.name, cfg.optimizer.lr = "sgd", 0.0   # dev never improves
    cfg.train.eval_every, cfg.train.early_stop_patience = 1, 2
    trainer, _ = cli.make_trainer(cfg, str(tmp_path / "wd"), device="cpu")
    state = trainer.train(max_steps=10)
    # eval 1 sets the best, evals 2 and 3 are stale: stop after step 3
    assert (state["step"], state["stale_evals"]) == (3, 2)
    assert os.path.exists(os.path.join(trainer.ckpt.ckpt_dir, "best",
                                       "metrics.json"))
    cfg.data.loader = "grain"
    with pytest.raises(NotImplementedError, match="grain") as e:
        cli.make_trainer(cfg, str(tmp_path / "wd2"), device="cpu")
    assert "ROADMAP.md" in str(e.value)


def test_greedy_bundle_serves_the_trained_weights(corpus, tmp_path):
    cfg = _cfg(Config, corpus)
    trainer, tok = cli.make_trainer(cfg, str(tmp_path / "wd"), device="cpu")
    state = trainer.train(max_steps=2)
    bundle = str(tmp_path / "bundle")
    meta = write_bundle(bundle, cfg, params_to_flax(state["params"], 1), tok,
                        [(4, 32000), (1, 32000)])
    assert meta["mode"] == "greedy" and meta["vocab_kind"] == "phone"
    with pytest.raises(ValueError, match="greedily"):
        write_bundle(bundle + "x", cfg, {}, tok, [(1, 8000)], mode="beam")
    dec = ServingDecoder(bundle, cfg, device="cpu")
    ds = trainer.heldout_datasets["echo"]
    items = [ds[i] for i in range(4)]
    batch = sampler.collate(items, 32000, 32)
    packed, out_lens = trainer.task.greedy_batch(state["params"],
                                                 to_device(batch, "cpu"))
    want = greedy.greedy_to_texts(packed, out_lens, tok)
    served = dec.transcribe([it["audio"] for it in items])
    assert [r["text"] for r in served] == want
    assert dec.transcribe([items[2]["audio"]])[0]["text"] == want[2]
    wav = os.path.join(corpus, "wav", "echo", "echo_0001.wav")
    np.testing.assert_array_equal(load_wav(wav), items[1]["audio"])
    assert dec.transcribe_files([wav])[0]["text"] == want[1]


def test_reference_greedy_vgg_bundle_serves_in_the_port(tmp_path):
    """A greedy bundle the JAX package exports for the VGG-BLSTM is served
    by the port with the same texts."""
    from metaasr_tpu.data.tokenizer import CharTokenizer
    from metaasr_tpu.train.task import ASRTask as RefTask
    from tests.test_m2_models import tiny_cfg
    from tests.test_torch_serve import _port_cfg, _waves

    tok = CharTokenizer.ascii_default()
    cfg = tiny_cfg("vgg_blstm", vocab=tok.vocab_size)
    task = RefTask(cfg, tok.sos_eos_id)
    rng = np.random.default_rng(0)
    batch = {"audio": jnp.asarray(0.1 * rng.standard_normal((2, 8000)),
                                  jnp.float32),
             "audio_lens": jnp.asarray([8000, 5000], np.int32),
             "tokens": jnp.ones((2, 4), jnp.int32),
             "token_lens": jnp.asarray([4, 2], np.int32)}
    params = task.init_params(jax.random.PRNGKey(0), batch)
    export_bundle(cfg, params, tok, str(tmp_path),
                  spec=ExportSpec(buckets=((3, 8000),), platforms=("cpu",),
                                  mode="greedy"))
    waves = _waves(12)
    got = ServingDecoder(str(tmp_path), _port_cfg(cfg),
                         device="cpu").transcribe(waves)
    want = RefDecoder(str(tmp_path)).transcribe(waves)
    assert [g["text"] for g in got] == [w["text"] for w in want]
    assert any(g["text"] for g in got)


@pytest.mark.parametrize("algo", ["no", "multi"])
def test_cli_trains_config1(corpus, tmp_path, capsys, algo):
    rc = cli.main(["--mode", "train", "--device", "cpu", "--algo", algo,
                   "--config",
                   os.path.join(REPO, "configs", "config1_mono_vgg_ctc.yaml"),
                   "--data-dir", corpus, "--workdir", str(tmp_path),
                   "--max-steps", "2", "-o", "model.blstm_hidden=32",
                   "-o", "model.blstm_layers=1", "-o", "model.vgg_channels=8",
                   "-o", "data.batch_size=4", "-o", "data.dev_fraction=0.2",
                   "-o", "train.eval_every=2"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 2
    assert os.path.exists(tmp_path / "ckpts" / "step_2.pt")
    assert os.path.exists(tmp_path / "ckpts" / "step_2.metrics.json")
    assert os.path.exists(tmp_path / "ckpts" / "best" / "state.pt")


def test_multitask_trainer_pools_the_accents(corpus, tmp_path):
    cfg = _cfg(Config, corpus)
    cfg.meta.algo = "multi"
    trainer, _ = cli.make_trainer(cfg, str(tmp_path), device="cpu")
    assert isinstance(trainer, MultitaskASRTrainer)
    assert trainer.accents == ["alpha", "bravo"]
    assert len(trainer.batcher.index) == 28
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.make_trainer(cfg, str(tmp_path))
