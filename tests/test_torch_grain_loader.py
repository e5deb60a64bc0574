"""Port vs reference: the grain loader (``data.loader: grain``).

The port's ``data/grain_loader.py`` against the reference's
``make_grain_loader`` with grain's own order injected into
``epoch_permutation`` (the compiled ``index_shuffle``, which numpy cannot
reproduce): batches across epoch boundaries, a finite stream's partial last
batch, a feature corpus. Then the port's own order, the iterator state and
worker processes, the baseline trainers' exact resume (a tiny VGG-BLSTM
``MonoASRTrainer`` and a tiny transformer ``MultitaskASRTrainer``), and the
iterator-state files pruned by the reference's rule. On the CPU.
"""

import functools
import json
import os
import pickle
import types

import numpy as np
import pytest
import torch

from metaasr_tpu.data.dataset import load_accent_datasets as ref_load
from metaasr_tpu.data.tokenizer import CharTokenizer as RefCharTokenizer
from metaasr_tpu_torch import cli
from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.data import grain_loader, synthetic
from metaasr_tpu_torch.data.dataset import load_accent_datasets
from metaasr_tpu_torch.data.tokenizer import CharTokenizer
from metaasr_tpu_torch.frontend.fbank import num_frames
from metaasr_tpu_torch.train.meta_train import to_device
from metaasr_tpu_torch.train.mono import MonoASRTrainer
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ACCENTS = ("alpha", "bravo")        # 2 x 5 utterances: N = 10
SAMPLES, TOKENS = 32000, 16


def _write_feats_corpus(src: str, dst: str) -> None:
    """``src``'s manifests with seeded [T, 80] feature arrays in place of
    the WAVs."""
    rng = np.random.default_rng(7)
    for a in ACCENTS:
        os.makedirs(os.path.join(dst, "feats", a), exist_ok=True)
        lines = []
        with open(os.path.join(src, f"{a}.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                rel = os.path.join("feats", a, f"{rec['id']}.npy")
                np.save(os.path.join(dst, rel), rng.standard_normal(
                    (num_frames(rec["num_samples"]), 80)).astype(np.float32))
                rec.pop("wav")
                lines.append(json.dumps(dict(rec, feats=rel)))
        with open(os.path.join(dst, f"{a}.jsonl"), "w") as f:
            f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{"audio": dir, "feats": dir}: one synthetic corpus, 2 accents x 5
    utterances, as raw audio and as features."""
    root = tmp_path_factory.mktemp("grain")
    audio, feats = str(root / "audio"), str(root / "feats")
    synthetic.generate_dataset(audio, accents=ACCENTS, utts_per_accent=5,
                               words_per_utt=(1, 3), seed=4)
    _write_feats_corpus(audio, feats)
    return {"audio": audio, "feats": feats}


def _port_sets(data_dir):
    tok = CharTokenizer.ascii_default()
    return list(load_accent_datasets(data_dir, tok, ACCENTS).values())


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    assert got["texts"] == want["texts"]
    for k, v in want.items():
        if k != "texts":
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v)


def _grain_order(monkeypatch):
    """epoch_permutation -> grain's order: epoch e of seed s is
    ``index_shuffle(., seed=(s + e) mod 2^32, rounds=4)``."""
    from grain.python.experimental import index_shuffle

    def order(seed, epoch, n):
        s = (int(seed) + int(epoch)) % 2 ** 32
        return np.asarray([index_shuffle(i, max_index=n - 1, seed=s, rounds=4)
                           for i in range(n)])

    monkeypatch.setattr(grain_loader, "epoch_permutation", order)


@pytest.mark.parametrize("case", ["endless", "two_epochs", "feats"])
def test_stream_equals_reference_with_grains_order(corpora, monkeypatch,
                                                   case):
    pytest.importorskip("grain")
    from metaasr_tpu.data.grain_loader import make_grain_loader as ref_make

    _grain_order(monkeypatch)
    data = corpora["feats" if case == "feats" else "audio"]
    ref_sets = list(ref_load(data, RefCharTokenizer.ascii_default(),
                             ACCENTS).values())
    # N = 10: B 4 runs 3 epochs over 8 batches; 2 epochs of B 3 end in a
    # batch of 2
    bsz, epochs = (3, 2) if case == "two_epochs" else (4, None)
    kw = dict(seed=3, num_epochs=epochs)
    got = grain_loader.make_grain_loader(_port_sets(data), bsz, SAMPLES,
                                         TOKENS, **kw)
    want = ref_make(ref_sets, bsz, SAMPLES, TOKENS, **kw)
    if epochs is None:
        pairs = [(next(got), next(want)) for _ in range(8)]
    else:
        got_all, want_all = list(got), list(want)
        assert len(got_all) == len(want_all) == 7
        assert len(got_all[-1]["texts"]) == 2
        pairs = list(zip(got_all, want_all))
    for g, w in pairs:
        _assert_batches_equal(g, w)
    if case == "feats":
        assert pairs[0][0]["feats"].shape == (bsz, num_frames(SAMPLES), 80)
    else:
        assert pairs[0][0]["audio"].shape == (bsz, SAMPLES)
    assert got.get_state() == {"next_index": len(pairs)}


def test_port_order_is_a_seeded_permutation_per_epoch(corpora):
    n = 10
    perms = [grain_loader.epoch_permutation(3, e, n) for e in range(4)]
    for p in perms:
        assert sorted(p.tolist()) == list(range(n))
    assert all(np.array_equal(p, grain_loader.epoch_permutation(3, e, n))
               for e, p in enumerate(perms))
    assert len({tuple(p.tolist()) for p in perms}) == 4
    assert not np.array_equal(perms[0], grain_loader.epoch_permutation(4, 0,
                                                                        n))
    # stream item i is source item perm(i // N)[i % N], across epochs
    sets = _port_sets(corpora["audio"])
    source = [ds.transcript(i) for ds in sets for i in range(len(ds))]
    it = grain_loader.make_grain_loader(sets, 4, SAMPLES, TOKENS, seed=3)
    texts = [t for _ in range(8) for t in next(it)["texts"]]
    assert texts == [source[perms[i // n][i % n]] for i in range(32)]


@pytest.mark.parametrize("workers", [0, 2])
def test_state_resumes_the_stream(corpora, workers):
    sets = _port_sets(corpora["audio"])
    make = functools.partial(grain_loader.make_grain_loader, sets, 4,
                             SAMPLES, TOKENS, seed=1)
    it = make()
    straight = [next(it) for _ in range(7)]
    part = make(num_workers=workers)
    for want in straight[:3]:
        _assert_batches_equal(next(part), want)
    state = grain_loader.save_iterator_state(part)
    # the workers have read ahead; the state counts what was handed out
    assert state == {"next_index": 3}
    assert pickle.loads(pickle.dumps(state)) == state
    resumed = make(num_workers=workers)
    grain_loader.restore_iterator_state(resumed, state)
    for want in straight[3:]:
        _assert_batches_equal(next(resumed), want)
    # set_state on a running iterator restarts it there
    grain_loader.restore_iterator_state(part, {"next_index": 1})
    _assert_batches_equal(next(part), straight[1])
    part.close()
    _assert_batches_equal(next(part), straight[2])
    resumed.close()
    part.close()
    grain_loader.restore_iterator_state(part, None)    # no state: no-op
    assert part.get_state() == {"next_index": 3}
    with pytest.raises(ValueError, match="no utterance"):
        grain_loader.make_grain_loader([], 4, SAMPLES, TOKENS)


def _trainer_cfg(data_dir: str, kind: str) -> Config:
    cfg = Config()
    m = cfg.model
    m.dtype = "float32"
    if kind == "mono":
        m.arch = "vgg_blstm"
        m.blstm_hidden, m.blstm_layers, m.vgg_channels = 32, 2, (8, 16)
        cfg.meta.algo = "no"
        cfg.optimizer.name, cfg.optimizer.lr = "adadelta", 1.0
        cfg.data.num_workers = 2
    else:
        m.d_model, m.num_heads, m.d_ff = 32, 2, 64
        m.num_encoder_layers = m.num_decoder_layers = 2
        cfg.meta.algo = "multi"
        cfg.optimizer.lr = 1e-3
    cfg.optimizer.schedule = "constant"
    cfg.data.data_dir, cfg.data.accents = data_dir, ACCENTS
    cfg.data.loader, cfg.data.batch_size = "grain", 4
    cfg.data.max_frames, cfg.data.max_tokens = 120, TOKENS
    cfg.train.log_every, cfg.train.eval_every = 10 ** 9, 0
    cfg.train.ckpt_every, cfg.train.keep_ckpts = 2, 2
    return cfg


@pytest.mark.parametrize("kind", ["mono", "multitask"])
def test_trainer_resumes_exactly(corpora, tmp_path, kind):
    """2 + 2 steps, the second run a fresh trainer restored from the
    checkpoint and ``grain_state_2.bin``, equal 4 straight steps bit for
    bit; every run trains on the loader's first batches in order."""
    cfg = _trainer_cfg(corpora["audio"], kind)
    fed = []

    def run(workdir, steps):
        trainer, _ = cli.make_trainer(cfg, str(workdir), device="cpu")
        assert type(trainer).__name__ == ("MonoASRTrainer" if kind == "mono"
                                          else "MultitaskASRTrainer")
        step = trainer.step

        def recording(state, batch):
            fed.append(batch)
            return step(state, batch)

        trainer.step = recording
        return trainer, trainer.train(max_steps=steps)

    tr, full = run(tmp_path / "full", 4)
    straight = list(fed)
    fed.clear()
    run(tmp_path / "resumed", 2)
    ckpts = os.path.join(str(tmp_path / "resumed"), "ckpts")
    assert os.path.exists(os.path.join(ckpts, "grain_state_2.bin"))
    resumed_tr, resumed = run(tmp_path / "resumed", 4)
    assert resumed["step"] == full["step"] == 4
    for k, v in full["params"].items():
        assert torch.equal(v, resumed["params"][k]), k
    # the trainers consumed exactly the loader's first 4 batches
    loader = grain_loader.make_grain_loader(
        tr.train_datasets, 4, 120 * 160 + 240, TOKENS, seed=cfg.data.seed)
    want = [to_device(next(loader), "cpu") for _ in range(4)]
    for batches in (straight, fed):
        assert len(batches) == 4
        for got, w in zip(batches, want):
            assert sorted(got) == sorted(w)
            assert all(torch.equal(got[k], v) for k, v in w.items())
    for step in (2, 4):
        with open(os.path.join(ckpts, f"grain_state_{step}.bin"), "rb") as f:
            assert pickle.load(f) == {"next_index": step}
    assert resumed_tr._grain_it.get_state() == {"next_index": 4}
    assert not any(p.endswith(".tmp") for p in os.listdir(ckpts))


@pytest.mark.parametrize("every,keep", [(2, 2), (1, 3), (0, 2)])
def test_state_files_pruned_as_the_reference_prunes(tmp_path, every, keep):
    """The port's ``_save_ckpt`` and the reference's, each on a stand-in
    trainer, over the same saves: the same state files with the same
    contents remain."""
    from metaasr_tpu.train.mono import MonoASRTrainer as RefMono

    steps = [s for s in range(1, 13) if s % max(every, 1) == 0] + [13]
    listing = {}
    for name, cls in (("port", MonoASRTrainer), ("ref", RefMono)):
        d = tmp_path / name
        d.mkdir()
        it = types.SimpleNamespace(get_state=lambda: {"next_index": it.n},
                                   n=0)
        stub = types.SimpleNamespace(
            ckpt=types.SimpleNamespace(ckpt_dir=str(d),
                                       save=lambda *a, **k: None),
            cfg=types.SimpleNamespace(train=types.SimpleNamespace(
                keep_ckpts=keep, ckpt_every=every)),
            _grain_it=it)
        stub._grain_state_path = functools.partial(cls._grain_state_path,
                                                   stub)
        for s in steps:
            it.n = s
            cls._save_ckpt(stub, s, {"step": s})
        files = sorted(os.listdir(d))
        listing[name] = {f: pickle.loads((d / f).read_bytes()) for f in files}
    assert listing["port"] == listing["ref"]
    oldest = 13 - keep * max(every, 1)
    assert sorted(listing["port"]) == sorted(
        f"grain_state_{s}.bin" for s in steps if s >= oldest)
    # the bucketed feed writes no iterator state
    d = tmp_path / "buckets"
    d.mkdir()
    stub = types.SimpleNamespace(
        ckpt=types.SimpleNamespace(ckpt_dir=str(d), save=lambda *a, **k: None),
        _grain_it=None)
    MonoASRTrainer._save_ckpt(stub, 2, {})
    assert os.listdir(d) == []
