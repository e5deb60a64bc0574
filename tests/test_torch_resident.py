"""Port vs reference: the device-resident corpus (``data.resident``).

The packed store, its offsets and its reckoned size against the reference's
``build_resident_store`` / ``resident_store_bytes`` for a raw-audio, a
precomputed-feature and a speaker-CMVN corpus; the per-step store rows and
bucket shapes against the reference's sampler; the port's gathered batch
against the streaming feed's; ``meta_train`` resident against streaming
and a resumed resident run against a straight one; the ``auto`` / ``on`` /
``off`` rule. Small shapes: d=32, 2 heads, 2+2 layers, on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from metaasr_tpu.data import sampler as ref_sampler
from metaasr_tpu.data.dataset import load_accent_datasets as ref_load
from metaasr_tpu.data.tokenizer import CharTokenizer as RefCharTokenizer
from metaasr_tpu_torch import cli
from metaasr_tpu_torch.data import sampler, synthetic
from metaasr_tpu_torch.data.dataset import load_accent_datasets
from metaasr_tpu_torch.data.tokenizer import CharTokenizer
from metaasr_tpu_torch.frontend.fbank import num_frames
from metaasr_tpu_torch.train.meta_train import MetaASRTrainer, to_device
from tests.test_torch_train import _train_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ACCENTS = ("alpha", "bravo", "echo", "delta")
MODES = ("audio", "feats", "cmvn")
CAP_SAMPLES, CAP_TOKENS = 200 * 160 + 240, 16   # _train_cfg's caps


def _write_feats_corpus(src: str, dst: str) -> None:
    """``src``'s manifests with seeded [T, 80] feature arrays in place of
    the WAVs (T = num_frames of the utterance's samples)."""
    rng = np.random.default_rng(5)
    for a in ACCENTS:
        os.makedirs(os.path.join(dst, "feats", a), exist_ok=True)
        lines = []
        with open(os.path.join(src, f"{a}.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                rel = os.path.join("feats", a, f"{rec['id']}.npy")
                feats = rng.standard_normal(
                    (num_frames(rec["num_samples"]), 80)).astype(np.float32)
                np.save(os.path.join(dst, rel), feats)
                rec.pop("wav")
                lines.append(json.dumps(dict(rec, feats=rel)))
        with open(os.path.join(dst, f"{a}.jsonl"), "w") as f:
            f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{mode: (data_dir, speaker_cmvn_path)}: one synthetic corpus read
    as raw audio, as features, and as raw audio with per-speaker CMVN."""
    root = tmp_path_factory.mktemp("resident")
    audio, feats = str(root / "audio"), str(root / "feats")
    synthetic.generate_dataset(audio, accents=ACCENTS, utts_per_accent=8,
                               words_per_utt=(1, 2), seed=3)
    _write_feats_corpus(audio, feats)
    rng = np.random.default_rng(6)
    stats = {f"spk_{a}": {"mean": rng.standard_normal(80).tolist(),
                          "var": rng.uniform(0.5, 2.0, 80).tolist()}
             for a in ACCENTS}
    cmvn = str(root / "speaker_cmvn.json")
    with open(cmvn, "w") as f:
        json.dump(stats, f)
    return {"audio": (audio, ""), "feats": (feats, ""), "cmvn": (audio, cmvn)}


def _both_datasets(corpora, mode, accents=()):
    data_dir, spk = corpora[mode]
    return (ref_load(data_dir, RefCharTokenizer.ascii_default(), accents,
                     speaker_cmvn_path=spk),
            load_accent_datasets(data_dir, CharTokenizer.ascii_default(),
                                 accents, speaker_cmvn_path=spk))


def _trainer(corpora, mode, workdir, resident="on", **data) -> MetaASRTrainer:
    data_dir, spk = corpora[mode]
    cfg = _train_cfg(data_dir)
    cfg.data.resident = resident
    # buckets that split these draws: steps 0-4 take three shapes
    cfg.data.frame_buckets, cfg.data.token_buckets = (75, 100, 200), (8, 16)
    if spk:
        cfg.frontend.cmvn = "speaker"
        cfg.frontend.cmvn_stats_path = spk
    for k, v in data.items():
        setattr(cfg.data, k, v)
    return cli.make_trainer(cfg, str(workdir), device="cpu")[0]


@pytest.mark.parametrize("mode", MODES)
def test_store_offsets_and_bytes_match_reference(corpora, mode):
    ref_ds, ds = _both_datasets(corpora, mode)
    want, want_off = ref_sampler.build_resident_store(ref_ds, CAP_SAMPLES,
                                                      CAP_TOKENS)
    got, got_off = sampler.build_resident_store(ds, CAP_SAMPLES, CAP_TOKENS)
    assert got_off == want_off
    assert sorted(got) == sorted(want)
    assert ("feats" in got) == (mode == "feats")
    assert ("cmvn_mean" in got) == (mode == "cmvn")
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert got[k].tobytes() == v.tobytes(), k
    assert (sampler.resident_store_bytes(ds, CAP_SAMPLES, CAP_TOKENS)
            == ref_sampler.resident_store_bytes(ref_ds, CAP_SAMPLES,
                                                CAP_TOKENS)
            == 32 * (CAP_SAMPLES * 4 + CAP_TOKENS * 4 + 8))  # 4 x 8 utts


def test_indices_and_bucket_shapes_match_reference(corpora, tmp_path):
    tr = _trainer(corpora, "audio", tmp_path)
    tr._setup_resident()
    s = tr.sampler
    ref = ref_sampler.TaskSampler(
        _both_datasets(corpora, "audio", s.accents)[0],
        k_support=s.k_support,
        k_query=s.k_query, tasks_per_batch=s.tasks_per_batch,
        num_samples=s.num_samples, num_tokens=s.num_tokens, seed=s.seed,
        sample_buckets=s.sample_buckets, token_buckets=s.token_buckets)
    _, ref_off = ref_sampler.build_resident_store(ref.datasets, CAP_SAMPLES,
                                                  CAP_TOKENS)
    shapes = set()
    for step in range(5):
        accents, sup, qry = ref.sample_indices(step)
        want_shape = ref.step_shape(accents, sup, qry)
        off = np.asarray([ref_off[a] for a in accents], np.int32)[:, None]
        got_sup, got_qry, got_shape = tr._resident_indices(step)
        assert got_shape == want_shape
        for g, w in ((got_sup, sup + off), (got_qry, qry + off)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        shapes.add(got_shape)
    assert len(shapes) == 3    # the buckets split these draws


@pytest.mark.parametrize("mode", MODES)
def test_gathered_batch_equals_streaming_batch(corpora, tmp_path, mode):
    tr = _trainer(corpora, mode, tmp_path)
    tr._setup_resident()
    assert tr._store is not None
    for step in range(5):
        want = to_device(tr.sampler.sample(step), tr.device)
        got = tr._resident_batch(step)
        assert sorted(got) == ["query", "support"]
        for part in ("support", "query"):
            assert sorted(got[part]) == sorted(want[part])
            for k, v in want[part].items():
                g = got[part][k]
                assert g.dtype == v.dtype and g.shape == v.shape, (step, k)
                assert g.is_contiguous()
                assert torch.equal(g, v), (step, part, k)


def _assert_params_close(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("mode", ("audio", "feats"))
def test_resident_meta_train_equals_streaming(corpora, tmp_path, mode,
                                              monkeypatch):
    streamed = []
    feed = MetaASRTrainer._batch_feed
    monkeypatch.setattr(MetaASRTrainer, "_batch_feed",
                        lambda self, *a: streamed.append(self) or
                        feed(self, *a))
    res = _trainer(corpora, mode, tmp_path / "on", "on")
    s_res = res.meta_train(max_steps=3)
    off = _trainer(corpora, mode, tmp_path / "off", "off")
    s_off = off.meta_train(max_steps=3)
    assert streamed == [off] and res._store is not None and off._store is None
    assert s_res["step"] == s_off["step"] == 3
    _assert_params_close(s_res["params"], s_off["params"])


def test_auto_follows_the_budget_and_nothing_is_built_early(corpora,
                                                            tmp_path):
    with pytest.raises(ValueError, match="auto|on|off"):
        _trainer(corpora, "audio", tmp_path / "bad", "sometimes"
                 )._setup_resident()
    # the 3 training accents' 24 utterances ("delta" is held out)
    reckoned = 24 * (CAP_SAMPLES * 4 + CAP_TOKENS * 4 + 8)
    cases = [("auto", reckoned / 1e9 * 1.001, True),
             ("auto", reckoned / 1e9 * 0.999, False),
             ("on", 1e-9, True), ("off", 100.0, False),
             (True, 4.0, True), (False, 4.0, False)]  # YAML's on / off
    for i, (mode, gb, built) in enumerate(cases):
        tr = _trainer(corpora, "audio", tmp_path / str(i), mode,
                      resident_max_gb=gb)
        assert tr._store is None          # lazy: meta_train builds it
        tr._setup_resident()
        assert (tr._store is not None) == built, (mode, gb)
        if built:
            assert (sum(v.numel() * v.element_size()
                        for v in tr._store.values()) == reckoned)
    # an adapt-only session (held-out decoding) reads no corpus
    tr = _trainer(corpora, "audio", tmp_path / "adapt", "on")
    params = tr.init_state()["params"]
    adapted, test_idx = tr.meta_adapt(params, tr.heldout_datasets["delta"])
    tr.decode(adapted, tr.heldout_datasets["delta"], test_idx, max_utts=2)
    assert tr._store is None and not tr._resident_ready


def test_resumed_resident_run_equals_straight_run(corpora, tmp_path):
    full = _trainer(corpora, "audio", tmp_path / "full")
    s_full = full.meta_train(max_steps=4)
    first = _trainer(corpora, "audio", tmp_path / "resumed")
    assert first.meta_train(max_steps=2)["step"] == 2
    again = _trainer(corpora, "audio", tmp_path / "resumed")
    s_again = again.meta_train(max_steps=4)
    assert s_again["step"] == 4 and again._store is not None
    _assert_params_close(s_full["params"], s_again["params"])
