"""Port vs reference: data preparation
(``metaasr_tpu_torch/scripts/prepare_data.py`` against the reference's
``scripts/prepare_data.py``).

``tests/test_prepare_data.py``'s fake Common Voice corpus (22.05 kHz clips,
a missing file, an unwanted accent) goes through both packages'
``commonvoice``, ``speaker-cmvn``, ``features`` and ``vocab char|phone|bpe``,
in process; the port computes its features with ``--device cpu`` (K1's
plain version). Manifests, WAVs and vocabularies must be equal; features
within rtol = atol = 1e-4 (the reference's own bar,
``tests/test_prepare_data.py``), statistics within 1e-4 (1 + |x|). Then the
prepared features feed the port's joint loss and CLI on the feats path.
"""

import glob
import importlib.util
import json
import os
import shutil
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu.data.dataset import load_accent_datasets as ref_load
from metaasr_tpu.data.sampler import collate as ref_collate
from metaasr_tpu.data.tokenizer import CharTokenizer as RefCharTokenizer
from metaasr_tpu.train.task import ASRTask as RefTask
from metaasr_tpu_torch import cli
from metaasr_tpu_torch.data.audio_io import load_wav
from metaasr_tpu_torch.data.dataset import load_accent_datasets
from metaasr_tpu_torch.data.sampler import collate
from metaasr_tpu_torch.data.tokenizer import CharTokenizer
from metaasr_tpu_torch.scripts import prepare_data
from metaasr_tpu_torch.task import ASRTask
from metaasr_tpu_torch.weights import flax_to_params
from tests.test_m2_models import tiny_cfg
from tests.test_prepare_data import _fake_cv
from tests.test_torch_meta import port_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_TOL = 1e-4          # rtol = atol, tests/test_prepare_data.py
STATS_TOL = 1e-4         # times (1 + |x|)
LOSS_RTOL = 1e-4         # fp32, tests/test_torch_meta.py
ACCENTS = ("us", "england", "india")
VOCABS = ("char", "phone", "bpe")


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "reference_prepare_data", os.path.join(REPO, "scripts",
                                               "prepare_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def run(argv):
        with mock.patch.object(sys, "argv", ["prepare_data", *argv]):
            mod.main()

    return run


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Both packages' outputs: {"ref"|"port": data dir}, and the
    ``commonvoice`` manifests as they were before ``features`` rewrote
    them."""
    root = str(tmp_path_factory.mktemp("cv"))
    tsv, clips = _fake_cv(root, np.random.default_rng(0))
    dirs, cv_manifests = {}, {}
    for name, run, dev in (("ref", _reference_script(), []),
                           ("port", prepare_data.main, ["--device", "cpu"])):
        out = dirs[name] = os.path.join(root, name)
        run(["commonvoice", "--tsv", tsv, "--clips-dir", clips, "--out", out,
             "--accents", *ACCENTS, "--min-sec", "0.2", "--max-sec", "5"])
        cv_manifests[name] = {a: _read(os.path.join(out, f"{a}.jsonl"))
                              for a in ACCENTS}
        run(["speaker-cmvn", "--data-dir", out, *dev])
        run(["features", "--data-dir", out, *dev])
        for kind in VOCABS:
            run(["vocab", "--data-dir", out, "--type", kind])
    return dirs, cv_manifests


def test_commonvoice_matches_reference(prepared):
    dirs, cv = prepared
    assert cv["port"] == cv["ref"]
    recs = [json.loads(line) for line in cv["port"]["us"].splitlines()]
    # 6 us clips plus a missing file: skipped, and its row still counted
    assert [r["id"] for r in recs] == [f"us_{i:06d}" for i in range(6)]
    assert list(recs[0]) == ["id", "wav", "text", "phones", "num_samples",
                             "speaker"]
    wavs = sorted(os.path.relpath(p, dirs["ref"]) for p in glob.glob(
        os.path.join(dirs["ref"], "wav", "*", "*.wav")))
    assert len(wavs) == 13 and wavs == sorted(
        os.path.relpath(p, dirs["port"]) for p in glob.glob(
            os.path.join(dirs["port"], "wav", "*", "*.wav")))
    for rel in wavs:
        assert _read(os.path.join(dirs["port"], rel)) == _read(
            os.path.join(dirs["ref"], rel))
        got = load_wav(os.path.join(dirs["port"], rel), 16000)
        assert got.dtype == np.float32
    # resampled to 16 kHz: the manifest's count is the file's
    assert len(load_wav(os.path.join(dirs["port"], recs[0]["wav"]))) == \
        recs[0]["num_samples"]


def test_features_match_reference(prepared):
    dirs, _ = prepared
    for accent in ACCENTS:
        name = f"{accent}.jsonl"
        assert _read(os.path.join(dirs["port"], name)) == _read(
            os.path.join(dirs["ref"], name))
    feats = sorted(glob.glob(os.path.join(dirs["ref"], "feats", "*",
                                          "*.npy")))
    assert len(feats) == 13
    for path in feats:
        want = np.load(path)
        got = np.load(os.path.join(dirs["port"],
                                   os.path.relpath(path, dirs["ref"])))
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.shape[1] == 80 and got.shape[0] > 0
        np.testing.assert_allclose(got, want, rtol=FEAT_TOL, atol=FEAT_TOL)
    with open(os.path.join(dirs["port"], "us.jsonl")) as f:
        rec = json.loads(f.readline())
    # the reference's keys: ``speaker`` is dropped, ``wav`` kept
    assert list(rec) == ["id", "wav", "feats", "text", "phones",
                         "num_samples"]
    _assert_stats(*(os.path.join(dirs[k], "cmvn_stats.json")
                    for k in ("port", "ref")), nested=False)


def _assert_stats(got_path, want_path, nested):
    with open(got_path) as f, open(want_path) as g:
        got, want = json.load(f), json.load(g)
    pairs = ([(got[k], want[k]) for k in want] if nested else [(got, want)])
    assert got.keys() == want.keys()
    for a, b in pairs:
        assert a["frames"] == b["frames"] > 0
        for key in ("mean", "var"):
            x, y = np.asarray(a[key]), np.asarray(b[key])
            assert x.shape == y.shape == (80,)
            assert np.all(np.abs(x - y) <= STATS_TOL * (1 + np.abs(y))), key


def test_cmvn_stats_are_float64_moments_of_the_saved_features(prepared):
    dirs, _ = prepared
    arrays = [np.load(p).astype(np.float64) for p in sorted(glob.glob(
        os.path.join(dirs["port"], "feats", "*", "*.npy")))]
    frames = np.concatenate(arrays)
    with open(os.path.join(dirs["port"], "cmvn_stats.json")) as f:
        stats = json.load(f)
    s1 = sum(a.sum(0) for a in arrays)
    s2 = sum((a ** 2).sum(0) for a in arrays)
    mean = s1 / len(frames)
    assert stats["frames"] == len(frames)
    np.testing.assert_array_equal(stats["mean"], mean)
    np.testing.assert_array_equal(stats["var"], s2 / len(frames) - mean ** 2)
    np.testing.assert_allclose(stats["var"], frames.var(0), rtol=1e-9)


def test_speaker_cmvn_matches_reference(prepared):
    dirs, _ = prepared
    paths = [os.path.join(dirs[k], "speaker_cmvn.json")
             for k in ("port", "ref")]
    _assert_stats(*paths, nested=True)
    with open(paths[0]) as f:
        assert sorted(json.load(f)) == ["spk0", "spk1"]


@pytest.mark.parametrize("kind", VOCABS)
def test_vocab_matches_reference(prepared, kind):
    dirs, _ = prepared
    name = f"vocab_{kind}.json"
    assert _read(os.path.join(dirs["port"], name)) == _read(
        os.path.join(dirs["ref"], name))
    with open(os.path.join(dirs["port"], name)) as f:
        vocab = json.load(f)
    assert vocab["type"] == {"char": "CharTokenizer", "phone": "PhoneTokenizer",
                             "bpe": "BPETokenizer"}[kind]


@pytest.mark.parametrize("cmd", ["features", "speaker-cmvn"])
def test_feature_commands_default_to_cuda(prepared, tmp_path, cmd):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for a machine without")
    data = str(tmp_path / "data")
    shutil.copytree(prepared[0]["port"], data)
    with pytest.raises(RuntimeError, match="CUDA"):
        prepare_data.main([cmd, "--data-dir", data])


def _feats_only(src: str, dst: str) -> None:
    """A copy of a prepared corpus whose manifests name only the features:
    a record that names a WAV loads the audio, in both packages."""
    shutil.copytree(src, dst)
    for path in glob.glob(os.path.join(dst, "*.jsonl")):
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        with open(path, "w") as f:
            f.writelines(json.dumps({k: v for k, v in r.items()
                                     if k != "wav"}) + "\n" for r in recs)


def test_feats_batch_joint_loss_matches_reference(prepared, tmp_path):
    data = str(tmp_path / "feats_only")
    _feats_only(prepared[0]["port"], data)
    # features' own manifests keep the WAV, which the datasets prefer
    assert "audio" in load_accent_datasets(
        prepared[0]["port"], CharTokenizer.ascii_default())["us"][0]
    tok = CharTokenizer.ascii_default()
    ds = load_accent_datasets(data, tok)["us"]
    ref_ds = ref_load(data, RefCharTokenizer.ascii_default())["us"]
    items = [ds[i] for i in range(4)]
    ref_items = [ref_ds[i] for i in range(4)]
    batch = collate(items, 24000, 16)
    ref_batch = ref_collate(ref_items, 24000, 16)
    assert set(batch) == set(ref_batch) >= {"feats", "feat_lens"}
    for k in ("feats", "feat_lens", "tokens", "token_lens"):
        np.testing.assert_array_equal(batch[k], ref_batch[k])
    cfg = tiny_cfg("transformer", vocab=tok.vocab_size)
    ref_task = RefTask(cfg, tok.sos_eos_id)
    ref_in = {k: jnp.asarray(v) for k, v in ref_batch.items() if k != "texts"}
    params = jax.tree.map(np.asarray, ref_task.init_params(
        jax.random.PRNGKey(0), ref_in))
    want, _ = ref_task.loss_fn(params, ref_in, jax.random.PRNGKey(1), False)
    task = ASRTask(port_cfg(cfg), tok.sos_eos_id, device="cpu")
    pre = task.preprocess({k: torch.from_numpy(v) for k, v in batch.items()
                           if k != "texts"})
    got, _ = task.loss_fn(flax_to_params(params), pre)
    assert np.isfinite(float(want))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_cli_trains_and_tests_on_feats_manifests(prepared, tmp_path, capsys):
    """The port's CLI on the prepared feature manifests, with the BPE
    vocabulary ``vocab`` wrote: two FOMAML steps, then ``test`` with the
    beam search on the held-out accent."""
    data, wd = str(tmp_path / "feats_only"), str(tmp_path / "wd")
    _feats_only(prepared[0]["port"], data)
    tiny = ["-o", "model.d_model=32", "-o", "model.num_heads=2",
            "-o", "model.d_ff=64", "-o", "model.num_encoder_layers=2",
            "-o", "model.num_decoder_layers=2", "-o", "model.dtype=float32"]
    assert cli.main([
        "--mode", "train", "--config",
        os.path.join(REPO, "configs", "config3_fomaml.yaml"),
        "--data-dir", data, "--workdir", wd, "--max-steps", "2",
        "--device", "cpu", "-o", "data.vocab=bpe",
        "-o", "data.heldout_accents=india", "-o", "meta.tasks_per_batch=2",
        "-o", "meta.k_support=2", "-o", "meta.k_query=2", *tiny]) == 0
    assert cli.main(["--mode", "test", "--workdir", wd, "--device", "cpu",
                     "--decode-mode", "beam"]) == 0
    with open(os.path.join(wd, "test_results.json")) as f:
        res = json.load(f)
    assert list(res) == ["india"] and np.isfinite(res["india"]["wer"])
    with open(os.path.join(wd, "hyps_india.jsonl")) as f:
        assert len(f.readlines()) == 2
    with open(os.path.join(data, "vocab_bpe.json")) as f:
        assert json.load(f)["type"] == "BPETokenizer"
