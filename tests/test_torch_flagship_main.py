"""The flagship quality table's ``main`` end to end
(``metaasr_tpu_torch/scripts/flagship_results.py``): ``main --tiny
--device cpu --steps 2`` on a small corpus of the hard profile over the
four arms, then ``--learn-inner-lr`` with ``--vocab bpe --profile bpe``
writing ``vocab_bpe.json``, then ``--eval-only`` restoring step 2 and
reloading it. The arms' configs, tags, data and ``evaluate`` are held
against the reference in ``tests/test_torch_flagship.py``.
"""

import json
import math
import os

import pytest

from metaasr_tpu_torch.scripts import flagship_results as flagship
from metaasr_tpu_torch.train.meta_train import MetaASRTrainer
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ALGOS = ("fomaml", "maml", "reptile", "multi")


@pytest.fixture
def short_search(monkeypatch):
    """The recipe with ``data.max_tokens`` 8 in place of 48: the search of
    a random model runs to ``max_tokens`` steps, and these tests check the
    flow and the layout (the recipe itself is held exactly above)."""
    orig = flagship.make_cfg

    def make_cfg(*args, **kwargs):
        cfg = orig(*args, **kwargs)
        cfg.data.max_tokens = 8
        return cfg

    monkeypatch.setattr(flagship, "make_cfg", make_cfg)


def _main(corpus, work, *flags, profile="hard"):
    return flagship.main(["--tiny", "--device", "cpu", "--steps", "2",
                          "--utts-per-accent", "10", "--profile", profile,
                          "--data-dir", corpus, "--workdir",
                          os.path.join(work, "runs"), "--out",
                          os.path.join(work, "out.json"), *flags])


def _check_entry(entry: dict, avg: bool) -> None:
    keys = {"zero_shot_greedy", "zero_shot_beam", "adapt5_greedy",
            "adapt5_beam", "adapt5_beam_draws", "train_seconds"}
    assert set(entry) == (keys | {"adapt5_beam_avglast5"} if avg else keys)
    wers = [entry["zero_shot_greedy"]["wer"], entry["zero_shot_beam"]["wer"],
            *entry["adapt5_beam_draws"]]
    for k in ("adapt5_greedy", "adapt5_beam", "adapt5_beam_avglast5"):
        if k in entry:
            assert set(entry[k]) == {"mean", "std"}
            wers += [entry[k]["mean"], entry[k]["std"]]
    assert len(entry["adapt5_beam_draws"]) == 3
    assert all(isinstance(w, float) and math.isfinite(w) and w >= 0
               for w in wers)


def test_main_runs_the_four_arms(short_search, tmp_path, capsys):
    """``--algos fomaml,maml,reptile,multi`` on a corpus of the hard
    profile (16 accents, 10 utterances each) that ``main`` makes: the
    reference's layout, the averaged row for fomaml only, ``--out`` equal
    to what ``main`` returns, each arm's workdir (and the multitask arm's
    ``_eval``); an ``--eval-only`` run with no checkpoint refused."""
    corpus = str(tmp_path / "hard")
    res = _main(corpus, str(tmp_path), "--algos", "fomaml,maml,reptile,multi")
    assert list(res) == ["profile", "steps", "vocab", "vocab_size", *ALGOS]
    assert (res["profile"], res["steps"], res["vocab"],
            res["vocab_size"]) == ("hard", 2, "char", 30)
    for algo in ALGOS:
        _check_entry(res[algo], avg=algo == "fomaml")
        assert sorted(os.listdir(tmp_path / "runs" / f"hard_{algo}" /
                                 "ckpts")) == ["step_1.pt", "step_2.pt"]
    assert os.path.isdir(tmp_path / "runs" / "hard_multi_eval")
    with open(tmp_path / "out.json") as f:
        assert json.load(f) == res
    printed = capsys.readouterr().out
    for algo in ALGOS:
        assert f"[{algo}] trained 2 steps in " in printed
    assert printed.rstrip().endswith(f"wrote {tmp_path / 'out.json'}")
    assert len([f for f in os.listdir(corpus) if f.endswith(".jsonl")]) == 16
    with pytest.raises(SystemExit, match="no checkpoint"):
        _main(corpus, str(tmp_path / "empty"), "--algos", "maml",
              "--eval-only")


def test_main_meta_sgd_bpe_and_eval_only(short_search, tmp_path, capsys,
                                         monkeypatch):
    """``--learn-inner-lr --vocab bpe --profile bpe``: tag
    ``fomaml@metasgd``, the averaged row (a {model, inner_lr} tree averaged
    whole), every adaptation on a {model, inner_lr} tree, and
    ``vocab_bpe.json`` learned and written. Then ``--eval-only`` over the
    same workdir with another ``--bpe-merges``: the vocabulary read back
    (not learned again), step 2 restored, no training and no averaged
    row, the zero-shot rows of the restored state equal to the trained
    run's."""
    trees = []
    orig = MetaASRTrainer.meta_adapt

    def meta_adapt(self, params, *args, **kwargs):
        trees.append(set(params))
        return orig(self, params, *args, **kwargs)

    monkeypatch.setattr(MetaASRTrainer, "meta_adapt", meta_adapt)
    corpus = str(tmp_path / "bpe")
    flags = ["--algos", "fomaml", "--learn-inner-lr", "--vocab", "bpe"]
    res = _main(corpus, str(tmp_path), *flags, "--bpe-merges", "40",
                profile="bpe")
    assert list(res) == ["profile", "steps", "vocab", "vocab_size",
                         "fomaml@metasgd"]
    assert res["vocab"] == "bpe" and res["vocab_size"] > 30
    _check_entry(res["fomaml@metasgd"], avg=True)
    assert trees == [{"model", "inner_lr"}] * 6
    printed = capsys.readouterr().out
    assert json.loads(printed.splitlines()[0]) == {
        "bpe_vocab_size": res["vocab_size"]}
    vocab = os.path.join(corpus, "vocab_bpe.json")
    with open(vocab) as f:
        saved = f.read()
    assert json.loads(saved)["type"] == "BPETokenizer"

    ev = _main(corpus, str(tmp_path), *flags, "--bpe-merges", "7",
               "--eval-only", profile="bpe")
    printed = capsys.readouterr().out
    assert json.loads(printed.splitlines()[0]) == {
        "bpe_vocab_size": res["vocab_size"]}
    assert "[fomaml] eval-only from step 2" in printed
    with open(vocab) as f:
        assert f.read() == saved
    _check_entry(ev["fomaml@metasgd"], avg=False)
    for k in ("zero_shot_greedy", "zero_shot_beam"):
        assert ev["fomaml@metasgd"][k] == res["fomaml@metasgd"][k]
