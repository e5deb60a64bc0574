"""Port vs reference: the shallow-fusion sweep
(``metaasr_tpu_torch/scripts/fusion_eval.py`` against
``scripts/fusion_eval.py``).

The reference script imports the JAX package at module level, so it is
read with ``ast``, as ``tests/test_torch_flagship.py`` reads the flagship:
its argument parser, its LM corpus block, its LM block (with
``train_char_lm`` and ``save_params_npz`` recorded), its config block and
the multitask arm's evaluation config, and its paired sweep run on the
reference's trainers.

- The flags: names, types, choices and defaults, ``/tmp`` under the
  system's temporary directory, ``--device`` added.
- The configs: ``multi``, ``fomaml`` and ``reptile``, with and without
  ``--tiny`` (whose block keeps config3's bfloat16), equal field for field.
- The LM: the corpus (held-out accent excluded), the recipe passed to
  ``train_char_lm`` and the printed line; the port's npz read by the
  reference's ``load_params_npz`` with the same dims from shapes.
- The sweep at equal weights (``tests/test_torch_eval.py``'s tiny fp32
  trainers, one LSTM LM in both packages) at weights 0 and 0.5: every entry
  equal to the reference's, key for key and value for value, the same
  printed lines and file; the 0 column's hypotheses and scores equal to
  decodes with ``lm_ckpt`` unset, the 0.5 column's scores not.
- ``main --tiny --device cpu`` end to end for ``multi`` and ``fomaml``.
"""

import argparse
import ast
import dataclasses
import json
import os
import tempfile
import time
import types

import numpy as np
import pytest
import torch

from metaasr_tpu.data.dataset import Manifest as RefManifest
from metaasr_tpu.data.dataset import discover_accents as ref_discover
from metaasr_tpu.models.lm import lm_dims_from_params as ref_lm_dims
from metaasr_tpu.train.checkpoint import load_params_npz as ref_load_npz
from metaasr_tpu_torch.data.tokenizer import CharTokenizer
from metaasr_tpu_torch.models import lm as lm_mod
from metaasr_tpu_torch.scripts import fusion_eval as fusion
from metaasr_tpu_torch.scripts.flagship_results import ensure_corpus
from metaasr_tpu_torch.train import checkpoint
from metaasr_tpu_torch.train.checkpoint import load_params_npz, save_tree_npz
from metaasr_tpu_torch.weights import lm_state_dict_to_flax
from tests.test_torch_decode_bench import (
    reference_ast,
    reference_constants,
    reference_keys,
)
from tests.test_torch_eval import corpora, trainers  # noqa: F401 (fixtures)
from tests.test_torch_flagship import _run, reference_make_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SCRIPT = "fusion_eval.py"
ALGOS = ("multi", "fomaml", "reptile")


# ---------------- the reference script, read by ast ----------------

def _main_body() -> list:
    return next(n for n in reference_ast(SCRIPT).body
                if isinstance(n, ast.FunctionDef) and n.name == "main").body


def _span(body: list, first: str, stop: str | None) -> list:
    """Statements of ``body`` from the first that starts with ``first`` up
    to the next that starts with ``stop`` (to the end for None)."""
    src = [ast.unparse(s) for s in body]
    i = next(j for j, s in enumerate(src) if s.startswith(first))
    if stop is None:
        return body[i:]
    return body[i:next(j for j in range(i + 1, len(src))
                       if src[j].startswith(stop))]


def reference_parser() -> argparse.ArgumentParser:
    stmts = [s for s in _main_body()
             if ast.unparse(s).startswith(("ap = ", "ap.add_argument("))]
    return _run(stmts, {"argparse": argparse})["ap"]


def reference_configs(args, vocab_size: int):
    """(cfg, cfg2 or None) of the reference's config block and, for
    ``multi``, its evaluation config."""
    body = _main_body()
    ns = _run(_span(body, "cfg = make_cfg(", "dsets = "),
              {"make_cfg": reference_make_cfg(), "args": args,
               "tok": types.SimpleNamespace(vocab_size=vocab_size)})
    if args.algo != "multi":
        return ns["cfg"], None
    branch = next(s for s in body if isinstance(s, ast.If)
                  and ast.unparse(s.test) == "args.algo == 'multi'").body
    return ns["cfg"], _run(_span(branch, "cfg2 = make_cfg(", "meta_tr = "),
                           ns)["cfg2"]


# ---------------- the flags and the configs ----------------

def test_flags_are_the_reference(tmp_path, monkeypatch):
    """Every reference flag with its type, choices and default; ``/tmp``
    under the system's temporary directory; ``--device`` added, and
    without it ``main`` asks for CUDA (absent here) before anything else;
    the constants and the corpus size the reference's."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ref = {a.dest: a for a in reference_parser()._actions}
    got = {a.dest: a for a in fusion.build_parser()._actions}
    assert got.pop("device").default is None
    assert set(got) == set(ref) and len(ref) == 10   # help + 9 flags
    for dest, want in ref.items():
        have = got[dest]
        assert have.option_strings == want.option_strings, dest
        assert (have.type, have.choices, have.nargs, have.const) == (
            want.type, want.choices, want.nargs, want.const), dest
        default = want.default
        if isinstance(default, str) and default.startswith("/tmp/"):
            default = os.path.join(str(tmp_path), default[len("/tmp/"):])
        assert have.default == default, dest
    assert got["data_dir"].default == str(tmp_path / "flagship_synth_hard")
    consts = reference_constants(SCRIPT)
    assert fusion.ADAPT_SEEDS == consts["ADAPT_SEEDS"]
    gen = next(n for n in ast.walk(reference_ast(SCRIPT))
               if isinstance(n, ast.Call)
               and ast.unparse(n.func) == "generate_dataset")
    assert {k.arg: ast.literal_eval(k.value) for k in gen.keywords
            if k.arg != "accents"} == {
        "utts_per_accent": fusion.UTTS_PER_ACCENT, "words_per_utt": (3, 6),
        "seed": 0, "profile": "hard"}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fusion.main(["--data-dir", str(tmp_path / "none")])
    assert not os.path.exists(tmp_path / "none")


FLAG_SETS = [[], ["--tiny"], ["--seed", "2"],
             ["--steps", "7", "--tiny", "--seed", "1"]]


@pytest.mark.parametrize("flags", FLAG_SETS,
                         ids=lambda f: " ".join(f) or "defaults")
def test_arm_configs_are_the_reference(flags):
    """Exact, every field (dataclasses.asdict), for each ``--algo``; under
    ``--tiny`` the model stays bfloat16 and the multitask arm's evaluation
    config shares the arm's model config, as the reference's block
    leaves them."""
    for algo in ALGOS:
        argv = [*flags, "--algo", algo, "--data-dir", "/data/x"]
        args = fusion.build_parser().parse_args(argv)
        want, want2 = reference_configs(reference_parser().parse_args(argv),
                                        30)
        got, got2 = fusion.arm_configs(args, "/data/x", 30)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), argv
        assert (got2 is None) == (want2 is None) == (algo != "multi")
        if got2 is not None:
            assert dataclasses.asdict(got2) == dataclasses.asdict(want2)
            assert (got2.model is got.model) == (want2.model is want.model)
            assert (got2.model is got.model) == args.tiny
        assert got.model.dtype == "bfloat16"
        assert got.model.d_model == (32 if args.tiny else 256)


# ---------------- the LM ----------------

def test_lm_corpus_recipe_and_npz_are_the_reference(tmp_path, monkeypatch,
                                                    capsys):
    """The corpus block's transcripts (15 training accents, ``tango``
    left out); the LM block's ``train_char_lm`` arguments, npz path and
    printed line, at full size and ``--tiny``, with the port's LM on the
    device it is given; then a real ``--tiny`` LM's npz read by the
    reference's ``load_params_npz``: the same arrays and dims."""
    data = str(tmp_path / "data")
    ensure_corpus(data, "hard", 2)
    body = _main_body()
    want = _run(_span(body, "texts = []", "t0 = "),
                {"args": types.SimpleNamespace(data_dir=data), "os": os,
                 "discover_accents": ref_discover, "Manifest": RefManifest,
                 "HELDOUT": "tango"})["texts"]
    texts = fusion.lm_corpus(data)
    assert texts == want and len(texts) == 15 * 2
    tango = RefManifest.load(os.path.join(data, "tango.jsonl")).utts
    assert not {u.text for u in tango} & set(texts)

    calls = []

    def fake_train(*args, **kwargs):
        calls.append((args, kwargs))
        return None, {}, 1.25

    tok = CharTokenizer.ascii_default()
    for tiny in (False, True):
        saved = []
        ns = {"args": types.SimpleNamespace(data_dir=data, tiny=tiny,
                                            lm_steps=10),
              "train_char_lm": fake_train, "texts": texts, "tok": tok,
              "save_params_npz": lambda p, _: saved.append(p), "os": os,
              "time": time}
        _run(_span(body, "t0 = ", "cfg = make_cfg("), ns)
        printed = capsys.readouterr().out
        ref_call = calls.pop()
        saved_port = []
        monkeypatch.setattr(lm_mod, "train_char_lm", fake_train)
        monkeypatch.setattr(checkpoint, "save_tree_npz",
                            lambda p, _: saved_port.append(p))
        path, nll = fusion.train_fusion_lm(texts, tok, 10, tiny, data,
                                           torch.device("cpu"))
        args, kwargs = calls.pop()
        assert kwargs.pop("device") == torch.device("cpu")
        assert (args, kwargs) == ref_call
        assert capsys.readouterr().out == printed
        assert (path, nll) == (saved[0], 1.25) == (ns["lm_path"],
                                                   ns["lm_nll"])
        assert saved_port == [path]
        monkeypatch.undo()

    path, nll = fusion.train_fusion_lm(texts, tok, 2, True, data, "cpu")
    assert np.isfinite(nll)
    ref_tree, tree = ref_load_npz(path), load_params_npz(path)
    assert ref_lm_dims(ref_tree) == lm_mod.lm_dims_from_params(tree) == {
        "vocab_size": 30, "embed_dim": 16, "hidden": 16, "layers": 1}
    flat = lambda t, p="": {  # noqa: E731
        k2: v2 for k, v in t.items() for k2, v2 in (
            flat(v, f"{p}{k}/").items() if isinstance(v, dict)
            else [(f"{p}{k}", v)])}
    assert flat(ref_tree).keys() == flat(tree).keys()
    for k, v in flat(ref_tree).items():
        np.testing.assert_array_equal(v, flat(tree)[k])


# ---------------- the paired sweep at equal weights ----------------

@pytest.fixture(scope="module")
def lm_npz(tmp_path_factory):
    """One LSTM LM (vocab 30, embedding 8, 1 x 16) from a seeded generator,
    written in the Flax layout that both trainers load."""
    model = lm_mod.LSTMLM(30, 8, 16, 1,
                          generator=torch.Generator().manual_seed(3))
    path = str(tmp_path_factory.mktemp("lm") / "lm.npz")
    save_tree_npz(path, lm_state_dict_to_flax(model.state_dict()))
    return path


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_sweep_matches_reference(trainers, lm_npz, tmp_path,  # noqa: F811
                                 monkeypatch, capsys):
    """The reference's sweep block (``ds = heldout[HELDOUT]`` to the end of
    the weight loop) and ``sweep`` at weights 0 and 0.5: the results, the
    printed lines and the ``--out`` file equal, the same adaptation calls;
    then each weight-0 decode against the same decode with ``lm_ckpt``
    unset and the weight at 0.5 (hypotheses and scores equal), and the
    0.5 decodes' scores against the 0 decodes' (not all equal)."""
    ref, port, ref_params, params = trainers
    for tr in (ref, port):
        monkeypatch.setattr(tr.cfg.train, "lm_ckpt", "")
        monkeypatch.setattr(tr.cfg.train, "lm_weight", 0.0)
    ds_ref, ds = ref.heldout_datasets["delta"], port.heldout_datasets["delta"]
    adapts = {"ref": [], "port": []}
    for name, tr in (("ref", ref), ("port", port)):
        def meta_adapt(*args, _fn=tr.meta_adapt, _rec=adapts[name],
                       **kwargs):
            out = _fn(*args, **kwargs)
            _rec.append((kwargs["seed"], kwargs["adapt_steps"],
                         list(out[1])))
            return out
        monkeypatch.setattr(tr, "meta_adapt", meta_adapt)
    decodes, decode = [], port.decode

    def dumped(p, dset, idx, **kwargs):
        path = str(tmp_path / f"dump{len(decodes)}.jsonl")
        out = decode(p, dset, idx, dump_path=path, **kwargs)
        decodes.append((port.cfg.train.lm_weight, p, list(idx), kwargs,
                        _records(path)))
        return out

    monkeypatch.setattr(port, "decode", dumped)
    weights = [0.0, 0.5]
    header = {"algo": "multi", "steps": 2, "seed": 0, "lm_nll": 1.5}
    want = _run(_span(_main_body(), "ds = heldout[HELDOUT]", "print(f"),
                {"heldout": {"tango": ds_ref}, "HELDOUT": "tango",
                 "meta_tr": ref, "lm_path": lm_npz, "weights": weights,
                 "state": types.SimpleNamespace(params=ref_params),
                 "args": types.SimpleNamespace(
                     out=str(tmp_path / "want.json"), **{
                         k: header[k] for k in ("algo", "steps", "seed")}),
                 "lm_nll": header["lm_nll"], "np": np, "json": json,
                 **reference_constants(SCRIPT)})["results"]
    printed = capsys.readouterr().out
    got = fusion.sweep(port, params, ds, lm_npz, weights,
                       {**header, "weights": {}}, str(tmp_path / "got.json"))
    assert capsys.readouterr().out == printed
    assert list(got["weights"]) == ["0.0", "0.5"]
    assert got == want
    with open(tmp_path / "want.json") as a, open(tmp_path / "got.json") as b:
        assert json.load(a) == json.load(b) == got
    assert adapts["port"] == adapts["ref"]
    assert [a[:2] for a in adapts["port"]] == [(0, 5), (1, 5), (2, 5)]
    assert port.cfg.train.lm_ckpt == lm_npz

    assert [d[0] for d in decodes] == [0.0] * 4 + [0.5] * 4
    port.cfg.train.lm_ckpt, port.cfg.train.lm_weight = "", 0.5
    for w, p, idx, kwargs, recs in decodes[:4]:
        path = str(tmp_path / "unset.jsonl")
        decode(p, ds, idx, dump_path=path, **kwargs)
        assert _records(path) == recs
    assert all(len(r) for *_, r in decodes)
    assert any(a["score"] != b["score"]
               for (*_, r0), (*_, r5) in zip(decodes[:4], decodes[4:])
               for a, b in zip(r0, r5))


# ---------------- main end to end ----------------

@pytest.fixture
def short_search(monkeypatch):
    """The recipe with ``data.max_tokens`` 8 in place of 48: a barely
    trained model's search runs to ``max_tokens`` steps, and this checks
    the flow and the layout (the recipe is held exactly above)."""
    orig = fusion.make_cfg

    def make_cfg(*args, **kwargs):
        cfg = orig(*args, **kwargs)
        cfg.data.max_tokens = 8
        return cfg

    monkeypatch.setattr(fusion, "make_cfg", make_cfg)


@pytest.mark.parametrize("algo", ["multi", "fomaml"])
def test_main_end_to_end(algo, short_search, tmp_path, monkeypatch, capsys):
    """``main --tiny --device cpu`` on a hard-profile corpus of 10
    utterances an accent made first (``main`` reuses it): the LM trained on
    the CPU it was given, the default ``--out`` under the temporary
    directory holding what ``main`` returns, the reference's keys, each
    weight's printed line, the arm's workdirs."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    data = str(tmp_path / "data")
    ensure_corpus(data, "hard", 10)
    devices = []
    train = lm_mod.train_char_lm

    def train_char_lm(*args, **kwargs):
        devices.append(kwargs["device"])
        return train(*args, **kwargs)

    monkeypatch.setattr(lm_mod, "train_char_lm", train_char_lm)
    res = fusion.main(["--tiny", "--device", "cpu", "--steps", "2",
                       "--lm-steps", "3", "--algo", algo, "--weights",
                       "0,0.5", "--data-dir", data, "--workdir",
                       str(tmp_path / "runs")])
    assert devices == [torch.device("cpu")]
    out = tmp_path / f"fusion_sweep_{algo}_s0.json"
    with open(out) as f:
        assert json.load(f) == res
    keys = reference_keys(SCRIPT, "main")
    assert set(res) | {"zero_shot_beam_wer", "adapt5_beam", "mean", "std",
                       "adapt5_beam_draws"} == keys
    assert (res["algo"], res["steps"], res["seed"]) == (algo, 2, 0)
    assert np.isfinite(res["lm_nll"])
    assert list(res["weights"]) == ["0.0", "0.5"]
    for entry in res["weights"].values():
        assert set(entry) == {"zero_shot_beam_wer", "adapt5_beam",
                              "adapt5_beam_draws"}
        assert set(entry["adapt5_beam"]) == {"mean", "std"}
        assert len(entry["adapt5_beam_draws"]) == 3
        assert all(np.isfinite(w) and w >= 0 for w in [
            entry["zero_shot_beam_wer"], *entry["adapt5_beam_draws"]])
    printed = capsys.readouterr().out.splitlines()
    assert [json.loads(line) for line in printed
            if line.startswith('{"0.')] == [
        {w: e} for w, e in res["weights"].items()]
    assert printed[-1] == f"wrote {out}"
    assert os.path.exists(os.path.join(data, "fusion_lm.npz"))
    runs = sorted(os.listdir(tmp_path / "runs"))
    assert runs == ([f"hard_{algo}_s0", f"hard_{algo}_s0_eval"]
                    if algo == "multi" else [f"hard_{algo}_s0"])
