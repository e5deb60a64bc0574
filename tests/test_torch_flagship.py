"""Port vs reference: the flagship quality table
(``metaasr_tpu_torch/scripts/flagship_results.py`` against
``scripts/flagship_results.py``).

The reference script configures JAX when imported, so it is read with
``ast``: its argument parser (every ``ap.add_argument`` of ``main``), its
data block, its per-arm override block and tag block (``main``'s loop
body, from ``cfg = make_cfg(...)`` to the ``--tiny`` block and from ``tag
= ...`` to the ``@widen`` suffix) and its ``evaluate`` and ``_mean_std``
run here on the reference's ``Config``, corpus generator and trainers.

- The arms: over a grid of flag sets (each flag alone, every flag at once,
  ``--tiny``, ``--encoder conformer --grad-dtype bfloat16 --seed 1``) and
  the four algorithms, the port's ``arm_config`` and ``arm_tag`` equal the
  reference's block run on the reference's parse of the same flags.
- The flags: names, types, choices and defaults are the reference's, with
  its ``/tmp`` defaults under the system's temporary directory.
- The data: ``ensure_corpus`` and ``load_tokenizer`` write the reference
  data block's corpus (easy, hard and bpe profiles) and BPE vocabulary
  byte for byte.
- ``evaluate`` at equal weights (``tests/test_torch_eval.py``'s tiny
  trainers: d 32, 2 + 2 layers, beam 3, the port's seeded weights in both
  packages): the entry equal to the reference's, key for key and value
  for value (the hypotheses are equal, so the WERs are exactly equal), and
  each seed's test split the reference's.

``main`` end to end is in ``tests/test_torch_flagship_main.py``, a file of
its own so that the suite's workers run the two halves side by side.
"""

import argparse
import ast
import dataclasses
import json
import os
import tempfile
import types

import numpy as np
import pytest

from metaasr_tpu.config import load_config as ref_load_config
from metaasr_tpu.data import synthetic as ref_synthetic
from metaasr_tpu.data.tokenizer import CharTokenizer as RefCharTokenizer
from metaasr_tpu_torch.scripts import flagship_results as flagship
from tests.test_torch_decode_bench import reference_ast, reference_constants
from tests.test_torch_eval import corpora, trainers  # noqa: F401 (fixtures)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = "flagship_results.py"
ALGOS = ("fomaml", "maml", "reptile", "multi")


# ---------------- the reference script, read by ast ----------------

def _function(name: str) -> ast.FunctionDef:
    return next(n for n in reference_ast(SCRIPT).body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _run(nodes, namespace: dict) -> dict:
    exec(compile(ast.fix_missing_locations(ast.Module(body=list(nodes),
                                                      type_ignores=[])),
                 "<reference>", "exec"), namespace)
    return namespace


def reference_parser() -> argparse.ArgumentParser:
    """The reference's parser: ``main``'s ``ap = ...`` and
    ``ap.add_argument(...)`` statements."""
    stmts = [s for s in _function("main").body
             if ast.unparse(s).startswith(("ap = ", "ap.add_argument("))]
    return _run(stmts, {"argparse": argparse})["ap"]


def _loop_body() -> list:
    return next(n for n in _function("main").body
                if isinstance(n, ast.For)
                and ast.unparse(n.target) == "algo").body


def _span(body: list, first: str, stop: str) -> list:
    """Statements of ``body`` from the one starting with ``first`` up to
    (not including) the one starting with ``stop``."""
    src = [ast.unparse(s) for s in body]
    i = next(j for j, s in enumerate(src) if s.startswith(first))
    k = next(j for j, s in enumerate(src) if s.startswith(stop))
    return body[i:k]


def reference_make_cfg():
    ns = {"load_config": ref_load_config,
          "CFG": os.path.join(REPO, "configs", "config3_fomaml.yaml"),
          **reference_constants(SCRIPT)}
    return _run([_function("make_cfg")], ns)["make_cfg"]


def reference_arm(args, algo: str, data_dir: str, vocab_size: int):
    """(config, tag) of the reference's loop body for ``algo``."""
    body = _loop_body()
    ns = _run(_span(body, "cfg = make_cfg(", "dsets = "),
              {"make_cfg": reference_make_cfg(), "args": args, "algo": algo,
               "data_dir": data_dir,
               "tok": types.SimpleNamespace(vocab_size=vocab_size)})
    tags = _run(_span(body, "tag = ", "wd = "), {"args": args, "algo": algo})
    return ns["cfg"], tags["tag"]


def reference_evaluate():
    ns = {"np": np, "json": json, **reference_constants(SCRIPT)}
    return _run([_function("_mean_std"), _function("evaluate")],
                ns)["evaluate"]


# ---------------- the arms: configs and tags ----------------

ONE_FLAG = [["--steps", "7"], ["--grad-dtype", "bfloat16"], ["--seed", "1"],
            ["--encoder", "conformer"], ["--lr", "1.0"],
            ["--inner-lr", "0.001"], ["--inner-clip", "2.5"],
            ["--learn-inner-lr"], ["--inner-start", "3"],
            ["--adapt-widen", "4"], ["--ctc-candidates", "40"],
            ["--vocab", "bpe"], ["--tasks", "2"], ["--k", "3"],
            ["--adapt-filter", "ctc_head,decoder"], ["--tiny"]]
EVERY_FLAG = [a for flags in ONE_FLAG for a in flags]
FLAG_SETS = [[], *ONE_FLAG, EVERY_FLAG,
             ["--encoder", "conformer", "--grad-dtype", "bfloat16",
              "--seed", "1"]]


@pytest.mark.parametrize("flags", FLAG_SETS,
                         ids=lambda f: " ".join(f) or "defaults")
def test_arm_config_and_tag_are_the_reference(flags):
    """Exact: every field of the config (dataclasses.asdict) and the tag,
    for each algorithm, the multitask arm skipping the meta-only flags."""
    args = flagship.build_parser().parse_args(flags)
    ref_args = reference_parser().parse_args(flags)
    for algo in ALGOS:
        want_cfg, want_tag = reference_arm(ref_args, algo, "/data/x", 30)
        got_cfg = flagship.arm_config(args, algo, "/data/x", 30)
        assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg), \
            (flags, algo)
        assert flagship.arm_tag(args, algo) == want_tag, (flags, algo)
    if flags == EVERY_FLAG:
        assert flagship.arm_tag(args, "multi") == "multi@seed1@bf16@conformer"
        assert flagship.arm_tag(args, "fomaml") == (
            "fomaml@seed1@bf16@conformer@metasgd@ilr0.001@iclip2.5"
            "@anil-ctc_head+decoder@istart3@widen4")
        multi = flagship.arm_config(args, "multi", "/data/x", 30)
        assert (multi.meta.learn_inner_lr, multi.meta.inner_clip,
                multi.meta.adapt_filter, multi.model.d_model) == (
                    False, 0.0, "", 32)


def test_flags_are_the_reference(tmp_path, monkeypatch):
    """Every reference flag with its type, choices and default; the
    ``/tmp`` defaults under the system's temporary directory, which the
    port resolves when the parser is built; ``--device`` added."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ref = {a.dest: a for a in reference_parser()._actions}
    got = {a.dest: a for a in flagship.build_parser()._actions}
    assert got.pop("device").default is None
    assert set(got) == set(ref) and len(ref) == 25   # help + 24 flags
    for dest, want in ref.items():
        have = got[dest]
        assert have.option_strings == want.option_strings, dest
        assert (have.type, have.choices, have.nargs, have.const) == (
            want.type, want.choices, want.nargs, want.const), dest
        default = want.default
        if isinstance(default, str) and default.startswith("/tmp/"):
            default = os.path.join(str(tmp_path), default[len("/tmp/"):])
        assert have.default == default, dest
    assert got["workdir"].default == str(tmp_path / "flagship_runs")
    assert got["data_dir"].default is None
    consts = reference_constants(SCRIPT)
    assert (flagship.HELDOUT, flagship.ADAPT_SEEDS) == (
        consts["HELDOUT"], consts["ADAPT_SEEDS"])


@pytest.mark.parametrize("profile", ["easy", "hard", "bpe"])
def test_corpus_and_vocabulary_are_the_reference(profile, tmp_path, capsys):
    """``ensure_corpus`` and ``load_tokenizer`` against the reference's
    data block (``main`` from ``data_dir = ...`` to the tokenizer) at 2
    utterances an accent: the same manifests and WAV files byte for byte,
    the same vocabulary size, the same printed line and, for ``--vocab
    bpe``, the same ``vocab_bpe.json``."""
    flags = ["--profile", profile, "--utts-per-accent", "2"]
    if profile == "bpe":
        flags += ["--vocab", "bpe", "--bpe-merges", "30"]
    ref_dir, dir_ = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = _run(_span(_function("main").body, "data_dir = ", "results = "),
               {"args": reference_parser().parse_args(
                    [*flags, "--data-dir", ref_dir]), "os": os,
                "generate_dataset": ref_synthetic.generate_dataset,
                "ACCENTS_HARD": ref_synthetic.ACCENTS_HARD,
                "CharTokenizer": RefCharTokenizer,
                **reference_constants(SCRIPT)})
    want_out = capsys.readouterr().out
    args = flagship.build_parser().parse_args([*flags, "--data-dir", dir_])
    flagship.ensure_corpus(dir_, args.profile, args.utts_per_accent)
    tok = flagship.load_tokenizer(dir_, args.vocab, args.bpe_merges)
    assert capsys.readouterr().out == want_out
    assert tok.vocab_size == ref["tok"].vocab_size
    files = sorted(os.path.relpath(os.path.join(root, f), ref_dir)
                   for root, _, fs in os.walk(ref_dir) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(root, f), dir_)
                           for root, _, fs in os.walk(dir_) for f in fs)
    assert len([f for f in files if f.endswith(".jsonl")]) == (
        8 if profile == "easy" else 16)
    assert ("vocab_bpe.json" in files) == (profile == "bpe")
    for f in files:
        with open(os.path.join(ref_dir, f), "rb") as a, \
                open(os.path.join(dir_, f), "rb") as b:
            assert a.read() == b.read(), f


# ---------------- evaluate at equal weights ----------------

def _recording_adapt(cls_or_obj, record: list):
    fn = cls_or_obj.meta_adapt

    def meta_adapt(*args, **kwargs):
        adapted, test_idx = fn(*args, **kwargs)
        record.append((kwargs.get("seed"), kwargs.get("adapt_steps"),
                       list(test_idx)))
        return adapted, test_idx

    return meta_adapt


def test_evaluate_matches_reference(trainers, monkeypatch, capsys):  # noqa: F811
    """The entry equal to the reference's (zero-shot greedy and beam
    {wer, cer}, the 5-step adaptation rows and draws, the averaged row),
    each seed's test split the reference's, and the printed JSON."""
    ref, port, ref_params, params = trainers
    ds_ref, ds = ref.heldout_datasets["delta"], port.heldout_datasets["delta"]
    splits = {"ref": [], "port": []}
    monkeypatch.setattr(ref, "meta_adapt",
                        _recording_adapt(ref, splits["ref"]))
    monkeypatch.setattr(port, "meta_adapt",
                        _recording_adapt(port, splits["port"]))
    want, got = {}, {}
    reference_evaluate()(ref, ref_params, ds_ref, "fomaml", want,
                         avg_params=ref_params)
    printed_ref = capsys.readouterr().out
    flagship.evaluate(port, params, ds, "fomaml", got, avg_params=params)
    assert capsys.readouterr().out == printed_ref
    assert list(got["fomaml"]) == list(want["fomaml"]) == [
        "zero_shot_greedy", "zero_shot_beam", "adapt5_greedy",
        "adapt5_beam", "adapt5_beam_draws", "adapt5_beam_avglast5"]
    for k in ("zero_shot_greedy", "zero_shot_beam"):
        assert set(got["fomaml"][k]) == {"wer", "cer"}
    assert got == want
    assert splits["port"] == splits["ref"]
    assert [s[:2] for s in splits["port"]] == [(0, 5), (1, 5), (2, 5)] * 2
    assert all(len(s[2]) == len(ds) - port.cfg.meta.k_support
               for s in splits["port"])


def test_mean_std_is_the_reference():
    ns = _run([_function("_mean_std")], {"np": np})
    for vals in ([0.5], [0.123456, 0.98765, 0.5], [1.0, 0.0]):
        assert flagship._mean_std(vals) == ns["_mean_std"](vals)
