"""Port vs reference: the quality scripts (``metaasr_tpu_torch/scripts/
{flagship_results,demo_meta_adaptation,kshot_curve}.py`` against
``scripts/{flagship_results,demo_meta_adaptation,kshot_curve}.py``).

- The recipes: the reference scripts configure JAX when imported, so they
  are read with ``ast``. Their ``make_cfg`` bodies and kshot's ``--tiny``
  block, run on the reference's ``Config``, equal the port's functions run
  on the port's ``Config``; ``HELDOUT``, ``ADAPT_SEEDS`` and both scripts'
  argparse defaults are the reference's.
- The protocol at equal weights: a tiny FOMAML trainer of each package
  (``tests/test_torch_eval.py``'s fixtures: d 32, 2 heads, 2 + 2 layers,
  beam 3, SpecAugment off, dropout 0, the port's seeded weights in both):
  kshot's k = 0 point is the reference's zero-shot beam WER with the same
  texts, and its k = 1 draw adapts on the reference's support split.
- The scripts end to end on the CPU, on a 10-utterance-per-accent corpus:
  ``kshot_curve.main --tiny`` over a FOMAML, a multitask and a Meta-SGD
  workdir trained two steps by the port's trainers under the tiny flagship
  recipe; ``demo_meta_adaptation.main --steps 2`` with its ``make_cfg`` cut
  to the tests' width. The outputs have the reference's keys and headers,
  every WER is finite, and ``RESULTS.md`` is untouched.
"""

import ast
import dataclasses
import hashlib
import json
import math
import os
import tempfile

import numpy as np
import pytest
import torch

from metaasr_tpu.config import Config as RefConfig
from metaasr_tpu.config import load_config as ref_load_config
from metaasr_tpu.data import sampler as ref_sampler
from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.data import sampler, synthetic
from metaasr_tpu_torch.data.dataset import load_accent_datasets
from metaasr_tpu_torch.data.tokenizer import CharTokenizer
from metaasr_tpu_torch.scripts import demo_meta_adaptation as demo
from metaasr_tpu_torch.scripts import flagship_results as flagship
from metaasr_tpu_torch.scripts import kshot_curve as kshot
from metaasr_tpu_torch.task import ASRTask
from metaasr_tpu_torch.train.meta_train import MetaASRTrainer
from metaasr_tpu_torch.train.mono import MultitaskASRTrainer
from tests.test_torch_decode_bench import reference_ast, reference_constants
from tests.test_torch_eval import corpora, trainers  # noqa: F401 (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG3 = os.path.join(REPO, "configs", "config3_fomaml.yaml")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the beam search is many
    small ops, and with the suite's workers sharing the cores torch's
    thread pool only waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------- the reference scripts, read by ast ----------------

def _function(script: str, name: str) -> ast.FunctionDef:
    return next(n for n in reference_ast(script).body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _compiled(nodes, namespace: dict) -> dict:
    code = compile(ast.fix_missing_locations(ast.Module(body=nodes,
                                                        type_ignores=[])),
                   "<reference>", "exec")
    exec(code, namespace)
    return namespace


def reference_make_cfg(script: str):
    """The reference script's ``make_cfg``, defined over the reference's
    ``Config``/``load_config`` and the script's own constants."""
    ns = {"Config": RefConfig, "load_config": ref_load_config,
          "CFG": CONFIG3, **reference_constants(script)}
    return _compiled([_function(script, "make_cfg")], ns)["make_cfg"]


def reference_tiny_block(cfg) -> None:
    """kshot_curve.py's ``if args.tiny:`` body, run on ``cfg``."""
    block = next(n for n in ast.walk(_function("kshot_curve.py", "main"))
                 if isinstance(n, ast.If) and ast.unparse(n.test)
                 == "args.tiny")
    _compiled(block.body, {"cfg": cfg})


def reference_defaults(script: str) -> dict:
    """{dest: default} of every ``ap.add_argument`` in the script's main."""
    out = {}
    for n in ast.walk(_function(script, "main")):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", "") \
                == "add_argument":
            kw = {k.arg: k.value for k in n.keywords}
            dest = n.args[0].value.lstrip("-").replace("-", "_")
            if "default" in kw:
                out[dest] = ast.literal_eval(kw["default"])
            else:
                out[dest] = (False if "action" in kw and ast.literal_eval(
                    kw["action"]) == "store_true" else None)
    return out


def _as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


# ---------------- the recipes ----------------

@pytest.mark.parametrize("algo", ["fomaml", "multi"])
def test_demo_make_cfg_is_the_reference(algo):
    ref = reference_make_cfg("demo_meta_adaptation.py")
    for steps in (800, 7):
        got = demo.make_cfg(algo, steps)
        assert isinstance(got, Config)
        assert _as_dict(got) == _as_dict(ref(algo, steps))
    assert demo.HELDOUT == reference_constants(
        "demo_meta_adaptation.py")["HELDOUT"] == "tango"


@pytest.mark.parametrize("algo", ["fomaml", "maml", "reptile", "multi"])
def test_flagship_make_cfg_is_the_reference(algo):
    ref = reference_make_cfg("flagship_results.py")
    for seed in (0, 1):
        for grad_dtype in ("float32", "bfloat16"):
            got = flagship.make_cfg(algo, 1500, "/data/x", seed=seed,
                                    grad_dtype=grad_dtype)
            want = ref(algo, 1500, "/data/x", seed=seed,
                       grad_dtype=grad_dtype)
            assert _as_dict(got) == _as_dict(want), (seed, grad_dtype)
    assert got.meta.algo == (algo if algo != "multi" else "fomaml")
    assert got.data.heldout_accents == ("tango",)
    assert _as_dict(flagship.make_cfg(algo, 3, "d")) \
        == _as_dict(ref(algo, 3, "d"))


def test_flagship_constants_and_kshot_tiny_block():
    consts = reference_constants("flagship_results.py")
    assert flagship.HELDOUT == consts["HELDOUT"] == kshot.HELDOUT
    assert flagship.ADAPT_SEEDS == consts["ADAPT_SEEDS"] == (0, 1, 2)
    assert os.path.samefile(flagship.CFG, CONFIG3)
    for label in ("fomaml", "multi", "fomaml@metasgd", "fomaml@bf16",
                  "fomaml@conformer"):
        want = ref_make_cfg_for(label)
        reference_tiny_block(want)
        got = kshot.run_config(label, "/data/x", 0, True, 30)
        assert _as_dict(got) == _as_dict(want), label
    cfg = flagship.make_cfg("fomaml", 1, "d")
    kshot.apply_tiny(cfg)
    assert cfg.frontend.use_pallas is False and cfg.model.d_model == 32


def ref_make_cfg_for(label: str):
    """The reference kshot's per-label config, before ``--tiny``."""
    cfg = reference_make_cfg("flagship_results.py")(
        "fomaml", 1, "/data/x", seed=0,
        grad_dtype="bfloat16" if "@bf16" in label else "float32")
    cfg.model.vocab_size = 30
    if "@conformer" in label:
        cfg.model.encoder = "conformer"
    if "@metasgd" in label:
        cfg.meta.learn_inner_lr = True
    return cfg


def _under_tmp(defaults: dict, tmp: str) -> dict:
    """The reference's ``/tmp/...`` defaults moved under ``tmp``, where the
    port puts them (the system's temporary directory)."""
    return {k: os.path.join(tmp, v[len("/tmp/"):])
            if isinstance(v, str) and v.startswith("/tmp/") else v
            for k, v in defaults.items()}


def test_argparse_defaults_are_the_reference(tmp_path, monkeypatch):
    """The reference's defaults, with its fixed ``/tmp`` paths under the
    system's temporary directory (``$TMPDIR``): two checkouts' runs, or
    runs under different users, do not meet in one workdir."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got = vars(demo.build_parser().parse_args([]))
    assert got.pop("device") is None
    want = reference_defaults("demo_meta_adaptation.py")
    assert want["workdir"] == "/tmp/demo_runs"
    assert got == _under_tmp(want, str(tmp_path))
    got = vars(kshot.build_parser().parse_args(["--runs", "a=b"]))
    assert got.pop("device") is None and got.pop("runs") == "a=b"
    want = reference_defaults("kshot_curve.py")
    assert want.pop("runs") is None
    assert got == _under_tmp(want, str(tmp_path))
    assert got["out"] == str(tmp_path / "kshot_curve.json")


# ---------------- the protocol at equal weights ----------------

def test_kshot_points_match_reference(trainers, tmp_path):  # noqa: F811
    """k = 0: the port's point is the reference's zero-shot beam WER over
    the utterances from index 8 on, exactly, with the same texts. k = 1,
    draw 0: the port adapts on the reference's support split and decodes
    the reference's test indices."""
    ref, port, ref_params, params = trainers
    ds_ref, ds = ref.heldout_datasets["delta"], port.heldout_datasets["delta"]
    idx = kshot.zero_shot_indices(ds)
    assert idx == list(range(len(ds_ref)))[8:] and len(idx) == 2
    want = ref.decode(ref_params, ds_ref, idx, max_utts=4, mode="beam",
                      dump_path=str(tmp_path / "want.jsonl"))
    point = kshot.curve_point(port, params, ds, 0, 2, 2, 4)
    assert point == {"mean": round(want["wer"], 4), "std": 0.0}
    got = port.decode(params, ds, idx, max_utts=4, mode="beam",
                      dump_path=str(tmp_path / "got.jsonl"))
    assert got["wer"] == want["wer"]
    texts = [[(r["hyp"], r["ref"]) for r in map(json.loads, open(p))]
             for p in (tmp_path / "got.jsonl", tmp_path / "want.jsonl")]
    assert texts[0] == texts[1] and len(texts[0]) == 2

    _, want_test = ref.meta_adapt(ref_params, ds_ref, adapt_steps=1,
                                  k_support=1, seed=0)
    _, got_test = port.meta_adapt(params, ds, adapt_steps=1, k_support=1,
                                  seed=0)
    assert got_test == want_test and len(got_test) == len(ds) - 1
    cap, u = port._num_samples_cap(), port.cfg.data.max_tokens
    want_s, _ = ref_sampler.support_query_split(ds_ref, 1, cap, u, seed=0)
    got_s, _ = sampler.support_query_split(ds, 1, cap, u, seed=0)
    assert got_s["texts"] == want_s["texts"]
    np.testing.assert_array_equal(got_s["audio"], want_s["audio"])
    one = kshot.curve_point(port, params, ds, 1, 1, 1, 4)
    assert set(one) == {"mean", "std", "draws"} and len(one["draws"]) == 1


# ---------------- the scripts end to end ----------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("quality_corpus"))
    synthetic.generate_dataset(d, utts_per_accent=10, words_per_utt=(1, 3),
                               seed=0)
    return d


def _train_tiny(corpus, label, wd, steps=2):
    """A workdir trained ``steps`` steps by the port's trainers under the
    tiny flagship recipe (the reference's flagship arms, at kshot's
    ``--tiny`` width)."""
    tok = CharTokenizer.ascii_default()
    algo = label.split("@")[0]
    cfg = flagship.make_cfg(algo, steps, corpus)
    cfg.model.vocab_size = tok.vocab_size
    cfg.meta.learn_inner_lr = "@metasgd" in label
    kshot.apply_tiny(cfg)
    dsets = load_accent_datasets(corpus, tok)
    heldout = {flagship.HELDOUT: dsets.pop(flagship.HELDOUT)}
    task = ASRTask(cfg, tok.sos_eos_id, device="cpu")
    if algo == "multi":
        tr = MultitaskASRTrainer(cfg, task, dsets, None, tok, wd,
                                 device="cpu")
        return tr.train(max_steps=steps)
    tr = MetaASRTrainer(cfg, task, dsets, heldout, tok, wd, device="cpu")
    return tr.meta_train(max_steps=steps)


def _demo_keys() -> set:
    """The keys of the demo's per-arm entry, read from the reference:
    string keys, and the f-string key expanded over its seed loop."""
    fn = _function("demo_meta_adaptation.py", "main")
    seeds = next(ast.literal_eval(n.iter) for n in ast.walk(fn)
                 if isinstance(n, ast.For)
                 and getattr(n.target, "id", "") == "seed")
    keys = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Dict):
            keys |= {k.value for k in n.keys if isinstance(k, ast.Constant)}
        if isinstance(n, ast.Assign) and isinstance(n.targets[0],
                                                    ast.Subscript) \
                and ast.unparse(n.targets[0].value) == "entry":
            sl = n.targets[0].slice
            if isinstance(sl, ast.Constant):
                keys.add(sl.value)
            elif isinstance(sl, ast.JoinedStr):
                keys |= {eval(compile(ast.Expression(sl), "<k>", "eval"),
                              {"seed": s}) for s in seeds}
    return keys


def _demo_headers() -> list:
    """The markdown lines the reference writes as string constants (the
    title and the table's header rows)."""
    fn = _function("demo_meta_adaptation.py", "main")
    lines = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "lines")
    return [e.value for e in lines.elts if isinstance(e, ast.Constant)
            and e.value.startswith(("#", "|"))]


def _finite_wer(w) -> bool:
    return isinstance(w, float) and math.isfinite(w) and w >= 0.0


def test_kshot_and_demo_run_end_to_end(corpus, tmp_path, monkeypatch,
                                       capsys):
    results_md = os.path.join(REPO, "RESULTS.md")
    with open(results_md, "rb") as f:
        before = hashlib.sha256(f.read()).hexdigest()
    monkeypatch.chdir(tmp_path)
    runs = {}
    for label in ("fomaml", "multi", "fomaml@metasgd"):
        wd = str(tmp_path / label.replace("@", "_"))
        assert _train_tiny(corpus, label, wd)["step"] == 2
        runs[label] = wd
    out = str(tmp_path / "kshot.json")
    got = kshot.main(["--runs", ",".join(f"{k}={v}" for k, v in runs.items()),
                      "--data-dir", corpus, "--tiny", "--ks", "0,1",
                      "--draws", "2", "--max-utts", "4", "--device", "cpu",
                      "--out", out])
    with open(out) as f:
        assert json.load(f) == got
    printed = capsys.readouterr().out
    for label in runs:
        assert f"[{label}] restored step 2" in printed
    assert list(got) == ["ks", "draws", "adapt_steps", *runs]
    assert (got["ks"], got["draws"], got["adapt_steps"]) == ([0, 1], 2, 5)
    for label in runs:
        curve = got[label]
        assert list(curve) == ["0", "1"]
        assert set(curve["0"]) == {"mean", "std"} and curve["0"]["std"] == 0
        assert set(curve["1"]) == {"mean", "std", "draws"}
        assert len(curve["1"]["draws"]) == 2
        assert all(_finite_wer(w) for w in (curve["0"]["mean"],
                                             curve["1"]["mean"],
                                             *curve["1"]["draws"]))
    assert os.path.isdir(runs["multi"] + "_kshot_eval")

    def tiny(algo, steps):
        cfg = orig(algo, steps)
        m = cfg.model
        m.d_model, m.num_heads, m.d_ff = 32, 2, 64
        m.num_encoder_layers, m.num_decoder_layers = 2, 2
        return cfg

    orig = demo.make_cfg
    monkeypatch.setattr(demo, "make_cfg", tiny)
    md = str(tmp_path / "RESULTS_demo.md")
    argv = ["--steps", "2", "--data-dir", corpus, "--utts-per-accent", "10",
            "--workdir", str(tmp_path / "demo"), "--out", md,
            "--device", "cpu"]
    res = demo.main(argv)
    keys = _demo_keys()
    assert list(res) == ["fomaml", "multi"]
    for algo, entry in res.items():
        assert set(entry) == keys, algo
        for k, v in entry.items():
            if k != "train_seconds":
                assert set(v) == {"wer", "cer"}
                assert _finite_wer(v["wer"]) and _finite_wer(v["cer"])
    with open(md) as f:
        text = f.read()
    lines = text.splitlines()
    for header in _demo_headers():
        assert header in lines, header
    assert sum(line.startswith(("| fomaml |", "| multi |"))
               for line in lines) == 2
    raw = text.split("```json\n", 1)[1].rsplit("\n```", 1)[0]
    assert json.loads(raw) == res
    assert not os.path.exists(tmp_path / "RESULTS.md")
    with open(results_md, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == before

    # a second run into the same workdir would resume at step 2 and train
    # nothing; a corpus of another size would be reused as it is. Both are
    # refused before anything is written.
    with pytest.raises(SystemExit, match="already holds step 2"):
        demo.main(argv)
    other = ["12" if a == "10" else a for a in argv]
    with pytest.raises(SystemExit, match="holds 10 utterances an accent"):
        demo.main(other)
    with open(md) as f:
        assert f.read() == text
