"""The task mesh's front door (``cli.py --mesh-tasks N``) and the resume of
a multi-process meta-training run in fresh processes, against one process.

Two gloo ranks (``tests/torch_parallel_worker.py``, meeting in a
``FileStore`` under the test's temporary directory) run ``cli.main --mode
train --mesh-tasks 2`` to step 2 in one workdir, then second-order MAML for
2 steps in another; a fresh pair resumes the first workdir to step 4.
Meanwhile this process trains the same config without the flag: FOMAML
straight to step 4, MAML 2 steps. The config is
``torch_parallel_worker.trainer_cfg`` (d=32, 2 heads, 2+2 layers, 4 x
(2+2), SpecAugment, dropout and dither on, a checkpoint every step, a
held-out evaluation every 2). The bar is the reference's for a resumed
multi-process run (``scripts/multihost_trainer_smoke.py:176-182``,
``tests/test_m7_scale.py:434-449``): the trajectory within 1e-5. Then the
flag's guards in process, with the rendezvous stubbed, and the import
boundary of the script and the worker. Beside them, the script's
``side`` runs the same 2 + 2 steps as a user would: fresh ``python -m
metaasr_tpu_torch.cli`` processes under torchrun's environment, meeting
through ``env://`` on a free port, ``initialize`` making the group inside
``cli.main``.
"""

import concurrent.futures
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from metaasr_tpu_torch import cli, parallel
from metaasr_tpu_torch.config import load_config, save_config, to_dict
from metaasr_tpu_torch.data import synthetic
from metaasr_tpu_torch.parallel import distributed
from metaasr_tpu_torch.scripts import multihost_trainer_smoke as smoke
from metaasr_tpu_torch.train.checkpoint import CheckpointManager
from metaasr_tpu_torch.utils.tree import flatten
from tests import torch_parallel_worker as worker
from tests.test_torch_parallel import (
    ACCENTS,
    RTOL,
    _assert_params_close,
    _assert_ranks_equal,
    _clear_env,
    _Group,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

STEPS_A, STEPS_B = smoke.STEPS_A, smoke.STEPS_B   # 2, then resumed to 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    data = str(root / "data")
    synthetic.generate_dataset(data, accents=ACCENTS, utts_per_accent=8,
                               words_per_utt=(1, 2), seed=3)
    config = str(root / "run.yaml")
    save_config(worker.trainer_cfg(data), config)
    return root, config


def _cli_job(name: str, argv: list, root) -> dict:
    return {"kind": "cli", "name": name, "argv": argv,
            "audit_root": str(root)}


@pytest.fixture(scope="module")
def runs(corpus):
    """The two pairs and the one-process runs -> {"a": the first pair's
    results, "b": the fresh pair's, "one": this process's, "wd": the
    workdirs, "torchrun": the future of the script's 2-process side}. This
    process trains while the first pair and the script's processes do."""
    root, config = corpus
    wd = {k: str(root / f"wd_{k}") for k in ("fomaml", "maml", "one_fomaml",
                                               "one_maml", "torchrun")}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    torchrun = pool.submit(smoke.side, config, wd["torchrun"], "cpu", 2)
    first = worker.Ranks(2, str(root / "pair_a"), [
        _cli_job("fomaml", smoke.train_argv(config, wd["fomaml"], STEPS_A,
                                            "cpu", 2), root),
        _cli_job("maml", smoke.train_argv(config, wd["maml"], STEPS_A, "cpu",
                                          2) + ["--algo", "maml"], root),
        {"kind": "mismatch", "name": "mismatch"},
        {"kind": "cli_error", "name": "no_config", "argv": smoke.train_argv(
            str(root / "missing.yaml"), str(root / "wd_missing"), 1, "cpu",
            2)}])
    second = None
    try:
        one = {"fomaml": worker.cli_job(smoke.train_argv(
                   config, wd["one_fomaml"], STEPS_B, "cpu")),
               "maml": worker.cli_job(smoke.train_argv(
                   config, wd["one_maml"], STEPS_A, "cpu")
                   + ["--algo", "maml"])}
        a = first.results()
        second = worker.Ranks(2, str(root / "pair_b"), [
            _cli_job("fomaml", smoke.train_argv(None, wd["fomaml"], STEPS_B,
                                                "cpu", 2), root)])
        b = second.results()
    finally:
        first.close()
        if second is not None:
            second.close()
        concurrent.futures.wait([torchrun])
        pool.shutdown()
    return {"a": a, "b": b, "one": one, "wd": wd, "torchrun": torchrun}


def _records(workdir: str) -> list[dict]:
    with open(os.path.join(workdir, "logs", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _assert_records_close(got: list, want: list) -> None:
    """Every logged record (steps and held-out evaluations) within RTOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["step"] == w["step"]
        for k in w.keys() - {"step", "time", "utts_per_sec"}:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=k)


def test_resumed_pair_equals_one_process_straight(runs):
    """2 steps, a fresh pair to 4 = one process's straight 4: every logged
    step's meta_loss / grad_norm and both held-out evaluations within
    rtol 1e-5, the loss trajectory within the reference's 1e-5; the final
    parameters within 1e-5 off the key biases and equal across ranks;
    one broadcast on resume only, one all-reduce a step."""
    wd, one = runs["wd"], runs["one"]["fomaml"]
    got, want = _records(wd["fomaml"]), _records(wd["one_fomaml"])
    assert [r["step"] for r in got] == [1, 2, 2, 3, 4, 4]
    _assert_records_close(got, want)
    worst, ok = smoke.compare(smoke.trajectory(wd["one_fomaml"]),
                              smoke.trajectory(wd["fomaml"]))
    assert ok, worst
    for key in ("meta_loss", "grad_norm"):
        np.testing.assert_allclose(smoke.trajectory(wd["fomaml"], key),
                                   smoke.trajectory(wd["one_fomaml"], key),
                                   rtol=RTOL)
    r0, r1 = (r["fomaml"] for r in runs["b"])
    want_end = one["trainers"][0]
    for r in (r0, r1):
        assert r["rc"] == 0 and len(r["trainers"]) == 1
        end = r["trainers"][0]
        assert end["step"] == STEPS_B
        assert end["best_metric"] == want_end["best_metric"]
        assert end["stale_evals"] == want_end["stale_evals"]
        assert r["broadcast_calls"] == 1
        assert r["all_reduces"] == STEPS_B - STEPS_A
    for r in (x["fomaml"] for x in runs["a"]):
        assert r["broadcast_calls"] == 0 and r["all_reduces"] == STEPS_A
    _assert_params_close(r0["trainers"][0]["params"], want_end["params"])
    _assert_ranks_equal(r0["trainers"][0]["params"],
                        r1["trainers"][0]["params"])


def test_script_side_under_torchrun_equals_one_process(runs):
    """The path a user runs: ``smoke.side`` at world 2 starts fresh CLI
    processes with torchrun's environment twice (to step 2, then resumed
    to 4); their loss trajectory, read from rank 0's log, is the one
    process's straight 4 steps within the reference's 1e-5."""
    got = runs["torchrun"].result()
    want = smoke.trajectory(runs["wd"]["one_fomaml"])
    worst, ok = smoke.compare(want, got)
    assert ok, (worst, want, got)
    np.testing.assert_allclose(
        smoke.trajectory(runs["wd"]["torchrun"], "grad_norm"),
        smoke.trajectory(runs["wd"]["one_fomaml"], "grad_norm"), rtol=RTOL)


def test_broadcast_layout_mismatch_raises_on_every_rank(runs):
    """A rank whose train state differs from rank 0's makes every rank
    raise, rank 0 included, before any tensor is broadcast."""
    for r in runs["a"]:
        assert r["mismatch"]["error"] is not None
        assert "rank(s) [1] hold a train state that differs" in (
            r["mismatch"]["error"])


def test_rank0s_config_failure_reaches_every_rank(runs, corpus):
    """Rank 0 cannot read ``--config``: it raises its own error, rank 1
    (waiting for the config) raises naming it, and nothing is written."""
    r0, r1 = (r["no_config"]["error"] for r in runs["a"])
    assert r0 is not None and "missing.yaml" in r0
    assert r1 == f"SystemExit: rank 0 could not resolve the config: {r0}"
    assert not (corpus[0] / "wd_missing").exists()


def test_broadcast_hands_rank0s_checkpoint_to_every_rank(runs):
    """Right after ``broadcast_state`` each rank holds rank 0's restored
    checkpoint bit for bit: every tensor of params and opt_state (Adam's
    mu and nu), count, step, seed, the best metric of the evaluation at
    step 2 and the stale count."""
    ckpt, step = CheckpointManager(
        os.path.join(runs["wd"]["fomaml"], "ckpts")).restore(
            step=STEPS_A, map_location="cpu")
    want = flatten(ckpt)
    assert step == STEPS_A and want["step"] == STEPS_A
    assert want["opt_state/count"] == STEPS_A
    assert np.isfinite(want["best_metric"]) and want["stale_evals"] == 0
    assert any(k.startswith("opt_state/nu/") for k in want)
    for r in runs["b"]:
        (got,) = r["fomaml"]["broadcasts"]
        assert got.keys() == want.keys()
        for k, w in want.items():
            if torch.is_tensor(w):
                assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
            else:
                assert type(got[k]) is type(w) and got[k] == w, k


def test_only_rank0_writes_and_resolves_the_config(runs, corpus):
    """Rank 1 writes nothing and reads no config in either pair; rank 0
    writes config.yaml, ckpts/ and logs/, and the resumed pair's rank 0
    reads the recorded config.yaml (no --config). Both ranks train the
    config rank 0 resolved, on the device their task runs on."""
    root, config = corpus
    wd = os.path.relpath(runs["wd"]["fomaml"], root)
    for pair in ("a", "b"):
        r0, r1 = (r["fomaml"] for r in runs[pair])
        assert [e for e in r1["events"] if e[0] != "read"] == []
        assert not any(p.endswith(".yaml") for _, p in r1["events"])
        wrote = {p for kind, p in r0["events"] if kind != "read"}
        assert os.path.join(wd, "config.yaml") in wrote
        for sub in ("ckpts", "logs"):
            assert any(p.startswith(os.path.join(wd, sub)) for p in wrote)
        assert {p.split(os.sep)[0] for p in wrote} == {wd}
        cfg0, cfg1 = (r["trainers"][0]["cfg"] for r in (r0, r1))
        assert cfg0 == cfg1
        want = to_dict(load_config(os.path.join(root, wd, "config.yaml")))
        want["model"]["vocab_size"] = cfg0["model"]["vocab_size"]
        assert cfg0 == want
        for r in (r0, r1):
            assert r["trainers"][0]["devices"] == ("cpu", "cpu")
    reads = {p for kind, p in runs["b"][0]["fomaml"]["events"]
             if kind == "read"}
    assert os.path.join(wd, "config.yaml") in reads
    assert os.path.relpath(config, root) not in reads


def test_maml_pair_equals_one_process(runs):
    """``--algo maml`` through the same CLI path (K2b's path on the CPU):
    2 ranks = one process, logged records within rtol 1e-5, parameters
    within 1e-5 off the key biases and equal across ranks."""
    _assert_records_close(_records(runs["wd"]["maml"]),
                          _records(runs["wd"]["one_maml"]))
    r0, r1 = (r["maml"] for r in runs["a"])
    assert r0["trainers"][0]["cfg"]["meta"]["algo"] == "maml"
    assert r0["all_reduces"] == r1["all_reduces"] == STEPS_A
    _assert_params_close(r0["trainers"][0]["params"],
                         runs["one"]["maml"]["trainers"][0]["params"])
    _assert_ranks_equal(r0["trainers"][0]["params"],
                        r1["trainers"][0]["params"])


# ---- the flag's guards, in process ----

def _argv(corpus, name: str, *extra) -> list:
    root, config = corpus
    return smoke.train_argv(config, str(root / name), 1, "cpu") + list(extra)


def test_mesh_tasks_1_trains_as_no_flag(corpus, monkeypatch):
    """No torchrun environment: ``--mesh-tasks 1`` makes no group and
    trains as no flag does, bit for bit (the step-1 checkpoint and the
    logged metrics)."""
    _clear_env(monkeypatch)
    root = corpus[0]
    for name, extra in (("plain", ()), ("mesh1", ("--mesh-tasks", "1"))):
        assert cli.main(_argv(corpus, name, *extra)) == 0
    states = [CheckpointManager(str(root / n / "ckpts")).restore(
        map_location="cpu")[0] for n in ("plain", "mesh1")]
    a, b = (flatten(s) for s in states)
    assert a.keys() == b.keys()
    for k, v in a.items():
        assert (torch.equal(v, b[k]) if torch.is_tensor(v)
                else v == b[k]), k
    got, want = _records(str(root / "mesh1")), _records(str(root / "plain"))
    assert [{k: v for k, v in r.items() if k not in ("time", "utts_per_sec")}
            for r in got] == [
        {k: v for k, v in r.items() if k not in ("time", "utts_per_sec")}
        for r in want]


def _stub_group(monkeypatch, world: int) -> None:
    """``parallel.initialize`` returns a stand-in group of ``world`` ranks
    seen from rank 0, whose broadcasts and barriers are no-ops."""
    monkeypatch.setattr(parallel, "initialize",
                        lambda **kw: _Group(world, 0))
    monkeypatch.setattr(distributed.dist, "get_world_size",
                        lambda g=None: g.world)
    monkeypatch.setattr(distributed.dist, "get_rank", lambda g=None: g.rank)
    monkeypatch.setattr(parallel, "from_rank0", lambda obj, g: obj)
    monkeypatch.setattr(parallel, "barrier", lambda g: None)


def test_mesh_tasks_must_equal_the_world_size(corpus, monkeypatch):
    _clear_env(monkeypatch)
    _stub_group(monkeypatch, 2)
    with pytest.raises(SystemExit, match="--mesh-tasks 3 but the world "
                       "size is 2"):
        cli.main(_argv(corpus, "w3", "--mesh-tasks", "3"))
    assert not (corpus[0] / "w3").exists()


def test_world_size_without_the_flag_is_refused(corpus, monkeypatch):
    """torchrun's WORLD_SIZE=2 without ``--mesh-tasks``: two replicas
    would train the whole run into one workdir."""
    _clear_env(monkeypatch)
    monkeypatch.setenv("WORLD_SIZE", "2")
    for argv in (_argv(corpus, "noflag"),
                 ["--mode", "test", "--workdir", str(corpus[0] / "noflag"),
                  "--device", "cpu"]):
        with pytest.raises(SystemExit, match="no --mesh-tasks"):
            cli.main(argv)
    assert not (corpus[0] / "noflag").exists()


@pytest.mark.parametrize("extra,why", (
    (("--mode", "test"), "--mode test runs in one process"),
    (("--algo", "multi"), "algo multi trains in one process"),
    (("--algo", "no"), "algo no trains in one process")))
def test_mesh_tasks_outside_meta_training_is_refused(corpus, monkeypatch,
                                                     extra, why):
    _clear_env(monkeypatch)
    _stub_group(monkeypatch, 2)
    with pytest.raises(SystemExit, match=why):
        cli.main(_argv(corpus, "outside", "--mesh-tasks", "2", *extra))
    assert not (corpus[0] / "outside").exists()


def test_failed_rendezvous_raises_and_never_trains_alone(corpus,
                                                         monkeypatch):
    """torchrun's environment names 2 processes and the rendezvous fails:
    the CLI raises, and nothing is trained or written."""
    _clear_env(monkeypatch)
    for name, value in (("WORLD_SIZE", "2"), ("RANK", "0"),
                        ("LOCAL_RANK", "0"), ("MASTER_ADDR", "localhost"),
                        ("MASTER_PORT", "29500")):
        monkeypatch.setenv(name, value)

    def boom(*a, **k):
        raise ConnectionError("rendezvous unreachable")

    monkeypatch.setattr(distributed.dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="rendezvous failed"):
        cli.main(_argv(corpus, "alone", "--mesh-tasks", "2"))
    assert not (corpus[0] / "alone").exists()


def test_broadcast_state_without_a_group_is_the_identity():
    state = {"params": {"w": torch.ones(2)}, "step": 3}
    calls = distributed.broadcast_state.calls
    assert distributed.broadcast_state(state, None) is state
    assert distributed.broadcast_state.calls == calls


def test_script_and_worker_import_neither_jax_nor_the_reference():
    """The script's functions and the test's worker run the port alone."""
    code = ("import sys, tests.torch_parallel_worker\n"
            "from metaasr_tpu_torch.scripts import multihost_trainer_smoke "
            "as s\n"
            "s.smoke_config('data'); s.train_argv(None, 'wd', 4, 'cpu', 2)\n"
            "s.compare([1.0] * 4, [1.0] * 4)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'metaasr_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=worker.REPO,
                          env=dict(os.environ, PYTHONPATH=worker.REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_compare_holds_the_reference_bar():
    one = [4.0, 3.5, 3.0, 2.5]
    assert smoke.compare(one, [x + 5e-6 for x in one]) == (
        pytest.approx(5e-6), True)
    assert not smoke.compare(one, [x + 2e-5 for x in one])[1]
    assert not smoke.compare(one, one[:3])[1]
