"""Port vs itself and vs the reference: the task-axis data-parallel
meta-step (``metaasr_tpu_torch/parallel/``).

``initialize`` and ``task_rows`` against the reference's ``initialize`` /
``host_local_slice`` rules; ``TaskSampler.sample(step, rows=)`` against the
full sample and the reference's; then 2 gloo processes x 2 tasks against
1 process x 4 tasks (``tests/torch_parallel_worker.py``: FOMAML over two
Adam steps, second-order MAML, Reptile, a bf16 meta-step, and
``MetaASRTrainer.meta_train``), with SpecAugment, dropout and dither on so
that every task's seed is tested, and the 2-process FOMAML gradient
against the reference's single-process ``maml_grads``. d=32, 2 heads, 2+2
layers, on the CPU; the processes meet in a ``FileStore`` under the test's
temporary directory, so parallel test workers never share a port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from metaasr_tpu.data import sampler as ref_sampler
from metaasr_tpu.data.dataset import load_accent_datasets as ref_load
from metaasr_tpu.data.tokenizer import CharTokenizer as RefCharTokenizer
from metaasr_tpu.meta import maml as ref_maml
from metaasr_tpu.parallel import distributed as ref_distributed
from metaasr_tpu.train.task import ASRTask as RefTask
from metaasr_tpu_torch import cli
from metaasr_tpu_torch.data import sampler, synthetic
from metaasr_tpu_torch.data.dataset import load_accent_datasets
from metaasr_tpu_torch.data.tokenizer import CharTokenizer
from metaasr_tpu_torch.parallel import distributed
from metaasr_tpu_torch.task import ASRTask
from metaasr_tpu_torch.weights import flatten_tree, params_to_flax
from tests import torch_parallel_worker as worker
from tests.test_m2_models import tiny_cfg
from tests.test_torch_meta import GRAD_L2REL, LOSS_RTOL, _l2rel
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ACCENTS = ("alpha", "bravo", "echo", "delta", "tango")   # tango held out
SCENARIOS = ("fomaml", "maml", "reptile")
# the reference's bar for the multi-process path
# (scripts/multihost_smoke.py:210), and the gradient's
RTOL, ATOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5, 1e-5, 1e-7


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    data = str(root / "data")
    synthetic.generate_dataset(data, accents=ACCENTS, utts_per_accent=8,
                               words_per_utt=(1, 2), seed=3)
    return root, data


@pytest.fixture(scope="module")
def ranks(corpus):
    """Two gloo processes running every scenario and the trainer, started
    once for the module while the tests compute the one-process sides."""
    root, data = corpus
    jobs = [{"kind": "scenario", "name": n}
            for n in (*SCENARIOS, "fomaml_bf16", "fomaml_plain")]
    jobs.append({"kind": "trainer", "data_dir": data})
    run = worker.Ranks(2, str(root / "dp"), jobs)
    yield run
    run.close()


def _key_bias(name: str, shape) -> np.ndarray:
    """The elements whose exact gradient is 0: the attention key biases
    (softmax ignores a constant per query; the middle third of a fused
    qkv bias). Both sides hold rounding noise there (~1e-9), and Adam
    scales noise to a step of up to lr, so parameters are compared off
    these elements and the gradients on them are checked to be noise."""
    mask = np.zeros(shape, bool)
    if name.endswith("qkv.bias"):
        d = shape[0] // 3
        mask[d: 2 * d] = True
    elif name.endswith("cross_attn.k.bias"):
        mask[:] = True
    return mask


def _assert_grads_close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)


def _assert_params_close(got: dict, want: dict, grads=None) -> None:
    """Within ATOL off the key biases (where ``grads``, the one-process
    gradient, must be noise)."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        noise = _key_bias(k, w.shape)
        if grads is not None:
            assert np.abs(grads[k][noise]).max(initial=0.0) <= 1e-7, k
        np.testing.assert_allclose(got[k][~noise], w[~noise], rtol=0,
                                   atol=ATOL, err_msg=k)


def _assert_ranks_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def _clear_env(monkeypatch) -> None:
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    _clear_env(monkeypatch)
    assert distributed.initialize() is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize() is None
    assert not dist.is_initialized()
    assert distributed.task_rows(8, None) == slice(0, 8)


def test_initialize_fails_loudly_on_broken_rendezvous(monkeypatch):
    """A multi-process environment or explicit arguments with a failed
    rendezvous raise, as the reference's ``initialize`` does; without any
    multi-process indication the call is a quiet no-op."""
    _clear_env(monkeypatch)
    calls = []

    def boom(*a, **k):
        calls.append(a)
        raise ConnectionError("rendezvous unreachable")

    monkeypatch.setattr(distributed.dist, "init_process_group", boom)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match="multi-process environment"):
        distributed.initialize(device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    with pytest.raises(RuntimeError, match="multi-process environment"):
        distributed.initialize(init_method="tcp://127.0.0.1:29500",
                               world_size=2, rank=0, device="cpu")
    assert len(calls) == 2
    assert distributed.initialize() is None
    assert len(calls) == 2 and not dist.is_initialized()


def test_group_of_one_in_process(tmp_path, monkeypatch):
    """Explicit arguments make a group even of one, once (idempotent);
    its reduction is the identity and counts one all-reduce."""
    _clear_env(monkeypatch)
    group = distributed.initialize(init_method=f"file://{tmp_path}/rdzv",
                                   world_size=1, rank=0, device="cpu",
                                   timeout=60)
    try:
        assert group is not None and dist.get_backend(group) == "gloo"
        assert distributed.initialize() is group
        assert distributed.task_rows(4, group) == slice(0, 4)
        acc = {"a": torch.arange(6, dtype=torch.float32).view(2, 3),
               "b": torch.full((4,), 0.5)}
        q = torch.tensor([1.5, 2.5], dtype=torch.bfloat16)
        before = distributed.reduce_outer.all_reduces
        summed, every = distributed.reduce_outer(
            {k: v.clone() for k, v in acc.items()},
            {"query": q, "support": torch.tensor([3.0, 4.0])}, group)
        assert distributed.reduce_outer.all_reduces == before + 1
        for k, v in acc.items():
            assert torch.equal(summed[k], v)
        assert every["query"].dtype == torch.bfloat16
        assert torch.equal(every["query"], q)
        with pytest.raises(TypeError, match="fp32"):
            distributed.reduce_outer({"a": acc["a"].double()}, {"q": q},
                                     group)
        distributed.barrier(group)
        assert distributed.from_rank0({"x": 1.0}, group) == {"x": 1.0}
    finally:
        dist.destroy_process_group()


class _Group:
    """A stand-in group of ``world`` ranks seen from ``rank``."""

    def __init__(self, world, rank):
        self.world, self.rank = world, rank


@pytest.mark.parametrize("world", (1, 2, 4))
def test_task_rows_match_host_local_slice(monkeypatch, world):
    monkeypatch.setattr(distributed.dist, "get_world_size",
                        lambda g: g.world)
    monkeypatch.setattr(distributed.dist, "get_rank", lambda g: g.rank)
    for r in range(world):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        want = ref_distributed.host_local_slice(8)
        assert distributed.task_rows(8, _Group(world, r)) == want


def test_task_rows_raise_where_the_world_does_not_divide(monkeypatch):
    """M = 6 over W = 4: the port raises; the reference's arithmetic gives
    each process one row and drops rows 4 and 5 (a known difference)."""
    monkeypatch.setattr(distributed.dist, "get_world_size",
                        lambda g: g.world)
    monkeypatch.setattr(distributed.dist, "get_rank", lambda g: g.rank)
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    monkeypatch.setattr(jax, "process_index", lambda: 3)
    assert ref_distributed.host_local_slice(6) == slice(3, 4)
    with pytest.raises(ValueError, match="multiple of the world size"):
        distributed.task_rows(6, _Group(4, 3))


def _samplers(data: str):
    """The port's and the reference's samplers over the 4 training accents,
    4 tasks x (2 + 2), with buckets that split the draws."""
    kw = dict(k_support=2, k_query=2, tasks_per_batch=4,
              num_samples=200 * 160 + 240, num_tokens=16, seed=0,
              sample_buckets=(75 * 160 + 240, 100 * 160 + 240,
                              200 * 160 + 240), token_buckets=(8, 16))
    train = ACCENTS[:4]
    return (sampler.TaskSampler(load_accent_datasets(
                data, CharTokenizer.ascii_default(), train), **kw),
            ref_sampler.TaskSampler(ref_load(
                data, RefCharTokenizer.ascii_default(), train), **kw))


def _assert_batches_equal(got: dict, want: dict) -> None:
    assert list(got["accents"]) == list(want["accents"])
    for part in ("support", "query"):
        assert sorted(got[part]) == sorted(want[part])
        for k, v in want[part].items():
            if k == "texts":
                assert got[part][k] == v
            else:
                assert got[part][k].dtype == v.dtype, (part, k)
                np.testing.assert_array_equal(got[part][k], v)


def test_sample_rows_equal_the_full_sample_and_the_reference(corpus):
    port, ref = _samplers(corpus[1])
    for step in range(4):
        full = port.sample(step)
        _assert_batches_equal(full, ref.sample(step))
        for r in range(2):
            rows = slice(2 * r, 2 * r + 2)
            got = port.sample(step, rows=rows)
            _assert_batches_equal(got, ref.sample(step, rows=rows))
            _assert_batches_equal(got, {
                "accents": full["accents"][rows],
                **{p: {k: v[rows] for k, v in full[p].items()}
                   for p in ("support", "query")}})


def test_rank0_pads_to_the_longest_utterance_of_rank1(corpus):
    """On a draw whose longest utterance lies in rank 1's rows, rank 0's
    batch pads to it, past the bucket its own rows would need."""
    port, _ = _samplers(corpus[1])
    for step in range(200):
        accents, sup, qry = port.sample_indices(step)
        own = port.step_shape(accents[:2], sup[:2], qry[:2])
        whole = port.step_shape(accents, sup, qry)
        if whole[0] > own[0]:
            break
    else:
        pytest.fail("no draw in 200 steps has its longest utterance in "
                    "rank 1's rows")
    got = port.sample(step, rows=slice(0, 2))
    assert got["support"]["audio"].shape == (2, 2, whole[0])
    assert got["query"]["audio"].shape == (2, 2, whole[0])
    assert got["support"]["tokens"].shape[-1] == whole[1]


_ONE = {}


def _one_process(name: str) -> dict:
    if name not in _ONE:
        _ONE[name] = worker.run_scenario(name)
    return _ONE[name]


@pytest.mark.parametrize("name", SCENARIOS)
def test_two_processes_equal_one(ranks, name):
    """2 ranks x 2 tasks = 1 process x 4 tasks: the reduced gradient, the
    meta-loss and grad_norm of every step, the parameters after the
    steps (FOMAML: two Adam steps); both ranks hold the same parameters
    and ran one gradient all-reduce a step."""
    want = _one_process(name)
    r0, r1 = (r[name] for r in ranks.results())
    steps = worker.SCENARIOS[name][2]
    for got in (r0, r1):
        assert got["all_reduces"] == steps
        _assert_grads_close(got["grads"], want["grads"])
        for g, w in zip(got["metrics"], want["metrics"]):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=RTOL)
        _assert_params_close(got["params"], want["params"], want["grads"])
    assert want["all_reduces"] == 0
    _assert_ranks_equal(r0["params"], r1["params"])


def test_bf16_meta_step_reduces_the_fp32_accumulators(ranks):
    """grad_dtype bfloat16: the ranks sum their fp32 accumulators before
    the cast, so the reduced gradient is the one-process gradient to fp32
    rounding (a bf16 reduction would round once a rank, ~4e-3)."""
    want = _one_process("fomaml_bf16")
    for got in (r["fomaml_bf16"] for r in ranks.results()):
        _assert_grads_close(got["grads"], want["grads"])
        np.testing.assert_allclose(got["metrics"][0]["meta_loss"],
                                   want["metrics"][0]["meta_loss"],
                                   rtol=RTOL)


def test_two_process_fomaml_matches_the_reference(ranks):
    """The 2-process FOMAML gradient and metrics against the reference's
    single-process ``maml_grads`` on the same 4-task batch and weights
    (SpecAugment off, dropout 0, dither 0), at ``test_torch_meta.py``'s
    fp32 bars."""
    algo, _, _ = worker.SCENARIOS["fomaml_plain"]
    ref_cfg = tiny_cfg("transformer", vocab=worker.VOCAB)
    ref_task = RefTask(ref_cfg, worker.VOCAB - 1)
    task = ASRTask(worker.small_cfg(False), worker.VOCAB - 1, device="cpu")
    params = params_to_flax(task.init_params(0), num_heads=2)
    ref_fn = jax.jit(ref_maml.maml_grads(
        ref_task.loss_fn, ref_maml.MetaAlgoConfig(first_order=True, **algo),
        ref_task.preprocess))
    want, want_m = ref_fn(params, jax.tree.map(jnp.asarray,
                                               worker.meta_batch(0)),
                          jax.random.PRNGKey(0))
    got = ranks.results()[0]["fomaml_plain"]
    for key in ("meta_loss", "query_loss_max", "support_loss_mean"):
        np.testing.assert_allclose(got["metrics"][0][key],
                                   float(want_m[key]),
                                   rtol=LOSS_RTOL["float32"])
    want_flat = flatten_tree(jax.tree.map(np.asarray, want))
    got_flat = flatten_tree(params_to_flax(
        {k: torch.from_numpy(v) for k, v in got["grads"].items()},
        num_heads=2))
    assert got_flat.keys() == want_flat.keys()
    worst = max(_l2rel(got_flat[k], want_flat[k]) for k in want_flat)
    assert worst <= GRAD_L2REL["float32"], worst


def test_two_process_trainer_equals_one_process(ranks, corpus, tmp_path):
    """``MetaASRTrainer.meta_train(max_steps=2)`` in 2 processes against
    one: per-step metrics, the held-out evaluation rank 0 ran and shared,
    final parameters; only rank 0's workdir holds checkpoints and logs;
    no resident store under the group although ``data.resident`` is on
    (the one process builds it)."""
    want = worker.run_trainer(corpus[1], str(tmp_path / "one"))
    r0, r1 = (r["trainer"] for r in ranks.results())
    assert want["store_built"] and not r0["store_built"] \
        and not r1["store_built"]
    assert r0["step"] == r1["step"] == want["step"] == 2
    assert r0["best_metric"] == r1["best_metric"] == want["best_metric"]
    assert r0["workdir"] == want["workdir"] == ["ckpts", "logs"]
    assert r1["workdir"] == [] and r1["records"] == []
    assert len(r0["records"]) == len(want["records"]) == 3   # 2 steps + eval
    for g, w in zip(r0["records"], want["records"]):
        assert g.keys() == w.keys() and g["step"] == w["step"]
        for k in w.keys() - {"step", "time", "utts_per_sec"}:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=k)
    _assert_params_close(r0["params"], want["params"])
    _assert_ranks_equal(r0["params"], r1["params"])


def test_cli_still_refuses_mesh_tasks(corpus, tmp_path, monkeypatch):
    """The CLI refuses ``--mesh-tasks N`` where the world is not N
    processes (here one, with no torchrun environment) and outside
    meta-training (``tests/test_torch_mesh_tasks.py`` runs the flag);
    ``make_trainer`` hands a group to the meta-trainer only."""
    _clear_env(monkeypatch)
    with pytest.raises(SystemExit, match="world size is 1"):
        cli.main(["--mesh-tasks", "2", "--device", "cpu", "--workdir",
                  str(tmp_path / "wd")])
    with pytest.raises(SystemExit, match="--mode adapt runs in one"):
        cli.main(["--mesh-tasks", "2", "--mode", "adapt"])
    assert not (tmp_path / "wd").exists()
    cfg = worker.trainer_cfg(corpus[1])
    cfg.meta.algo = "multi"
    with pytest.raises(ValueError, match="process group"):
        cli.make_trainer(cfg, str(tmp_path), "cpu", _Group(2, 0))


def test_worker_imports_neither_jax_nor_the_reference():
    """The worker processes run the port alone."""
    import subprocess
    import sys

    code = ("import sys, tests.torch_parallel_worker, "
            "metaasr_tpu_torch.parallel\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'metaasr_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=worker.REPO,
                          env=dict(os.environ, PYTHONPATH=worker.REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
