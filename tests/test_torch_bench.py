"""Port vs reference: the headline bench (``metaasr_tpu_torch/scripts/
bench.py``), its two baselines and the throughput sweep.

- The port's workload constants and meta-batch are the reference's
  (``bench.py:29-35``, ``:83-97``), byte for byte.
- One step of the port's bench against the reference's step built as
  ``measure_jax`` builds it (``maml_grads`` + ``optax.adam(1e-3)``) on the
  tiny transformer (d 32, 2 heads, 2+2 layers, fp32), 2 tasks x (1 + 1)
  utterances of 16,000 samples, 6 tokens, 3 inner steps, dropout 0,
  SpecAugment off, fp32 ``grad_dtype``; the same weights through
  ``weights.py``. Bars: meta-loss rtol 1e-4, worst gradient leaf l2rel
  <= 1e-4 (measured on the CPU: 4.3e-5, the loss 1.6e-7 apart); the port's optimizer fed the reference's gradient gives
  ``optax.adam(1e-3)``'s update within 1e-7.
- The repeat rule, the record's arithmetic, the no-card exits, the sweep's
  rows and its out-of-memory leg, and one step of each baseline on the CPU
  (the sequential baseline's outer gradient equal to ``maml_grads``').
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metaasr_tpu.meta import maml as ref_maml
from metaasr_tpu.train.task import ASRTask as RefTask
from metaasr_tpu_torch.meta import maml
from metaasr_tpu_torch.scripts import (
    bench,
    bench_baseline_seq,
    bench_baseline_torch,
    sweep_throughput,
)
from metaasr_tpu_torch.task import ASRTask
from metaasr_tpu_torch.train.optimizer import Optimizer
from metaasr_tpu_torch.weights import flatten_tree, flax_to_params, params_to_flax
from tests.test_m2_models import tiny_cfg
from tests.test_torch_meta import _l2rel, port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SAMPLES, TINY_TOKENS = 16000, 6
M, K = 2, 1
LOSS_RTOL, GRAD_L2REL, ADAM_ATOL = 1e-4, 1e-4, 1e-7


def _reference_batch(m_tasks, k_shot):
    """bench.py:83-97, verbatim but for jnp.asarray (numpy arrays)."""
    rng = np.random.default_rng(0)

    def batch(bsz):
        return {
            "audio": np.asarray(
                0.1 * rng.standard_normal((m_tasks, bsz, 64000))
            ).astype(np.float32),
            "audio_lens": np.full((m_tasks, bsz), 64000, np.int32),
            "tokens": rng.integers(1, 30 - 1,
                                   (m_tasks, bsz, 32)).astype(np.int32),
            "token_lens": np.full((m_tasks, bsz), 32, np.int32),
        }

    return {"support": batch(k_shot), "query": batch(k_shot)}


def test_constants_match_the_reference():
    code = ("import sys, bench\n"
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules), 'bench.py imported jax'\n"
            "print(bench.M_TASKS, bench.K_SUPPORT, bench.K_QUERY, "
            "bench.INNER_STEPS, bench.NUM_SAMPLES, bench.NUM_TOKENS, "
            "bench.VOCAB)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          check=True)
    ref = [int(v) for v in proc.stdout.split()]
    for mod in (bench, bench_baseline_torch, bench_baseline_seq):
        assert [mod.M_TASKS, mod.K_SUPPORT, mod.K_QUERY, mod.INNER_STEPS,
                mod.NUM_SAMPLES, mod.NUM_TOKENS, mod.VOCAB] == ref, mod


@pytest.mark.parametrize("shape", [(4, 4), (4, 16)])
def test_meta_batch_is_the_reference_draw(shape):
    got, want = bench.draw_batch(*shape), _reference_batch(*shape)
    for part in ("support", "query"):
        for key, arr in want[part].items():
            assert got[part][key].dtype == arr.dtype, (part, key)
            assert got[part][key].tobytes() == arr.tobytes(), (part, key)


def test_sequential_baseline_draws_the_reference_tasks():
    """bench_baseline_seq.py:82-95: per task, support then query."""
    rng = np.random.default_rng(0)
    tasks = bench_baseline_seq.draw_tasks("cpu")
    for support, query in tasks:
        for part in (support, query):
            audio = 0.1 * rng.standard_normal((4, 64000)).astype(np.float32)
            tokens = rng.integers(1, 29, (4, 32)).astype(np.int32)
            assert part["audio"].numpy().tobytes() == audio.tobytes()
            assert part["tokens"].numpy().tobytes() == tokens.tobytes()
            assert part["audio_lens"].tolist() == [64000] * 4


@pytest.fixture(scope="module")
def tiny():
    """The tiny transformer in both packages, the port's bench step on it
    and the shrunken bench batch (numpy)."""
    ref_cfg = tiny_cfg("transformer", vocab=bench.VOCAB)
    ref_cfg.meta.inner_steps = bench.INNER_STEPS
    cfg = port_cfg(ref_cfg)
    old = bench.NUM_SAMPLES, bench.NUM_TOKENS
    bench.NUM_SAMPLES, bench.NUM_TOKENS = TINY_SAMPLES, TINY_TOKENS
    try:
        mb = bench.draw_batch(M, K)
    finally:
        bench.NUM_SAMPLES, bench.NUM_TOKENS = old
    return ref_cfg, cfg, mb


def test_bench_step_matches_the_reference_step(tiny, monkeypatch):
    ref_cfg, cfg, mb = tiny
    monkeypatch.setenv("BENCH_GRAD_DTYPE", "float32")
    task = ASRTask(cfg, device="cpu")
    step = bench.MetaStep(task, bench.to_device(mb, "cpu"))
    params0 = {k: v.clone() for k, v in step.params.items()}
    got_g, _ = step.grad_fn(step.params, step.meta_batch, 0)
    got_loss = float(step(0))
    assert step.steps_run == 1

    # the reference's step as measure_jax builds it (bench.py:109-138)
    ref_task = RefTask(ref_cfg)
    grad_fn = ref_maml.maml_grads(ref_task.loss_fn, ref_maml.MetaAlgoConfig(
        inner_lr=1e-2, inner_steps=bench.INNER_STEPS, first_order=True,
        remat_inner=True, adapt_filter=None, unroll_inner=True,
        grad_dtype="float32"), preprocess_fn=ref_task.preprocess)
    optimizer = optax.adam(1e-3)

    @jax.jit
    def ref_step(params, opt_state, batch, key):
        grads, metrics = grad_fn(params, batch, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), grads, \
            metrics["meta_loss"]

    params = params_to_flax(params0, num_heads=2)
    _, want_g, want_loss = ref_step(params, optimizer.init(params),
                                    jax.tree.map(jnp.asarray, mb),
                                    jax.random.PRNGKey(0))
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=LOSS_RTOL)
    want_flat = flatten_tree(jax.tree.map(np.asarray, want_g))
    got_flat = flatten_tree(params_to_flax(got_g, num_heads=2))
    assert got_flat.keys() == want_flat.keys()
    worst = max(_l2rel(got_flat[k], want_flat[k]) for k in want_flat)
    assert worst <= GRAD_L2REL, worst

    # the port's optimizer settings fed the reference's gradient
    want_u, _ = optimizer.update(want_g, optimizer.init(params), params)
    opt = Optimizer(bench.adam_config())
    got_u, _ = opt.update(flax_to_params(jax.tree.map(np.asarray, want_g)),
                          opt.init(params0), params0)
    got_u = flatten_tree(params_to_flax(got_u, num_heads=2))
    for k, u in flatten_tree(jax.tree.map(np.asarray, want_u)).items():
        np.testing.assert_allclose(got_u[k], u, rtol=0, atol=ADAM_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("dts, passes, want", [
    ([1.00, 1.05, 1.20], 3, 1.05),            # agree within 10% at pass 3
    ([2.0, 1.0, 1.5, 1.08], 4, 1.08),         # two fastest agree at pass 4
    ([1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 9.9], 8, 1.5),  # cap of 8
    ([1.0, 1.099, 5.0], 3, 1.099),            # just inside 10%
    ([1.0, 1.1, 1.5, 1.2, 1.3, 1.4, 1.6, 1.7], 8, 1.1),  # 1.1 is not < 1.1
])
def test_steady_pass_time_rule(dts, passes, want):
    calls = []

    def run_pass(p):
        calls.append(p)
        return dts[p]

    dt, seen = bench.steady_pass_time(run_pass)
    assert calls == list(range(passes))
    assert seen == dts[:passes]
    assert dt == want


@pytest.mark.parametrize("env, want", [
    ({}, dict(first_order=True, adapt_filter=None, grad_dtype="bfloat16",
              encoder="transformer")),
    ({"BENCH_SECOND_ORDER": "1", "BENCH_ENCODER": "conformer"},
     dict(first_order=False, adapt_filter=None, grad_dtype="bfloat16",
          encoder="conformer")),
    ({"BENCH_SECOND_ORDER": "0", "BENCH_ADAPT_FILTER": "ctc_head, decoder",
      "BENCH_GRAD_DTYPE": "float32"},
     dict(first_order=True, adapt_filter=("ctc_head", " decoder"),
          grad_dtype="float32", encoder="transformer")),
    ({"BENCH_SECOND_ORDER": "", "BENCH_GRAD_DTYPE": ""},
     dict(first_order=True, adapt_filter=None, grad_dtype=None,
          encoder="transformer")),
])
def test_experiment_hooks(monkeypatch, env, want):
    """The reference's hook parsing (bench.py:41-45, :75, :109-132): '' and
    '0' are off, BENCH_GRAD_DTYPE='' is the fp32 meta-step."""
    for name in ("BENCH_SECOND_ORDER", "BENCH_ENCODER", "BENCH_ADAPT_FILTER",
                 "BENCH_GRAD_DTYPE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    algo, cfg = bench.algo_config(), bench.bench_config()
    assert (algo.first_order, algo.adapt_filter, algo.grad_dtype,
            cfg.model.encoder) == tuple(want.values())
    assert (algo.inner_lr, algo.inner_steps, cfg.model.vocab_size,
            cfg.model.dtype, cfg.meta.inner_steps) == (
        1e-2, 3, 30, "bfloat16", 3)


def test_ctc_scan_hook_raises(monkeypatch):
    monkeypatch.setenv("BENCH_CTC_IMPL", "scan")
    with pytest.raises(NotImplementedError, match="plain version"):
        bench.measure(device="cpu")


def test_profile_hook_writes_a_trace(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "PROFILE_DIR", str(tmp_path))
    seeds = []

    def step(seed):
        seeds.append(seed)
        return torch.ones(2) @ torch.ones(2)

    seed = bench._profile(torch, step, 7, torch.device("cpu"))
    want = 7
    for i in range(5):
        want = maml.fold_in(want, 1000 + i)
    assert len(seeds) == 5 and seeds[-1] == seed == want
    with open(tmp_path / "bench_trace.json") as f:
        assert "traceEvents" in json.load(f)


def _fake(pres, mfu, steps):
    return {"presentations_per_sec": pres, "mfu": mfu,
            "passes_ms": [10.0, 11.0, 10.5], "steps_per_pass": steps}


def test_record_arithmetic_and_keys():
    device = {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
              "count": 1}
    rec = bench.record(_fake(256.0, 0.0123456, 10), _fake(128.0, 0.01, 20),
                       16.0, 100.0, device)
    assert set(rec) == {
        "metric", "value", "unit", "vs_baseline", "vs_samechip_sequential",
        "ratio_workload", "presentations_per_sec", "mfu", "baseline",
        "workload", "compat_4x4", "device", "passes_ms", "steps_per_pass",
        "flops_source"}
    assert rec["metric"] == "fomaml_meta_train_throughput"
    assert rec["unit"] == "unique_utts/s/chip"
    # 4 x (16 + 16) unique of 4 x (16 * 3 + 16) presentations
    assert rec["value"] == round(256.0 * 128 / 256, 2) == 128.0
    assert rec["presentations_per_sec"] == 256.0
    assert rec["mfu"] == 0.0123
    assert rec["vs_baseline"] == 8.0 and rec["vs_samechip_sequential"] == 1.28
    assert rec["workload"] == {"tasks": 4, "k_support": 16, "k_query": 16,
                               "inner_steps": 3, "audio_sec": 4.0}
    assert rec["compat_4x4"] == {
        "tasks": 4, "k_shot": 4, "unique_utts_per_sec": 64.0,
        "presentations_per_sec": 128.0, "mfu": 0.01, "vs_baseline": 8.0,
        "vs_samechip_sequential": 1.28}
    assert rec["device"] == device and rec["passes_ms"] == [10.0, 11.0, 10.5]
    assert rec["steps_per_pass"] == {"headline": 10, "compat_4x4": 20}
    assert "K1/K2 not counted" in rec["flops_source"]
    json.dumps(rec)
    # a failed baseline gives null ratios, not an error
    rec = bench.record(_fake(256.0, None, 3), _fake(128.0, None, 3), None,
                       float("nan"), device)
    assert rec["vs_baseline"] is None and rec["vs_samechip_sequential"] is None
    assert rec["mfu"] is None and rec["compat_4x4"]["vs_baseline"] is None


def test_bench_without_cuda_prints_one_null_line():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "metaasr_tpu_torch.scripts.bench"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    rec = json.loads(lines[0])
    assert rec["value"] is None and rec["unit"] == "unique_utts/s/chip"
    assert "no CUDA device" in rec["error"]


def test_sweep_without_cuda_exits_nonzero(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep_throughput.main(["--points", "4x4"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["value"] is None


def test_sweep_rows_and_out_of_memory_leg(capsys):
    calls = []

    def fake_measure(steps, m_tasks, k_shot):
        calls.append((steps, m_tasks, k_shot))
        if (m_tasks, k_shot) == (16, 32):
            raise torch.OutOfMemoryError("CUDA out of memory (stub)")
        return {"presentations_per_sec": 10.0 * m_tasks * k_shot,
                "mfu": 0.001 * k_shot}

    points = sweep_throughput.parse_points("4x4,8x16,16x32,2x8")
    assert points == [(4, 4), (8, 16), (16, 32), (2, 8)]
    assert sweep_throughput.parse_points(None) == \
        sweep_throughput.DEFAULT_POINTS
    rows = sweep_throughput.sweep(points, 5, measure=fake_measure)
    assert calls == [(5, m, k) for m, k in points]
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [("error" in r) for r in out] == [False, False, True, False]
    assert out[2]["tasks"] == 16 and "OutOfMemoryError" in out[2]["error"]
    assert rows == [r for r in out if "error" not in r]
    # the reference's arithmetic (scripts/sweep_throughput.py:51-58)
    for r, (m, k) in zip(rows, [(4, 4), (8, 16), (2, 8)]):
        pres = 10.0 * m * k
        assert r == {"tasks": m, "k_shot": k, "fused_batch": m * k,
                     "unique_utts_per_sec": round(pres * 2 * k / (4 * k), 2),
                     "presentations_per_sec": round(pres, 2),
                     "mfu": round(0.001 * k, 4)}


def test_torch_baseline_one_step(monkeypatch):
    mod = bench_baseline_torch
    for name, value in (("D_MODEL", 32), ("HEADS", 2), ("FF", 64),
                        ("ENC_LAYERS", 2), ("DEC_LAYERS", 2), ("M_TASKS", M),
                        ("K_SUPPORT", K), ("K_QUERY", K),
                        ("NUM_SAMPLES", TINY_SAMPLES),
                        ("NUM_TOKENS", TINY_TOKENS)):
        monkeypatch.setattr(mod, name, value)
    torch.manual_seed(0)
    model = mod.TorchASR()
    before = [p.detach().clone() for p in model.parameters()]
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    with mod.default_precision():
        loss = mod.meta_step(model, opt, np.random.default_rng(0))
    assert math.isfinite(float(loss))
    assert any(not torch.equal(a, b) for a, b in
               zip(before, model.parameters()))


def test_sequential_baseline_is_fomaml_of_the_same_compute(tiny,
                                                           monkeypatch):
    """One step of the sequential baseline runs; its outer gradient over M
    equals the port's ``maml_grads`` (FOMAML, fp32) on the same tasks."""
    _, cfg, _ = tiny
    for name, value in (("M_TASKS", M), ("K_SUPPORT", K), ("K_QUERY", K),
                        ("NUM_SAMPLES", TINY_SAMPLES),
                        ("NUM_TOKENS", TINY_TOKENS)):
        monkeypatch.setattr(bench_baseline_seq, name, value)
    task = ASRTask(cfg, device="cpu")
    tasks = bench_baseline_seq.draw_tasks("cpu")
    assert len(tasks) == M and tasks[0][0]["audio"].shape == (K, TINY_SAMPLES)
    params = task.init_params(0)
    outer = bench_baseline_seq.outer_grads(task, params, tasks, 0)
    mb = {part: {k: torch.stack([t[i][k] for t in tasks])
                 for k in tasks[0][i]}
          for i, part in enumerate(("support", "query"))}
    want, _ = maml.maml_grads(task.loss_fn, maml.MetaAlgoConfig(
        inner_lr=bench_baseline_seq.INNER_LR,
        inner_steps=bench_baseline_seq.INNER_STEPS), task.preprocess)(
        params, mb, 0)
    worst = max(float(torch.linalg.vector_norm(outer[k] / M - want[k])
                      / max(float(torch.linalg.vector_norm(want[k])), 1e-4))
                for k in want)
    assert worst <= 1e-5, worst

    opt = Optimizer(bench.adam_config())
    state = {"params": params}
    state["opt"] = opt.init(params)
    bench_baseline_seq.meta_step(task, opt, state, tasks, 0)
    assert state["opt"]["count"] == 1
    assert all(torch.isfinite(v).all() for v in state["params"].values())
    assert any(not torch.equal(state["params"][k], params[k]) for k in params)
