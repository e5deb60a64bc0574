"""Headline benchmark of the port: FOMAML meta-train utterances/s on one
NVIDIA GPU, flagship joint CTC-attention transformer, full pipeline
(waveform -> K1 fbank -> CMVN -> SpecAugment -> model -> joint loss through
K2 -> 3 inner SGD steps per task -> outer Adam). Counterpart of the
reference's ``bench.py``: the same workload, the same frozen unit and the
same rule for repeated passes.

    python -m metaasr_tpu_torch.scripts.bench [--steps N]

Prints ONE JSON line:
    {"metric": "fomaml_meta_train_throughput", "value": N,
     "unit": "unique_utts/s/chip", "vs_baseline": N, ...}

``value`` is UNIQUE utterances/s/chip (each drawn utterance counted once
per meta-step) at the headline workload, 4 tasks x (16 + 16) utterances of
64,000 samples. ``presentations_per_sec`` counts support utterances once
per inner step. The ratios are measured at 4 x (4 + 4) in this process on
this card, against two baselines run right after the port:

- ``vs_baseline``: ``bench_baseline_torch.py``, reference-style PyTorch
  copy-the-model FOMAML (``nn.Transformer*``, ``nn.CTCLoss``, fp32 at
  PyTorch's default precision);
- ``vs_samechip_sequential``: ``bench_baseline_seq.py``, the port's own
  ``ASRTask`` compute under the reference's sequential orchestration (a
  copy of the parameters per task, one inner step at a time).

Nothing is cached: two runs may land on two cards, so every ratio comes
from one process on one card. There is no CPU path: without CUDA the
script prints one JSON line with ``value`` null and exits 1.

``mfu`` is the FLOPs of one meta-step as ``torch.utils.flop_counter``
counts them (matrix products, convolutions, attention; the ctypes kernels
K1 and K2 are invisible to it), over the step time, over 989 TFLOP/s (the
H100 SXM data sheet's dense bf16 rate). The reference's ``mfu`` counts
XLA's whole cost analysis on a TPU: the two are not comparable.

Experiment hooks (environment; not set by default; '' and '0' are off):

- ``BENCH_ENCODER=conformer``: the conformer encoder at the same workload;
- ``BENCH_SECOND_ORDER=1``: full second-order MAML (K2b then runs);
- ``BENCH_ADAPT_FILTER=decoder`` (or ``ctc_head,decoder``): ANIL partial
  adaptation;
- ``BENCH_GRAD_DTYPE=float32``: the fp32 meta-step (default bfloat16);
- ``BENCH_PROFILE=1``: a ``torch.profiler`` trace of 5 steps in
  ``profiles/bench_trace.json`` at the root of the checkout;
- ``BENCH_NO_REMAT=1``: keep each inner step's activations instead of
  recomputing them in the outer backward (``MetaAlgoConfig.remat_inner``;
  it acts only with ``BENCH_SECOND_ORDER=1``: first order never
  recomputes);
- ``BENCH_CTC_IMPL=scan``: raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# The reference's bench workload (bench.py:29-35)
M_TASKS = 4
K_SUPPORT = 4
K_QUERY = 4
INNER_STEPS = 3
NUM_SAMPLES = 64000
NUM_TOKENS = 32
VOCAB = 30

H_TASKS, H_K = 4, 16          # the headline operating point (bench.py:263)
METRIC = "fomaml_meta_train_throughput"
UNIT = "unique_utts/s/chip"   # FROZEN: unique utterances/s/chip
PEAK_FLOPS = 989e12           # H100 SXM data sheet, dense bf16
FLOPS_SOURCE = ("torch FlopCounterMode (matmul, conv, attention; K1/K2 "
                "not counted)")
MAX_PASSES, AGREE = 8, 1.10
PROFILE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "profiles")


def _env_flag(name: str) -> bool:
    """Experiment-hook env parsing: '' and '0' are OFF."""
    return os.environ.get(name, "") not in ("", "0")


def bench_config():
    """The reference's bench config: ``Config()`` with the transformer, a
    30-symbol vocabulary, bf16 compute and 3 inner steps."""
    from metaasr_tpu_torch.config import Config

    cfg = Config()
    cfg.model.arch = "transformer"
    cfg.model.encoder = os.environ.get("BENCH_ENCODER", "transformer")
    cfg.model.vocab_size = VOCAB
    cfg.model.dtype = "bfloat16"
    cfg.meta.inner_steps = INNER_STEPS
    return cfg


def algo_config():
    """``MetaAlgoConfig`` as the reference's bench builds it (FOMAML, inner
    lr 1e-2, bf16 meta-step), with the experiment hooks applied."""
    from metaasr_tpu_torch.meta.maml import MetaAlgoConfig

    return MetaAlgoConfig(
        inner_lr=1e-2, inner_steps=INNER_STEPS,
        first_order=not _env_flag("BENCH_SECOND_ORDER"),
        remat_inner=not _env_flag("BENCH_NO_REMAT"),
        adapt_filter=tuple(
            s for s in os.environ.get("BENCH_ADAPT_FILTER", "").split(",")
            if s.strip()) or None,
        grad_dtype=os.environ.get("BENCH_GRAD_DTYPE", "bfloat16") or None)


def adam_config():
    """The port's optimizer set to ``optax.adam(1e-3)``: constant rate,
    optax's betas and epsilon, no clip."""
    from metaasr_tpu_torch.config import OptimizerConfig

    return OptimizerConfig(name="adam", lr=1e-3, schedule="constant",
                           grad_clip=math.inf, weight_decay=0.0,
                           adam_b1=0.9, adam_b2=0.999, adam_eps=1e-8)


def draw_batch(m_tasks: int, k_shot: int) -> dict:
    """The reference's meta-batch (bench.py:83-97) as numpy arrays: numpy
    seed 0, support then query, NUM_SAMPLES of audio 0.1 N(0, 1) and
    NUM_TOKENS tokens in [1, VOCAB - 1) an utterance."""
    rng = np.random.default_rng(0)
    num_samples, num_tokens = NUM_SAMPLES, NUM_TOKENS

    def batch(bsz):
        return {
            "audio": np.asarray(
                0.1 * rng.standard_normal((m_tasks, bsz, num_samples))
            ).astype(np.float32),
            "audio_lens": np.full((m_tasks, bsz), num_samples, np.int32),
            "tokens": rng.integers(1, VOCAB - 1,
                                   (m_tasks, bsz, num_tokens)).astype(np.int32),
            "token_lens": np.full((m_tasks, bsz), num_tokens, np.int32),
        }

    return {"support": batch(k_shot), "query": batch(k_shot)}


def to_device(tree: dict, device) -> dict:
    import torch

    return {k: (to_device(v, device) if isinstance(v, dict)
                else torch.from_numpy(v).to(device)) for k, v in tree.items()}


def steady_pass_time(run_pass, max_passes: int = MAX_PASSES,
                     agree: float = AGREE) -> tuple[float, list[float]]:
    """The reference's repeat rule (bench.py:186-197): call ``run_pass(p)``
    (seconds per step of pass ``p``) until, from the third pass on, the two
    fastest agree within ``agree``, or ``max_passes`` passes; -> (the
    SECOND-FASTEST pass, every pass)."""
    dts = []
    for p in range(max_passes):
        dts.append(run_pass(p))
        s = sorted(dts)
        if p >= 2 and s[1] / s[0] < agree:
            break
    return sorted(dts)[1], dts


class MetaStep:
    """One meta-step of the bench, state carried: ``grad_fn`` ->
    ``opt.update`` -> ``apply_updates``. ``steps_run`` counts calls."""

    def __init__(self, task, meta_batch: dict):
        from metaasr_tpu_torch.meta.maml import maml_grads
        from metaasr_tpu_torch.train.optimizer import Optimizer

        self.grad_fn = maml_grads(task.loss_fn, algo_config(),
                                  task.preprocess)
        self.opt = Optimizer(adam_config())
        self.params = task.init_params(0)
        self.opt_state = self.opt.init(self.params)
        self.meta_batch = meta_batch
        self.steps_run = 0

    def __call__(self, seed: int):
        from metaasr_tpu_torch.train.optimizer import apply_updates

        grads, metrics = self.grad_fn(self.params, self.meta_batch, seed)
        updates, self.opt_state = self.opt.update(grads, self.opt_state,
                                                  self.params)
        self.params = apply_updates(self.params, updates)
        self.steps_run += 1
        return metrics["meta_loss"]


def _profile(torch, step, seed: int, dev) -> int:
    """BENCH_PROFILE: 5 steps under torch.profiler, written as a Chrome
    trace under ``profiles/``; -> the seed after them."""
    from torch.profiler import ProfilerActivity, profile

    from metaasr_tpu_torch.meta.maml import fold_in

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for i in range(5):
            seed = fold_in(seed, 1000 + i)
            loss = step(seed)
        float(loss)
    os.makedirs(PROFILE_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(PROFILE_DIR, "bench_trace.json"))
    return seed


def measure(steps: int = 20, m_tasks: int = M_TASKS, k_shot: int = K_SUPPORT,
            *, cfg=None, device=None, warmup: int = 3,
            max_passes: int = MAX_PASSES) -> dict:
    """Time the meta-step at ``m_tasks`` x (``k_shot`` + ``k_shot``) by the
    reference's rule: 1 + 3 warm-up steps, then passes of ``steps``
    enqueued steps, each ending in a device synchronise and a read of the
    last loss, until the two fastest agree within 10% or 8 passes; the
    SECOND-FASTEST pass is reported. Then one more step under
    ``FlopCounterMode`` for the MFU. ``cfg`` defaults to
    :func:`bench_config`; ``device`` to CUDA (no fallback). ``warmup``
    (at least 1) and ``max_passes`` (at least 2) below the rule's 3 and 8
    are for smoke runs.

    -> {presentations_per_sec, mfu (None off CUDA), flops_per_step,
    ms_per_step, passes_ms (ms per step of each pass), steps_per_pass,
    steps_run (every step, warm-up and FLOP count included), meta_loss}."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from metaasr_tpu_torch.device import resolve_device
    from metaasr_tpu_torch.meta.maml import fold_in
    from metaasr_tpu_torch.task import ASRTask

    if os.environ.get("BENCH_CTC_IMPL") == "scan":
        raise NotImplementedError(
            "BENCH_CTC_IMPL=scan: the port's CTC takes its plain version "
            "for CPU tensors only; on the card it is K2/K2b")
    dev = resolve_device(device)
    cfg = cfg or bench_config()
    task = ASRTask(cfg, device=dev)
    if _env_flag("BENCH_SECOND_ORDER"):
        task.require_full_autodiff()
    step = MetaStep(task, to_device(draw_batch(m_tasks, k_shot), dev))

    def sync(loss):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return float(loss)

    seed = 0
    sync(step(seed))                    # first call: lazy set-up, builds
    for _ in range(warmup):
        loss = step(seed)
    sync(loss)
    if _env_flag("BENCH_PROFILE"):
        seed = _profile(torch, step, seed, dev)

    def run_pass(p: int) -> float:
        nonlocal seed
        t0 = time.perf_counter()
        for i in range(steps):
            seed = fold_in(seed, 10 * p + i)
            loss = step(seed)
        sync(loss)
        return (time.perf_counter() - t0) / steps

    dt, dts = steady_pass_time(run_pass, max_passes)
    with FlopCounterMode(display=False) as counter:
        last = sync(step(fold_in(seed, 99)))
    flops = float(counter.get_total_flops())
    presentations = m_tasks * (k_shot * INNER_STEPS + k_shot)
    return {"presentations_per_sec": presentations / dt,
            "mfu": (flops / dt) / PEAK_FLOPS if dev.type == "cuda" else None,
            "flops_per_step": flops, "ms_per_step": 1e3 * dt,
            "passes_ms": [1e3 * d for d in dts], "steps_per_pass": steps,
            "steps_run": step.steps_run, "meta_loss": last}


def card() -> dict:
    """The card as ``nvidia-smi`` names it: {name, power_limit, count}."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name, power = out.rsplit(",", 1)
    return {"name": name.strip(), "power_limit": power.strip(), "count": 1}


def _ratio(a: float, b: float | None):
    return round(a / b, 2) if b is not None and math.isfinite(b) else None


def _round(x, n: int):
    return round(x, n) if x is not None and math.isfinite(x) else None


def record(head: dict, compat: dict, torch_base: float | None,
           seq_base: float | None, device: dict) -> dict:
    """The reference's record (bench.py:282-320) from the two measurements
    (:func:`measure` at 4 x 16 and 4 x 4) and the baselines'
    presentations/s (None where one failed), plus ``device``,
    ``passes_ms``, ``steps_per_pass`` and ``flops_source``."""
    passes = M_TASKS * (K_SUPPORT * INNER_STEPS + K_QUERY)
    unique = M_TASKS * (K_SUPPORT + K_QUERY)
    h_passes = H_TASKS * (H_K * INNER_STEPS + H_K)
    h_unique = H_TASKS * (H_K + H_K)
    value = head["presentations_per_sec"]
    value44 = compat["presentations_per_sec"]
    vs, vs_seq = _ratio(value44, torch_base), _ratio(value44, seq_base)
    return {
        "metric": METRIC,
        "value": round(value * h_unique / h_passes, 2),
        "unit": UNIT,
        "vs_baseline": vs,
        "vs_samechip_sequential": vs_seq,
        "ratio_workload": "4x4_compat",
        "presentations_per_sec": round(value, 2),
        "mfu": _round(head["mfu"], 4),
        "baseline": "vs_baseline: metaasr_tpu_torch/scripts/"
                    "bench_baseline_torch.py, PyTorch reference-style "
                    "copy-the-model FOMAML (nn.Transformer, nn.CTCLoss, fp32 "
                    "at PyTorch's default precision); vs_samechip_sequential: "
                    "bench_baseline_seq.py, the port's own ASRTask compute "
                    "under the reference's sequential orchestration; both "
                    "on this card in this process, nothing cached, at the "
                    "4x4 workload (compat_4x4 row)",
        "workload": {"tasks": H_TASKS, "k_support": H_K, "k_query": H_K,
                     "inner_steps": INNER_STEPS,
                     "audio_sec": NUM_SAMPLES / 16000},
        "compat_4x4": {"tasks": M_TASKS, "k_shot": K_SUPPORT,
                       "unique_utts_per_sec": round(value44 * unique / passes,
                                                    2),
                       "presentations_per_sec": round(value44, 2),
                       "mfu": _round(compat["mfu"], 4),
                       "vs_baseline": vs, "vs_samechip_sequential": vs_seq},
        "device": device,
        "passes_ms": [round(x, 3) for x in head["passes_ms"]],
        "steps_per_pass": {"headline": head["steps_per_pass"],
                           "compat_4x4": compat["steps_per_pass"]},
        "flops_source": FLOPS_SOURCE,
    }


def no_card_line(what: str) -> str:
    return json.dumps({"metric": METRIC, "value": None, "unit": UNIT,
                       "vs_baseline": None,
                       "error": f"no CUDA device: {what} runs on the card "
                                "only (a CPU reading is never written "
                                "under a per-chip unit)"})


def _baseline(name: str, fn) -> float | None:
    """A baseline's presentations/s, or None (traceback on stderr)."""
    import traceback

    try:
        return fn()
    except Exception:  # noqa: BLE001 — the record still prints
        print(f"# baseline {name} failed", file=sys.stderr)
        traceback.print_exc()
        return None


def main(argv=None, *, measure_fn=None, baseline_steps=None) -> int:
    """The record. ``measure_fn`` (default :func:`measure`) and
    ``baseline_steps`` (default each baseline's own) are for smoke runs
    that cut the depth."""
    import torch

    ap = argparse.ArgumentParser(description="FOMAML meta-train "
                                 "throughput of the port on one GPU")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps per timed pass at both workloads (default "
                    "10 at 4x16, 20 at 4x4; a smaller count is for smoke "
                    "runs)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(no_card_line("the bench"))
        return 1
    from metaasr_tpu_torch.scripts import (
        bench_baseline_seq,
        bench_baseline_torch,
    )

    device = card()
    measure_fn = measure_fn or measure
    steps = {} if baseline_steps is None else {"steps": baseline_steps}
    head = measure_fn(steps=args.steps or 10, m_tasks=H_TASKS, k_shot=H_K)
    torch.cuda.empty_cache()
    compat = measure_fn(steps=args.steps or 20)
    torch.cuda.empty_cache()
    base = _baseline("bench_baseline_torch", lambda: bench_baseline_torch
                     .measure(device="cuda", **steps))
    torch.cuda.empty_cache()
    seq = _baseline("bench_baseline_seq", lambda: bench_baseline_seq
                    .measure(device="cuda", **steps))
    print(json.dumps(record(head, compat, base, seq, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
