#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``metaasr_tpu_torch``) on one NVIDIA
GPU. Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. build   — compile every CUDA source of the port with nvcc (sm_90a), in
             parallel; print ``nvidia-smi`` name and power limit.
2. kernel  — K1 (fused log-mel fbank) against its plain PyTorch version on
             the card at the serving bucket [16, 64000] with ragged
             lengths (401 samples = 1 frame ... 64000), CMVN none /
             utterance / utterance+norm_var: max |diff| <= 1e-4, exact frame
             lengths; CUDA-event medians of the kernel and the plain version.
3. serving — the config3-width model (d 256, 4 heads, d_ff 2048, 12+6
             layers, char vocab 30, bf16 compute, fp32 weights; weights
             from a numpy seed in the Flax layout, written as a bundle)
             serves four requests through ``ServingDecoder`` on bucket
             (16, 64000) with beam 10, ctc_weight 0.3, max_len 128: a full
             batch twice (the second is timed), a batch of 5, one utterance,
             and the full batch once more under torch.profiler (device busy
             time). K1's launch count, zeroed first, must grow by one per
             request.
4. parity  — a tiny fp32 model served on cuda and on cpu from one bundle
             gives identical texts and scores within 1e-4.
5. ctc_kernel — K2 (CTC alpha/beta) against its plain PyTorch version at
             [B, T, U, V] = [16, 99, 32, 30] (tasks fused), [4, 99, 32, 30]
             (per task), [3, 50, 7, 12] and [8, 1000, 20, 30], with ragged
             T, an empty label and an infeasible row: loss within
             atol = rtol = 1e-5, gradient l2rel <= 1.9e-3, the infeasible
             row's loss and gradient 0 through the autograd Function;
             CUDA-event medians of K2, its plain version and
             F.ctc_loss forward + backward at the first two shapes.
6. meta_step — the config3-width FOMAML meta-step (maml_grads + Adam/Noam,
             clip 5) on bench.py's workload, 4 tasks x (4 + 4) and
             4 x (16 + 16) utterances of 64,000 samples, 32 tokens, 3 inner
             steps, bf16 grad_dtype, SpecAugment on: 2 warm-up, 5 timed and
             1 profiled step per shape; every loss finite, and exactly
             2*M K1 and M*(inner_steps+1) K2 launches per step.
7. train_entry — an 8-accent synthetic corpus; MetaASRTrainer.meta_train
             (through the CLI's make_trainer) for 3 steps at config3 width,
             checkpoints written and restored, meta_adapt on the held-out
             accent, the adapted npz hot-swapped into a ServingDecoder that
             serves one utterance; exact launch counts.

Then a ``{"kernels": [...]}`` line (time, bound, launches on the main
paths per kernel) and the last line ``{"ok": true, "device": {...}}``.
TF32 is off throughout (the reference pins fp32 HIGHEST in the front-end).
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

DEVICE = "cuda"
SERVE_BUCKET = (16, 64000)
CHECK_LENS = [64000, 401, 63999, 560, 48000, 32001, 16000, 60160,
              400, 1234, 55555, 20000, 63840, 8000, 40400, 30000]
K1_TOL = 1e-4          # tests/test_m3_pallas.py's bound for the TPU kernel
PARITY_TOL = 1e-4
NEG = -1.0e9
# (fp32 FLOP/s outside the tensor cores, HBM bytes/s), NVIDIA data sheets
PEAKS = {"H100 PCIe": (51.2e12, 2.0e12), "H100 NVL": (60.0e12, 3.9e12),
         "H100 SXM": (67.0e12, 3.35e12)}


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return f"H100 {key}", PEAKS[f"H100 {key}"]
    return "H100 SXM", PEAKS["H100 SXM"]


def cuda_median_ms(torch, fn, runs: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build():
    from metaasr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    ptxas = [ln.strip() for out in logs.values() for ln in out.splitlines()
             if "registers" in ln or "bytes smem" in ln]
    log({"phase": "build", "sources": list(_build.SOURCES),
         "seconds": round(seconds, 3), "ptxas": ptxas})
    return smi


def make_waves(rng, lens, width):
    audio = np.zeros((len(lens), width), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / 16000.0
        f0 = 100.0 + 300.0 * rng.random()
        audio[i, :n] = (0.3 * np.sin(2 * np.pi * f0 * t)
                        + 0.1 * rng.standard_normal(n))
    return audio


def phase_kernel(torch, peaks):
    from metaasr_tpu_torch.frontend import fbank_kernel
    from metaasr_tpu_torch.frontend.fbank import (
        FbankParams,
        apply_cmvn,
        frame_lengths,
        log_mel_fbank,
    )
    from metaasr_tpu_torch.frontend.oracle import fbank_oracle

    dev = torch.device("cuda")
    bsz, width = SERVE_BUCKET
    audio_np = make_waves(np.random.default_rng(0), CHECK_LENS, width)
    audio = torch.from_numpy(audio_np).to(dev)
    lens = torch.tensor(CHECK_LENS, dtype=torch.int32, device=dev)
    params = FbankParams.create()
    mats = fbank_kernel._device_matrices(params, dev)
    flens = frame_lengths(lens)
    want_lens = [max(0, 1 + (n - 400) // 160) for n in CHECK_LENS]

    errs = {}
    lens_exact = flens.tolist() == want_lens
    for cmvn, nv in (("none", False), ("utterance", False),
                     ("utterance", True)):
        got, got_lens = log_mel_fbank(audio, lens, params, cmvn, nv)
        plain = fbank_kernel.plain_log_mel(audio, flens, *mats)
        if cmvn == "utterance":
            plain = apply_cmvn(plain, flens, nv)
        torch.cuda.synchronize()
        lens_exact = lens_exact and got_lens.tolist() == want_lens
        errs[f"{cmvn}{'+norm_var' if nv else ''}"] = float(
            (got - plain).abs().max())
    # the meta-step's per-task batch: 4 utterances of the same width
    got4, lens4 = log_mel_fbank(audio[:4], lens[:4], params, "none")
    plain4 = fbank_kernel.plain_log_mel(audio[:4], lens4, *mats)
    errs["per_task_4x64000"] = float((got4 - plain4).abs().max())
    max_err = max(errs.values())
    # the float64 numpy oracle on the longest and the 1-frame utterance
    raw, _ = log_mel_fbank(audio, lens, params, "none")
    oracle_err = max(
        float(np.abs(raw[i, : want_lens[i]].cpu().numpy()
                     - fbank_oracle(audio_np[i, : CHECK_LENS[i]])).max())
        for i in (0, 1))

    n_mel = params.num_mel_bins
    nf = raw.shape[1]
    peak_flops, peak_bw = peaks

    def timed(frame_lens):
        """(kernel ms, plain ms, bound ms, bound_by) on these lengths; the
        bound counts the valid frames' operations and every byte once."""
        ms = cuda_median_ms(torch, lambda: fbank_kernel.fused_log_mel(
            audio, frame_lens, params))
        plain_ms = cuda_median_ms(torch, lambda: fbank_kernel.plain_log_mel(
            audio, frame_lens, *mats))
        flops = int(frame_lens.sum()) * (2 * 400 * 256 * 2 + 2 * 256 * n_mel)
        nbytes = 4 * (audio.numel() + bsz + 2 * 400 * 256 + 256 * n_mel
                      + bsz * nf * n_mel)
        t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
        return (ms, plain_ms, 1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    ms, plain_ms, bound_ms, bound_by = timed(flens)
    full = timed(torch.full_like(flens, nf))
    res = {"phase": "kernel", "kernel": "fbank_log_mel",
           "shape": [bsz, width], "frames": bsz * nf,
           "valid_frames": int(flens.sum()), "max_abs_err": max_err,
           "max_abs_err_by_cmvn": errs, "tolerance": K1_TOL,
           "frame_lens_exact": lens_exact,
           "oracle_max_abs_err": oracle_err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "all_frames_valid": {"ms": full[0], "plain_ms": full[1],
                                "bound_ms": full[2], "bound_by": full[3]}}
    log(res)
    if not lens_exact or not max_err <= K1_TOL:
        raise SystemExit("K1 disagrees with its plain version")
    if not oracle_err <= 2e-4:
        raise SystemExit("K1 disagrees with the numpy oracle")
    return res


def config3():
    from metaasr_tpu_torch.config import Config
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer

    # configs/config3_fomaml.yaml's model, decode and data settings
    cfg = Config()
    tok = CharTokenizer.ascii_default()
    m = cfg.model
    m.arch, m.d_model, m.num_heads, m.d_ff = "transformer", 256, 4, 2048
    m.num_encoder_layers, m.num_decoder_layers = 12, 6
    m.dtype, m.vocab_size = "bfloat16", tok.vocab_size
    cfg.data.vocab, cfg.data.max_tokens = "char", 128
    cfg.train.beam_size, cfg.train.decode_ctc_weight = 10, 0.3
    return cfg, tok


def seeded_bundle(cfg, tok, out_dir, buckets, seed):
    from metaasr_tpu_torch.serve.export import write_bundle
    from metaasr_tpu_torch.task import build_model
    from metaasr_tpu_torch.weights import random_state_dict, state_dict_to_flax

    sd = random_state_dict(build_model(cfg), seed)
    tree = state_dict_to_flax(sd, cfg.model.num_heads)
    write_bundle(out_dir, cfg, tree, tok, buckets)


def check_results(results, n, tok):
    if len(results) != n:
        raise SystemExit(f"expected {n} results, got {len(results)}")
    symbols = set(tok.symbols)
    for r in results:
        if not (isinstance(r["text"], str) and set(r["text"]) <= symbols
                and math.isfinite(r["score"]) and r["score"] > NEG / 2):
            raise SystemExit(f"malformed result {r}")


def device_busy(torch, fn):
    """Run ``fn`` under torch.profiler; -> (host wall ms, device busy ms as
    the union of CUDA kernel spans, kernel count, top kernels by time).
    Device numbers are None when the profiler records no CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            s, t = e.time_range.start, e.time_range.end
            spans.append((s, t))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e3
    if not spans:
        return wall, None, 0, []
    busy, cur_s, cur_e = 0.0, None, None
    for s, t in sorted(spans):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return wall, busy / 1e3, len(spans), [[n[:60], ms] for n, ms in top]


def phase_serving(torch):
    from metaasr_tpu_torch.frontend.fbank_kernel import fused_log_mel
    from metaasr_tpu_torch.serve.export import ServingDecoder

    cfg, tok = config3()
    bsz, width = SERVE_BUCKET
    rng = np.random.default_rng(1)
    full_lens = [width] + rng.integers(24000, width, bsz - 1).tolist()
    waves = [w[:n] for w, n in zip(make_waves(rng, full_lens, width),
                                   full_lens)]
    requests = [("full", waves), ("full", waves), ("five", waves[3:8]),
                ("one", waves[5:6])]
    with tempfile.TemporaryDirectory() as d:
        seeded_bundle(cfg, tok, d, [SERVE_BUCKET], seed=0)
        dec = ServingDecoder(d, cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    fused_log_mel.launches = 0
    timings = []
    for name, xs in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = dec.transcribe(xs, nbest=2)
        torch.cuda.synchronize()
        timings.append((name, 1e3 * (time.perf_counter() - t0), res))
    # one more full batch under the profiler: how busy is the device?
    prof = device_busy(torch, lambda: dec.transcribe(waves, nbest=2))
    launches = fused_log_mel.launches
    for (name, _, res), (_, xs) in zip(timings, requests):
        check_results(res, len(xs), tok)
    full_ms = timings[1][1]
    out = {"phase": "serving", "bucket": list(SERVE_BUCKET),
           "model": {"d_model": 256, "heads": 4, "d_ff": 2048,
                     "layers": [12, 6], "vocab": tok.vocab_size,
                     "dtype": "bfloat16"},
           "beam": {"beam_size": 10, "ctc_weight": 0.3, "max_len": 128},
           "requests": [{"name": n, "utts": len(r), "ms": ms,
                         "max_hyp_chars": max(len(x["text"]) for x in r)}
                        for n, ms, r in timings],
           "ms_per_batch_full": full_ms,
           "utts_per_s_full": bsz / (full_ms / 1e3),
           "k1_launches": launches,
           "profiled_full": {"wall_ms": prof[0], "device_busy_ms": prof[1],
                             "cuda_kernels": prof[2], "top_kernels_ms": prof[3]},
           "device_busy_share_of_timed_full": (
               None if prof[1] is None else prof[1] / full_ms),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "sample": timings[1][2][0]}
    log(out)
    if launches != len(requests) + 1:
        raise SystemExit(f"K1 launched {launches} times for "
                         f"{len(requests) + 1} requests")
    return out


def phase_parity(torch):
    from metaasr_tpu_torch.config import Config
    from metaasr_tpu_torch.data.tokenizer import CharTokenizer
    from metaasr_tpu_torch.frontend.fbank_kernel import fused_log_mel
    from metaasr_tpu_torch.serve.export import ServingDecoder

    cfg = Config()
    tok = CharTokenizer.ascii_default()
    m = cfg.model
    m.d_model, m.num_heads, m.d_ff = 32, 2, 64
    m.num_encoder_layers = m.num_decoder_layers = 2
    m.dtype, m.vocab_size = "float32", tok.vocab_size
    cfg.data.max_tokens, cfg.train.beam_size = 8, 3
    lens = [16000, 9000, 401, 12345]
    rng = np.random.default_rng(2)
    waves = [w[:n] for w, n in zip(make_waves(rng, lens, 16000), lens)]
    with tempfile.TemporaryDirectory() as d:
        seeded_bundle(cfg, tok, d, [(4, 16000)], seed=1)
        on_gpu = ServingDecoder(d, cfg, device="cuda")
        on_cpu = ServingDecoder(d, cfg, device="cpu")
    before = fused_log_mel.launches
    got = on_gpu.transcribe(waves, nbest=3)
    want = on_cpu.transcribe(waves, nbest=3)
    same_text = all(
        g["text"] == w["text"]
        and [x["hyp"] for x in g["nbest"]] == [x["hyp"] for x in w["nbest"]]
        for g, w in zip(got, want))
    score_err = max(abs(a["score"] - b["score"])
                    for g, w in zip(got, want)
                    for a, b in zip(g["nbest"], w["nbest"]))
    out = {"phase": "parity", "same_text": same_text,
           "max_score_diff": score_err, "tolerance": PARITY_TOL,
           "k1_launches": fused_log_mel.launches - before,
           "texts": [g["text"] for g in got]}
    log(out)
    if not same_text or not score_err <= PARITY_TOL:
        raise SystemExit("cuda and cpu serving disagree")
    return out


# ---------------------------------------------------------------- K2 ----

CTC_SHAPES = {"fused": (16, 99, 32, 30), "per_task": (4, 99, 32, 30),
              "odd": (3, 50, 7, 12), "long_t": (8, 1000, 20, 30)}
CTC_LOSS_TOL = 1e-5      # atol = rtol, tests/test_m3_pallas.py:45
CTC_GRAD_L2REL = 1.9e-3  # docs/KERNEL_CHECK_TPU.md, T=1000 on the TPU


def ctc_inputs(torch, shape, seed):
    """log-probs [B, T, V] and ragged lens/labels on the card; row 1 has an
    empty label, the last row is infeasible (T too short for its labels)."""
    bsz, t_len, u_len, vocab = shape
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((bsz, t_len, vocab)).astype(np.float32)
    t_lens = rng.integers(max(2 * u_len + 1, t_len // 2), t_len + 1, bsz)
    t_lens[0] = t_len
    labels = rng.integers(1, vocab, (bsz, u_len))
    u_lens = rng.integers(1, u_len + 1, bsz)
    u_lens[0] = u_len
    u_lens[1] = 0
    t_lens[-1], u_lens[-1] = max(1, u_len // 2), u_len
    lp = torch.log_softmax(torch.from_numpy(logits).to(DEVICE), -1)
    as_i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(DEVICE)  # noqa: E731
    return lp, as_i32(t_lens), as_i32(labels), as_i32(u_lens)


def phase_ctc_kernel(torch, peaks):
    import torch.nn.functional as F

    from metaasr_tpu_torch.ops import ctc as ctc_ops
    from metaasr_tpu_torch.ops import ctc_kernel

    peak_flops, peak_bw = peaks
    res = {"phase": "ctc_kernel", "loss_tol": "atol=rtol=1e-5",
           "grad_l2rel_tol": CTC_GRAD_L2REL, "shapes": {}}
    ok = True
    for i, (name, shape) in enumerate(CTC_SHAPES.items()):
        lp, t_lens, labels, u_lens = ctc_inputs(torch, shape, seed=10 + i)
        z = ctc_ops.extend_labels(labels)
        logp_z = ctc_ops.gather_emissions(lp, z).contiguous()
        skip = ctc_ops.skip_bias(z).contiguous()
        end = (2 * u_lens).contiguous()
        nll, grad = ctc_kernel.ctc_alpha_beta(logp_z, skip, t_lens, end)
        p_nll, p_grad = ctc_kernel.plain_ctc_alpha_beta(logp_z, skip, t_lens,
                                                        end)
        torch.cuda.synchronize()
        loss_abs = float((nll - p_nll).abs().max())
        loss_ok = bool(((nll - p_nll).abs()
                        <= CTC_LOSS_TOL * (1 + p_nll.abs())).all())
        l2rel = float(torch.linalg.norm(grad - p_grad)
                      / torch.linalg.norm(p_grad))
        # the loss with autograd: the infeasible row is zeroed, gradient too
        x = lp.detach().clone().requires_grad_(True)
        loss = ctc_kernel.ctc_loss_kernel(x, t_lens, labels, u_lens)
        loss.sum().backward()
        infeasible_zero = (float(loss.detach()[-1]) == 0.0
                           and float(x.grad[-1].abs().max()) == 0.0)
        finite = bool(torch.isfinite(loss).all()
                      and torch.isfinite(x.grad).all())
        entry = {"shape_btuv": list(shape), "loss_max_abs_diff": loss_abs,
                 "loss_ok": loss_ok, "grad_l2rel": l2rel,
                 "grad_max_abs_diff": float((grad - p_grad).abs().max()),
                 "infeasible_row_zero": infeasible_zero, "finite": finite}
        ok = ok and loss_ok and l2rel <= CTC_GRAD_L2REL and infeasible_zero \
            and finite
        if name in ("per_task", "fused"):
            bsz, t_len, _, vocab = shape
            s_len = z.shape[1]
            entry["ms"] = cuda_median_ms(torch, lambda: ctc_kernel.ctc_alpha_beta(
                logp_z, skip, t_lens, end))
            entry["plain_ms"] = cuda_median_ms(
                torch, lambda: ctc_kernel.plain_ctc_alpha_beta(
                    logp_z, skip, t_lens, end), runs=10, warmup=2)
            lp_tbv = lp.transpose(0, 1).contiguous()

            def library():
                y = lp_tbv.detach().requires_grad_(True)
                F.ctc_loss(y, labels, t_lens, u_lens, blank=0,
                           reduction="none", zero_infinity=True).sum().backward()

            entry["library_ms"] = cuda_median_ms(torch, library)
            elems = bsz * t_len * s_len
            ops = 16 * elems           # 10 flops + 6 transcendentals
            nbytes = 4 * (2 * elems + bsz * s_len + 3 * bsz)
            t_ops, t_bytes = ops / peak_flops, nbytes / peak_bw
            entry.update(
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                dependent_steps=2 * t_len,
                us_per_dependent_step=1e3 * entry["ms"] / (2 * t_len))
        res["shapes"][name] = entry
    log(res)
    if not ok:
        raise SystemExit("K2 disagrees with its plain version")
    return res


# ------------------------------------------------------ training path ----

META_SHAPES = ((4, 4), (4, 16))   # (tasks, shots): bench.py's 4x4, 4x16


def config3_train():
    """configs/config3_fomaml.yaml at full width (its model, meta and
    optimizer sections), char vocab."""
    cfg, tok = config3()
    cfg.specaug.enabled = True
    m = cfg.meta
    m.algo, m.grad_dtype, m.inner_lr, m.inner_steps = \
        "fomaml", "bfloat16", 0.01, 3
    m.k_support = m.k_query = m.tasks_per_batch = 4
    m.adapt_steps = 5
    o = cfg.optimizer
    o.name, o.lr, o.schedule, o.warmup_steps = "adam", 0.5, "noam", 2000
    return cfg, tok


def bench_meta_batch(torch, m_tasks, k_shot, vocab):
    """bench.py's workload: audio 0.1 N(0,1) of 64,000 samples, 32 tokens,
    numpy seed 0."""
    rng = np.random.default_rng(0)

    def part():
        return {"audio": (0.1 * rng.standard_normal(
                    (m_tasks, k_shot, 64000))).astype(np.float32),
                "audio_lens": np.full((m_tasks, k_shot), 64000, np.int32),
                "tokens": rng.integers(1, vocab - 1, (m_tasks, k_shot, 32)
                                       ).astype(np.int32),
                "token_lens": np.full((m_tasks, k_shot), 32, np.int32)}

    return {s: {k: torch.from_numpy(v).to(DEVICE) for k, v in part().items()}
            for s in ("support", "query")}


def phase_meta_step(torch):
    from metaasr_tpu_torch.frontend.fbank_kernel import fused_log_mel
    from metaasr_tpu_torch.meta.maml import fold_in, maml_grads
    from metaasr_tpu_torch.ops.ctc_kernel import ctc_alpha_beta
    from metaasr_tpu_torch.task import ASRTask
    from metaasr_tpu_torch.train.meta_train import algo_config
    from metaasr_tpu_torch.train.optimizer import apply_updates, make_optimizer

    cfg, tok = config3_train()
    task = ASRTask(cfg, tok.sos_eos_id, device=DEVICE)
    grad_fn = maml_grads(task.loss_fn, algo_config(cfg), task.preprocess)
    opt = make_optimizer(cfg.optimizer, cfg.model.d_model)
    inner = cfg.meta.inner_steps
    out = {"phase": "meta_step", "inner_steps": inner,
           "grad_dtype": cfg.meta.grad_dtype, "specaug": True,
           "optimizer": "adam, noam lr 0.5 warmup 2000, clip 5.0",
           "cells": []}
    warmup, timed = 2, 5
    for m_tasks, k_shot in META_SHAPES:
        st = {"params": task.init_params(0)}
        st["opt"] = opt.init(st["params"])
        mb = bench_meta_batch(torch, m_tasks, k_shot, tok.vocab_size)
        losses = []

        def one_step(i):
            grads, metrics = grad_fn(st["params"], mb, fold_in(0, i))
            updates, st["opt"] = opt.update(grads, st["opt"], st["params"])
            st["params"] = apply_updates(st["params"], updates)
            losses.append(metrics["meta_loss"])

        fused_log_mel.launches = 0
        ctc_alpha_beta.launches = 0
        for i in range(warmup):
            one_step(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(warmup, warmup + timed):
            t0 = time.perf_counter()
            one_step(i)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated()
        prof = device_busy(torch, lambda: one_step(warmup + timed))
        k1, k2 = fused_log_mel.launches, ctc_alpha_beta.launches
        steps = warmup + timed + 1
        want_k1, want_k2 = steps * 2 * m_tasks, steps * m_tasks * (inner + 1)
        ms = statistics.median(times)
        loss_vals = [float(x) for x in losses]
        cell = {"tasks": m_tasks, "shots": k_shot, "steps": steps,
                "ms_per_step": ms, "ms_per_step_all": times,
                "unique_utts_per_s": m_tasks * 2 * k_shot / (ms / 1e3),
                "presentations_per_s":
                    m_tasks * (k_shot * inner + k_shot) / (ms / 1e3),
                "peak_mem_gb": peak / 1e9,
                "profiled_step": {"wall_ms": prof[0],
                                  "device_busy_ms": prof[1],
                                  "cuda_kernels": prof[2],
                                  "top_kernels_ms": prof[3]},
                "device_busy_share": (None if prof[1] is None
                                      else prof[1] / ms),
                "k1_launches": k1, "k1_expected": want_k1,
                "k2_launches": k2, "k2_expected": want_k2,
                "meta_loss": loss_vals}
        out["cells"].append(cell)
        if not all(math.isfinite(v) for v in loss_vals):
            log(out)
            raise SystemExit("non-finite meta loss")
        if (k1, k2) != (want_k1, want_k2):
            log(out)
            raise SystemExit(f"launch counts K1 {k1} (want {want_k1}), "
                             f"K2 {k2} (want {want_k2})")
        del st, mb
        torch.cuda.empty_cache()
    log(out)
    return out


def phase_train_entry(torch):
    """meta-train -> checkpoint -> adapt -> serve, through the entry points
    a user calls, on a synthetic 8-accent corpus at config3 width."""
    from metaasr_tpu_torch.cli import make_trainer
    from metaasr_tpu_torch.data.audio_io import load_wav
    from metaasr_tpu_torch.data.synthetic import generate_dataset
    from metaasr_tpu_torch.frontend.fbank_kernel import fused_log_mel
    from metaasr_tpu_torch.ops.ctc_kernel import ctc_alpha_beta
    from metaasr_tpu_torch.serve.export import (
        ServingDecoder,
        load_bundle_params,
        write_bundle,
    )
    from metaasr_tpu_torch.train.checkpoint import save_params_npz
    from metaasr_tpu_torch.weights import params_to_flax

    cfg, tok = config3_train()
    steps = 3
    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "data")
        t0 = time.perf_counter()
        generate_dataset(data, utts_per_accent=8, words_per_utt=(2, 4),
                         seed=0)
        gen_s = time.perf_counter() - t0
        cfg.data.data_dir = data
        cfg.data.heldout_accents = ("tango",)
        cfg.train.log_every = 1
        cfg.train.ckpt_every = 2
        cfg.train.keep_ckpts = 2
        fused_log_mel.launches = 0
        ctc_alpha_beta.launches = 0
        t0 = time.perf_counter()
        trainer, tok = make_trainer(cfg, os.path.join(d, "wd"), DEVICE)
        state = trainer.meta_train(max_steps=steps)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        with open(os.path.join(d, "wd", "logs", "scalars.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        ckpts = trainer.ckpt.all_steps()
        restored, at = trainer.ckpt.restore(map_location=DEVICE)
        restored_equal = at == steps and all(
            torch.equal(restored["params"][k], v)
            for k, v in state["params"].items())
        adapted, test_idx = trainer.meta_adapt(
            state["params"], trainer.heldout_datasets["tango"], seed=0)
        npz = os.path.join(d, "adapted.npz")
        save_params_npz(npz, adapted, cfg.model.num_heads)
        bundle = os.path.join(d, "bundle")
        write_bundle(bundle, cfg, params_to_flax(state["params"], 4), tok,
                     [(4, 96000)])
        dec = ServingDecoder(bundle, cfg, device=DEVICE)
        ds = trainer.heldout_datasets["tango"]
        wav = load_wav(os.path.join(ds.manifest.root,
                                    ds.manifest.utts[test_idx[0]].wav))
        served = dec.transcribe([wav], params=load_bundle_params(npz))
        torch.cuda.synchronize()
        k1, k2 = fused_log_mel.launches, ctc_alpha_beta.launches
    m = cfg.meta
    want_k1 = steps * 2 * m.tasks_per_batch + 1 + 1   # + adapt + serve
    want_k2 = steps * m.tasks_per_batch * (m.inner_steps + 1) + m.adapt_steps
    out = {"phase": "train_entry", "accents": 8, "heldout": "tango",
           "corpus_s": gen_s, "meta_train_s": train_s, "steps": state["step"],
           "meta_loss": [r["meta_loss"] for r in recs],
           "utts_per_sec_logged": [r["utts_per_sec"] for r in recs],
           "ckpt_steps": ckpts, "restored_equal": restored_equal,
           "adapted_leaves": len(adapted), "served": served[0],
           "k1_launches": k1, "k1_expected": want_k1,
           "k2_launches": k2, "k2_expected": want_k2}
    log(out)
    if not (state["step"] == steps and ckpts == [2, 3] and restored_equal
            and all(math.isfinite(r["meta_loss"]) for r in recs)):
        raise SystemExit("meta-train / checkpoint round trip failed")
    check_results(served, 1, tok)
    if (k1, k2) != (want_k1, want_k2):
        raise SystemExit(f"train entry launch counts K1 {k1} (want "
                         f"{want_k1}), K2 {k2} (want {want_k2})")
    return out



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import metaasr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = phase_build()
    part, peaks = card_peaks(kind)
    log({"card": smi, "peak_rates_of": part, "fp32_flops": peaks[0],
         "hbm_bytes_per_s": peaks[1]})
    k1 = phase_kernel(torch, peaks)
    serving = phase_serving(torch)
    phase_parity(torch)
    k2 = phase_ctc_kernel(torch, peaks)
    meta = phase_meta_step(torch)
    entry = phase_train_entry(torch)
    k1_paths = {"serving": serving["k1_launches"],
                **{f"meta_step_{c['tasks']}x{c['shots']}": c["k1_launches"]
                   for c in meta["cells"]},
                "train_entry": entry["k1_launches"]}
    k2_paths = {**{f"meta_step_{c['tasks']}x{c['shots']}": c["k2_launches"]
                   for c in meta["cells"]},
                "train_entry": entry["k2_launches"]}
    k2_task = k2["shapes"]["per_task"]
    log({"kernels": [{
        "name": "fbank_log_mel", "route": "cuda",
        "source": "metaasr_tpu_torch/csrc/fbank.cu",
        "replaces": "metaasr_tpu/frontend/pallas_fbank.py:54",
        "launches": sum(k1_paths.values()), "launches_by_path": k1_paths,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None}, {
        "name": "ctc_alpha_beta", "route": "cuda",
        "source": "metaasr_tpu_torch/csrc/ctc.cu",
        "replaces": "metaasr_tpu/ops/ctc_pallas.py:66",
        "launches": sum(k2_paths.values()), "launches_by_path": k2_paths,
        "max_abs_err": max(e["loss_max_abs_diff"]
                           for e in k2["shapes"].values()),
        "grad_l2rel": max(e["grad_l2rel"] for e in k2["shapes"].values()),
        "shape_btuv": k2_task["shape_btuv"], "ms": k2_task["ms"],
        "plain_ms": k2_task["plain_ms"], "bound_ms": k2_task["bound_ms"],
        "bound_by": k2_task["bound_by"],
        "library_ms": k2_task["library_ms"]}]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
