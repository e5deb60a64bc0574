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

Then a ``{"kernels": [...]}`` line (time, bound, launches per kernel) and
the last line ``{"ok": true, "device": {...}}``. TF32 is off throughout
(the reference pins fp32 HIGHEST in the front-end).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

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
    try:
        prof = device_busy(torch, lambda: dec.transcribe(waves, nbest=2))
    except Exception as e:  # the profiler is optional; the run is not
        prof = (None, None, 0, [f"not measured: {e!r}"])
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
    log({"kernels": [{
        "name": "fbank_log_mel", "route": "cuda",
        "source": "metaasr_tpu_torch/csrc/fbank.cu",
        "replaces": "metaasr_tpu/frontend/pallas_fbank.py:54",
        "launches": serving["k1_launches"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None}]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
