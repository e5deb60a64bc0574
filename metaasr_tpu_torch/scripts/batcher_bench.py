"""``DynamicBatcher`` under load on one NVIDIA GPU (counterpart of the
reference's ``scripts/batcher_bench.py``: the same legs, rows and flags).

Drives the serving front door (``serve/batcher.py``, ``submit() ->
Future``) against a feature-mode bundle of the flagship model with Poisson
open-loop arrivals at a sweep of offered loads, and reports:

- p50/p95/p99 request latency (submit -> future resolved) per offered load;
- the achieved throughput (where the service saturates);
- the mean group the grouping deadline makes at each load;
- deadline adherence: a lone request at idle should take about
  ``max_wait_ms`` + one batch-1 decode (``direct_b1_ms``).

The workload is ``serve_bench.py``'s: d 256, 12 + 6 layers, bf16 compute,
4 s utterances (400 frames), beam 10, 48 forced decoder steps; buckets
(1, 400), (4, 400) and (16, 400), so a small group does not pay the
16-row decode. ``--tiny`` swaps in the reference's small model (d 32,
2 + 2 layers, fp32, beam 3, 8 steps) and short legs: a check of the
harness, not a measurement. Weights come from numpy seed 0.

The defaults are the reference's interface, ``--loads
25,50,100,150,200,250`` and ``--secs 15``, set for a TPU that served ~228
utts/s. On an H100 the port serves an order of magnitude less (its search
is host-bound), so at those loads the unbounded input queue grows by
thousands of requests, the waiters' 120 s timeouts fire and ``close()``
flushes the backlog: such a run takes tens of minutes. Pass loads as
multiples of ``serve_bench.py``'s pipelined rate instead, e.g. ``--loads
2.5,5,10,15``.

Run on the card only (without CUDA it prints one JSON error line and
exits 1):

    python -m metaasr_tpu_torch.scripts.batcher_bench [--loads 5,10,...]
        [--secs 15] [--max-wait-ms 10] [--max-inflight 2] [--tiny]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from metaasr_tpu_torch.scripts.bench import card
from metaasr_tpu_torch.scripts.decode_bench import no_card_line
from metaasr_tpu_torch.scripts.serve_bench import (
    bench_config,
    write_seeded_bundle,
)
from metaasr_tpu_torch.serve import DynamicBatcher, ServingDecoder

T_FEAT = 400
BSZ = 16
BUCKETS = ((1, T_FEAT), (4, T_FEAT), (BSZ, T_FEAT))


def _build_bundle(d: str, tiny: bool = False) -> dict:
    """The flagship (or ``tiny``) feature-mode bundle on the three buckets
    -> its manifest."""
    cfg, tok = bench_config()
    if tiny:  # the harness check (--tiny): not a measurement
        m = cfg.model
        m.d_model, m.num_heads, m.d_ff = 32, 2, 64
        m.num_encoder_layers, m.num_decoder_layers = 2, 2
        m.dtype = "float32"
        cfg.train.beam_size = 3
        cfg.data.max_tokens = cfg.train.beam_min_len = 8
    return write_seeded_bundle(d, cfg, tok, BUCKETS)


def _load_leg(batcher, rate_hz: float, secs: float, rng,
              latencies: list | None = None):
    """Open-loop Poisson arrivals at rate_hz for secs; returns latencies
    (ms percentiles), achieved rate, and the batcher's group counts.
    ``latencies``, if given, receives the completed requests' seconds,
    sorted."""
    feats = [np.asarray(rng.standard_normal((T_FEAT, 80)), np.float32)
             for _ in range(32)]
    lat: list[float] = []
    lat_lock = threading.Lock()
    inflight: list[threading.Thread] = []
    b0 = dict(batcher.stats)
    t_end = time.monotonic() + secs
    n_sent = 0
    t0 = time.monotonic()
    nxt = time.monotonic()
    while time.monotonic() < t_end:
        nxt += rng.exponential(1.0 / rate_hz)
        dt = nxt - time.monotonic()
        if dt > 0:
            time.sleep(dt)
        t_sub = time.perf_counter()
        fut = batcher.submit(feats[n_sent % len(feats)])
        n_sent += 1

        def wait(f=fut, t=t_sub):
            try:
                f.result(timeout=120)
            except Exception:
                return  # timed-out/failed request: counted via sent-completed
            with lat_lock:
                lat.append(time.perf_counter() - t)

        th = threading.Thread(target=wait, daemon=True)
        th.start()
        inflight.append(th)
    for th in inflight:
        th.join(timeout=180)
    wall = time.monotonic() - t0
    lat = sorted(lat)
    if latencies is not None:
        latencies.extend(lat)

    def pct(p):
        if not lat:
            return None
        return round(1e3 * lat[min(len(lat) - 1,
                                   int(p / 100 * len(lat)))], 1)

    return {
        "offered_utts_per_sec": rate_hz,
        "sent": n_sent, "completed": len(lat),
        "achieved_utts_per_sec": round(len(lat) / wall, 1),
        "p50_ms": pct(50), "p95_ms": pct(95), "p99_ms": pct(99),
        "batches": batcher.stats["batches"] - b0["batches"],
        "mean_group": round((batcher.stats["requests"] - b0["requests"])
                            / max(batcher.stats["batches"] - b0["batches"],
                                  1), 2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--loads", default="25,50,100,150,200,250")
    ap.add_argument("--secs", type=float, default=15.0)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model + short legs: a harness check")
    ap.add_argument("--max-inflight", type=int, default=2,
                    help="DynamicBatcher in-flight dispatch cap")
    args = ap.parse_args(argv)
    if args.tiny:
        args.secs = min(args.secs, 3.0)
        args.loads = "20,60"
    if not torch.cuda.is_available():
        print(no_card_line("batcher_bench"))
        return 1
    print(json.dumps({"device": card()}), flush=True)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        _build_bundle(d, tiny=args.tiny)
        dec = ServingDecoder(d)
        # warm every bucket before the timed legs
        for b, w in dec.buckets:
            dec.transcribe([np.zeros((T_FEAT, 80), np.float32)] * b)
        print("# buckets warmed", flush=True)

        # --- deadline adherence: one lone request at idle ---
        with DynamicBatcher(dec, max_wait_ms=args.max_wait_ms) as lone:
            lats = []
            for _ in range(10):
                t0 = time.perf_counter()
                lone.submit(np.asarray(rng.standard_normal((T_FEAT, 80)),
                                       np.float32)).result(timeout=60)
                lats.append(time.perf_counter() - t0)
            # single-request reference: direct B=1 decode, no batcher
            t0 = time.perf_counter()
            for _ in range(5):
                dec.transcribe([np.asarray(
                    rng.standard_normal((T_FEAT, 80)), np.float32)])
            direct_ms = (time.perf_counter() - t0) / 5 * 1e3
            idle = {"idle_p50_ms": round(sorted(lats)[5] * 1e3, 1),
                    "direct_b1_ms": round(direct_ms, 1),
                    "max_wait_ms": args.max_wait_ms}
            print(json.dumps({"deadline_adherence": idle}), flush=True)

        # --- load sweep ---
        rows = []
        batcher = DynamicBatcher(dec, max_wait_ms=args.max_wait_ms,
                                 max_inflight=args.max_inflight)
        try:
            for rate in (float(r) for r in args.loads.split(",")):
                row = _load_leg(batcher, rate, args.secs, rng)
                rows.append(row)
                print(json.dumps(row), flush=True)
        finally:
            batcher.close()

        sat = max(rows, key=lambda r: r["achieved_utts_per_sec"])
        print(json.dumps({"saturation_utts_per_sec":
                          sat["achieved_utts_per_sec"],
                          "at_offered": sat["offered_utts_per_sec"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
