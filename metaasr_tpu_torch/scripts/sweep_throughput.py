"""Throughput-knee sweep of the port's FOMAML meta-step on one GPU
(counterpart of the reference's ``scripts/sweep_throughput.py``): the same
operating points and the same timing rule as the headline bench (it calls
``bench.measure`` directly, so the numbers are directly comparable to the
headline row).

Prints one JSON line per point and a final summary naming the best point
(with the card's ``nvidia-smi`` name and power limit). An out-of-memory
error ends that point with an error row and the sweep goes on. There is
no CPU path: without CUDA it prints one JSON error line and exits 1.

Usage: python -m metaasr_tpu_torch.scripts.sweep_throughput
           [--points 16x8,8x16,...] [--steps 8]
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from metaasr_tpu_torch.scripts import bench

# ordered roughly by fused batch size (tasks * k): the gain path is bigger
# fused batches, so walk it until it bends
DEFAULT_POINTS = [(4, 4), (8, 8), (16, 8), (8, 16), (16, 16), (32, 8),
                  (8, 32), (32, 16), (16, 32)]


def parse_points(text: str | None) -> list[tuple[int, int]]:
    if not text:
        return list(DEFAULT_POINTS)
    return [tuple(int(v) for v in p.split("x")) for p in text.split(",")]


def row(m_tasks: int, k_shot: int, result: dict) -> dict:
    """One point's row from ``bench.measure``'s result: unique utts/s is
    presentations/s x (k + k) / (k x inner + k)."""
    pres_per_sec, mfu = result["presentations_per_sec"], result["mfu"]
    unique = pres_per_sec * (k_shot + k_shot) / (
        k_shot * bench.INNER_STEPS + k_shot)
    return {"tasks": m_tasks, "k_shot": k_shot,
            "fused_batch": m_tasks * k_shot,
            "unique_utts_per_sec": round(unique, 2),
            "presentations_per_sec": round(pres_per_sec, 2),
            "mfu": round(mfu, 4) if mfu is not None else None}


def sweep(points, steps: int, measure=bench.measure) -> list[dict]:
    """Measure every point in turn, printing each row as it comes; an
    out-of-memory error gives an error row. -> the rows measured."""
    import torch

    rows = []
    for m_tasks, k_shot in points:
        try:
            result = measure(steps=steps, m_tasks=m_tasks, k_shot=k_shot)
        except torch.OutOfMemoryError as e:   # HBM exhaustion ends a leg
            print(json.dumps({"tasks": m_tasks, "k_shot": k_shot,
                              "error": f"{type(e).__name__}: {e}"[:300]}),
                  flush=True)
            continue
        finally:
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        rows.append(row(m_tasks, k_shot, result))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=str, default=None,
                    help="comma list like 16x8,8x16 (tasks x k_shot)")
    ap.add_argument("--steps", type=int, default=8,
                    help="steps per timing pass (big points need fewer)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(bench.no_card_line("the sweep"))
        return 1
    device = bench.card()
    rows = sweep(parse_points(args.points), args.steps)
    if rows:
        best = max(rows, key=lambda r: r["unique_utts_per_sec"])
        print(json.dumps({"summary": "best operating point", **best,
                          "steps_per_pass": args.steps, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
