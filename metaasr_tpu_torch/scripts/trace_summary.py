"""Summarize a ``torch.profiler`` Chrome trace into a device-op time table
(counterpart of the reference's ``scripts/trace_summary.py``, which reads
a TPU trace).

    BENCH_PROFILE=1 python -m metaasr_tpu_torch.scripts.bench
        # writes profiles/bench_trace.json (5 steps)
    python -m metaasr_tpu_torch.scripts.trace_summary [trace.json] \
        [--steps 5] [--top 25]

Device ops are the trace's events whose ``cat`` is ``kernel``,
``gpu_memcpy`` or ``gpu_memset``, summed by ``dur``: the counterpart of
the TPU plane's "XLA Ops" line. A kernel's name is collapsed to the part
before its argument list (``void `` dropped, template arguments kept), so
that K2 (``ctc_kernel<false, ...>``) and K2b (``ctc_kernel<true, ...>``)
stay separate rows; ``(anonymous namespace)`` inside a name is not taken
for the argument list. The reference leaves ``%while`` out of its total,
a container op whose duration holds its body's ops; a CUDA trace has no
container ops (kernels do not nest), so nothing is left out here.

The table is the reference's: the trace's path, then ``device-op time: X
ms/step (N steps)``, then ``ms/step``, ``%``, ``count`` (per step) and
``op`` rows, the largest first. ``summarize`` returns the same numbers as
a dict. The trace is read with ``json`` alone; nothing here needs a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANON = "(anonymous namespace)"


def find_trace() -> str:
    """The bench's trace: ``profiles/bench_trace.json`` at the root of the
    checkout."""
    from metaasr_tpu_torch.scripts.bench import PROFILE_DIR

    return os.path.join(PROFILE_DIR, "bench_trace.json")


def op_name(name: str) -> str:
    """A device op's row: the kernel's name without ``void `` and without
    its argument list (the first ``(`` outside template brackets that
    does not open ``(anonymous namespace)``)."""
    name = name.removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif ch == "(" and depth == 0 and not name.startswith(ANON, i):
            return name[:i].rstrip()
    return name


def summarize(path: str, steps: int = 5, top: int | None = 25) -> dict:
    """The device ops of a Chrome trace -> {trace, steps, device_ms,
    device_ms_per_step, ops (rows in all), rows: the ``top`` largest
    (every row for None) as {op, ms_per_step, pct, count (per step),
    launches (in the trace)}}. Raises ``SystemExit`` for a trace with no
    device events or no trace at ``path``."""
    if not os.path.exists(path):
        raise SystemExit(f"no trace found at {path} — run BENCH_PROFILE=1 "
                         "python -m metaasr_tpu_torch.scripts.bench")
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    agg = collections.Counter()
    cnt = collections.Counter()
    for ev in events:
        if ev.get("cat") in DEVICE_CATS and ev.get("ph") == "X":
            base = op_name(ev.get("name", "?"))
            agg[base] += float(ev.get("dur", 0.0))     # µs
            cnt[base] += 1
    if not agg:
        raise SystemExit(f"no device events in {path} — a CPU-only "
                         "profile? (trace CUDA activity on the card)")
    total = sum(agg.values())
    ranked = sorted(agg.items(), key=lambda kv: -kv[1])
    return {"trace": path, "steps": steps, "device_ms": total / 1e3,
            "device_ms_per_step": total / steps / 1e3, "ops": len(ranked),
            "rows": [{"op": name, "ms_per_step": t / steps / 1e3,
                      "pct": 100 * t / total, "count": cnt[name] // steps,
                      "launches": cnt[name]}
                     for name, t in ranked[:top]]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", nargs="?", default=None)
    ap.add_argument("--steps", type=int, default=5,
                    help="steps profiled (the bench traces 5)")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    summary = summarize(args.trace or find_trace(), args.steps, args.top)
    print(f"trace: {summary['trace']}")
    print(f"device-op time: {summary['device_ms_per_step']:.2f} ms/step "
          f"({args.steps} steps)")
    print(f"{'ms/step':>9}  {'%':>5}  {'count':>6}  op")
    for row in summary["rows"]:
        print(f"{row['ms_per_step']:9.3f}  {row['pct']:5.1f}  "
              f"{row['count']:6d}  {row['op']}")
    return summary


if __name__ == "__main__":
    main()
