"""Bare bf16 matmuls at the meta-step's main shapes on one NVIDIA GPU
(counterpart of the reference's ``scripts/matmul_roofline.py``).

Does a shape the flagship model runs reach the card's matrix rate on its
own? If it does, a slow step loses its time to scheduling; if not, to the
shape. Each row times a chain of ``iters`` = 50 dependent pairs ``y = x @
b``, ``x = (y @ bᵀ).to(bf16)`` (batched where ``b`` is 3-D) through
``torch.matmul`` (cuBLAS). The reference's chain is one jitted ``scan``,
one dispatch; its counterpart here is the chain captured once as a CUDA
graph and replayed, so the host's dispatch is out of the row (``tflops``).
The same chain launched eagerly from Python (``eager_tflops``) adds the
host's 100 dispatches: the gap between the two is a scheduling loss, not
the shape's. This is a measurement of cuBLAS, not the port of a kernel.

Shapes (the bench's workload: 4 tasks x 4 utterances, T = 99 encoder
frames after 4x subsampling, d 256, d_ff 2048, 4 heads):

  encoder QKV/proj:   [B*T, 256]   x [256, 256]    (B*T = 16*99 = 1584)
  encoder FFN in:     [B*T, 256]   x [256, 2048]
  encoder FFN out:    [B*T, 2048]  x [2048, 256]
  attention scores:   batched [16*4, 99, 64] x [16*4, 64, 99]
  per-task:           batched [4, 396, 256] x [4, 256, 256]
  large batch (8x8):  [8*8*99, 256] x [256, 2048]
  ideal-large:        [8192, 2048] x [2048, 2048]

Each way, a warm-up run, then the median of 3 timed runs, each ended by
``torch.cuda.synchronize()`` and a host read of one value. FLOPs are the
reference's count, 2 * 2 * batch * m * k * n * iters; the peak is
``bench.PEAK_FLOPS`` (989 TFLOP/s, H100 SXM dense bf16).

    python -m metaasr_tpu_torch.scripts.matmul_roofline

Prints a ``{"device": ...}`` line (the card's name and power limit), then
one row per shape with TF/s and % of the peak; ``main`` returns the rows.
Without CUDA it prints one JSON error line and exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

ITERS = 50
ROWS = [
    ("enc qkv/proj [1584,256]x[256,256]", (1584, 256), (256, 256)),
    ("enc ffn-in   [1584,256]x[256,2048]", (1584, 256), (256, 2048)),
    ("enc ffn-out  [1584,2048]x[2048,256]", (1584, 2048), (2048, 256)),
    ("attn scores  [64,99,64]x[64,64,99]", (64, 99, 64), (64, 64, 99)),
    ("task-batched [4,396,256]x[4,256,256]", (4, 396, 256), (4, 256, 256)),
    ("8x8-shot ffn [6336,256]x[256,2048]", (6336, 256), (256, 2048)),
    ("ideal-large  [8192,2048]x[2048,2048]", (8192, 2048), (2048, 2048)),
]


def chain_flops(a_shape, b_shape, iters: int = ITERS) -> int:
    """The reference's count for one chain: forward and transposed product
    of every pair."""
    m = math.prod(a_shape[:-1])
    k, n, batch = a_shape[-1], b_shape[-1], 1
    if len(b_shape) == 3:
        batch = b_shape[0]
        m = math.prod(a_shape[1:-1])
    return 2 * 2 * batch * m * k * n * iters


def _median3(torch, run) -> float:
    """Seconds of ``run()``: a warm-up, then the median of 3 runs, each
    ended by a synchronize and a host read of one value of its output."""
    run()
    torch.cuda.synchronize()
    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        float(out.reshape(-1)[0].float())
        dts.append(time.perf_counter() - t0)
    return sorted(dts)[1]


def bench_matmul(torch, a_shape, b_shape, iters: int = ITERS,
                 device="cuda") -> dict:
    """One row: {ms, tflops} of the chain replayed as a CUDA graph and
    {eager_ms, eager_tflops} of it launched from Python, medians of 3."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal(a_shape).astype(np.float32)).to(
        device, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(b_shape).astype(np.float32)).to(
        device, torch.bfloat16)
    bt = b.transpose(-1, -2)

    def run():
        x = a
        for _ in range(iters):
            y = torch.matmul(x, b)
            x = torch.matmul(y, bt).to(torch.bfloat16)
        return x

    flops = chain_flops(a_shape, b_shape, iters)
    with torch.inference_mode():
        eager = _median3(torch, run)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()                 # cuBLAS's workspace, off the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()

        def replay():
            graph.replay()
            return out

        dt = _median3(torch, replay)
    return {"ms": 1e3 * dt, "tflops": flops / dt / 1e12,
            "eager_ms": 1e3 * eager, "eager_tflops": flops / eager / 1e12}


def main(argv=None) -> list[dict]:
    import torch

    from metaasr_tpu_torch.scripts.bench import PEAK_FLOPS, card

    argparse.ArgumentParser(description="bare bf16 matmuls at the "
                            "meta-step's shapes on one GPU").parse_args(argv)
    if not torch.cuda.is_available():
        from metaasr_tpu_torch.scripts.decode_bench import no_card_line

        print(no_card_line("matmul_roofline"))
        raise SystemExit(1)
    from metaasr_tpu_torch.device import resolve_device

    resolve_device("cuda")       # the port's precision policy
    peak = PEAK_FLOPS / 1e12
    print(json.dumps({"device": card()}), flush=True)
    print(f"bf16 peak {peak:g} TF/s (H100 SXM dense), {ITERS} dependent "
          "pairs a chain as one CUDA graph (eager: launched from Python), "
          "median of 3")
    rows = []
    for name, a, b in ROWS:
        r = bench_matmul(torch, a, b)
        rows.append({"name": name, "a": list(a), "b": list(b), **r,
                     "pct_peak": 100 * r["tflops"] / peak})
        print(f"  {name:<42} {r['tflops']:7.1f} TF/s  "
              f"({rows[-1]['pct_peak']:5.1f}% peak)  eager "
              f"{r['eager_tflops']:7.1f} TF/s", flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
