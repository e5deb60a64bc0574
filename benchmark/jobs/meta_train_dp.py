"""Job kind ``meta_train_dp``: the data-parallel meta-step across cards, one
rank a card, as ``cli.py --mesh-tasks W`` lays it out.

The process the harness starts is rank 0; it starts ranks 1..W-1 as
``python3 -m benchmark.jobs.meta_train_dp`` and waits for them. Every rank
joins one NCCL group through ``parallel.initialize`` (``tcp://`` on
localhost, a free port), builds the trainer with ``group`` and
``mesh_tasks = W``, makes the whole meta-batches from the seed and keeps
its tasks (the traffic's tasks a rank, W times that a step); each step ends
in the program's one fp32 all-reduce of the outer gradient. A host-side
gloo group carries rank 0's go / stop each step, so every rank runs the
same steps.

Correct: the first steps' three gaps against the reference's one-process
step over all W x tasks (the numbers the program claims to equal), and
``rank_gap``: the largest difference of any rank's per-leaf sums of the
parameters and their squares after those steps from rank 0's, which has to
be 0 (every rank takes the same update).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import time

from benchmark import program, training
from benchmark.jobs.meta_train import MetaCell

ALLREDUCE = re.compile(r"nccl.*AllReduce", re.IGNORECASE)
RENDEZVOUS_S = 180.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def leaf_sums(params: dict):
    import torch

    return torch.stack([torch.stack([v.double().sum(), (v.double() ** 2)
                                     .sum()]) for v in params.values()]).cpu()


def rank_main(ctx, rank: int, world: int, port: int) -> dict | None:
    """One rank's run; rank 0 returns the job's result, the others None."""
    import torch
    import torch.distributed as dist

    from metaasr_tpu_torch.parallel.distributed import initialize

    from benchmark.yardstick.trace import traced

    dev = torch.device(f"cuda:{rank}" if ctx.device == "cuda" else "cpu")
    group = initialize(init_method=f"tcp://127.0.0.1:{port}",
                       world_size=world, rank=rank, device=dev,
                       timeout=RENDEZVOUS_S)
    ctl = dist.new_group(backend="gloo")
    cell = MetaCell(ctx, dev, group)
    prog = training.first_steps(cell)
    sums = [torch.zeros_like(leaf_sums(cell.state["params"]))
            for _ in range(world)]
    dist.all_gather(sums, leaf_sums(cell.state["params"]), group=ctl)
    rank_gap = max(float((s - sums[0]).abs().max()) for s in sums)
    program.synchronize(dev)
    dist.barrier(group=ctl)
    t0 = ctx.window_opens() if rank == 0 else time.perf_counter()
    end, steps, n = t0 + ctx.seconds, 0, len(cell.pool)
    flag = torch.zeros(1, dtype=torch.int64)
    while True:
        flag[0] = int(rank == 0 and time.perf_counter() < end)
        dist.broadcast(flag, 0, group=ctl)
        if not flag[0]:
            break
        cell.state, _ = cell.trainer.step(
            cell.state, cell.pool[(training.CHECK_STEPS + steps) % n])
        steps += 1
    program.synchronize(dev)
    window = time.perf_counter() - t0

    def span():
        for i in range(cell.traced_steps):
            cell.state, _ = cell.trainer.step(cell.state, cell.pool[i % n])

    trace = None
    if ctx.trace and rank == 0:
        trace, _ = traced(torch, span)
    elif ctx.trace:
        span()
        program.synchronize(dev)
    peaks = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(peaks, torch.tensor([program.memory_peak(dev)]),
                    group=ctl)
    dist.barrier(group=ctl)
    facts = dict(cell.facts, steps=steps, window_s=window,
                 device_kind=program.device_kind(dev), trace=trace,
                 traced_steps=cell.traced_steps if ctx.trace else 0,
                 chips=world)
    shapes, spec = cell.shapes, cell.reference_spec()
    cell.close()
    del cell
    dist.destroy_process_group()
    program.release(dev)
    if rank:
        return None
    ref = training.reference_readings(ctx, dev, shapes, spec, "fp32")
    checks = training.compared(ctx, dict(training.gaps(prog, ref),
                                         rank_gap=rank_gap))
    return dict(facts, end_to_end={
        ctx.cell.workload["metric"]: steps * facts["utts_per_step"] / window},
        attempted=steps, failed=0,
        memory_peak_bytes=max(int(p) for p in peaks), checks=checks)


def _cell_args(ctx) -> list[str]:
    c = ctx.cell
    return ["--workload", c.name, "--seed", str(ctx.seed), "--seconds",
            str(ctx.seconds), "--trace", str(int(ctx.trace)), "--device",
            ctx.device, "--cell", json.dumps({"config": c.config,
                                              "traffic": c.traffic,
                                              "workload": c.workload})]


def run(ctx) -> dict:
    world, port = ctx.cell.chips, free_port()
    env = dict(os.environ, NCCL_SHM_DISABLE="1")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ranks = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.jobs.meta_train_dp", "--rank",
         str(r), "--world", str(world), "--port", str(port),
         *_cell_args(ctx)], cwd=root, env=env) for r in range(1, world)]
    os.environ["NCCL_SHM_DISABLE"] = "1"
    try:
        out = rank_main(ctx, 0, world, port)
    finally:
        for p in ranks:
            try:
                p.wait(timeout=RENDEZVOUS_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    bad = [p.returncode for p in ranks if p.returncode]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of meta_train_dp")
    for name in ("--workload", "--device", "--cell"):
        ap.add_argument(name, required=True)
    for name in ("--seed", "--rank", "--world", "--port", "--trace"):
        ap.add_argument(name, type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import contextlib

    from benchmark import faults, run

    cell = run.Cell.of_parts(args.workload, args.world,
                             **json.loads(args.cell))
    fault = os.environ.get("BENCHMARK_FAULT")
    with faults.plant(fault) if fault else contextlib.nullcontext():
        rank_main(run.Context(cell, args.seed, args.seconds,
                              bool(args.trace), device=args.device),
                  args.rank, args.world, args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
