"""The readings a cell's limits are set from, in one process on the card.

    python3 -m benchmark.calibrate --workload NAME --seeds 1,2,...
        [--control-seeds 1,2,3] [--faults half_batch] [--seconds 8]

Per seed, one JSON line with the numbers the cell compares:

- ``program``: the program's sound run (training: its first steps from
  set-up; serving: a window of ``--seconds`` at the cell's load);
- ``control``: the reference itself in the precision below the one the
  configuration states (the workload file's ``control``) put in the
  program's place, on the program's own inputs;
- a fault (``--faults``): the program with the timed path broken
  underneath (``benchmark/faults.py``).

The lower reading of a limit is the largest ``program`` reading over the
seeds; the upper, the smallest control or fault reading. A step that
returns its state unchanged reads 1 on ``change_gap`` by construction and
needs no run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


def with_waiting() -> dict:
    """``BENCHMARK.json`` with the entries of ``waiting.json`` added: cells
    built and run on the CPU that no run on the card has proven yet, for
    their calibration and the tests."""
    from benchmark import run

    manifest = run.read_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    waiting = run.read_json(os.path.join(run.HERE, "waiting.json"))
    for group, entries in waiting.items():
        manifest[group] = manifest[group] + entries
    return manifest


def training_readings(ctx, cell_cls, precision: str | None):
    """-> the three gaps of the program (``precision`` None) or of the
    reference in ``precision``."""
    import torch

    from benchmark import program, training

    dev = torch.device(ctx.device)
    cell = cell_cls(ctx, dev)
    shapes, spec = cell.shapes, cell.reference_spec()
    if precision is None:
        prog = training.first_steps(cell)
    cell.close()
    del cell
    program.release(dev)
    ref = training.reference_readings(ctx, dev, shapes, spec, "fp32")
    if precision is not None:
        prog = training.reference_readings(ctx, dev, shapes, spec, precision)
    return training.gaps(prog, ref)


def serve_readings(ctx, precision: str | None):
    import torch

    from benchmark import program
    from benchmark.jobs import serve

    dev = torch.device(ctx.device)
    srv = serve.Server(ctx, dev)
    window = srv.requests(ctx.seconds, ctx.seed)
    srv.offer(window)
    answered = [i for i, r in enumerate(window.results) if r is not None]
    chosen = [(window.payloads[i], window.results[i]) for i in answered]
    shapes, ids = srv.shapes, srv.ids
    srv.close()
    del srv
    program.release(dev)
    out = {"answered": len(answered), "requests": len(window.due)}
    if precision is None:
        out["score_gap"] = serve.score_gap(ctx, dev, shapes, ids, chosen,
                                           "fp32")
        return out
    # the control: the reference in ``precision`` scores the same served
    # hypotheses, against the reference in float32
    import numpy as np

    ref = serve.reference_scores(ctx, dev, shapes, ids, chosen, "fp32")
    low = serve.reference_scores(ctx, dev, shapes, ids, chosen, precision)
    out["score_gap"] = float(max(
        np.max(np.where(np.isneginf(a) & np.isneginf(b), 0.0,
                        np.abs(a - b))) for a, b in zip(low, ref)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--also", default="",
                    help="more precisions to read the reference in on the "
                    "control seeds (tf32: a perturbation finer than the "
                    "program's own rounding)")
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    from benchmark import faults, run

    cell = run.Cell(args.workload, with_waiting())
    job = run.load_module(f"{run.HERE}/jobs/{cell.workload['job']}.py",
                          f"benchmark_job_{cell.workload['job']}")

    def readings(seed, precision, fault=None):
        ctx = run.Context(cell, seed, args.seconds, False)
        with faults.plant(fault) if fault else contextlib.nullcontext():
            if cell.workload["job"] == "serve":
                return serve_readings(ctx, precision)
            return training_readings(ctx, job.CELL, precision)

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    for seed in seeds(args.seeds):
        print(json.dumps({"seed": seed, "program": readings(seed, None)}),
              flush=True)
    for seed in seeds(args.control_seeds):
        print(json.dumps({"seed": seed, "control": cell.workload["control"],
                          "reading": readings(seed,
                                              cell.workload["control"])}),
              flush=True)
        for precision in (p for p in args.also.split(",") if p):
            print(json.dumps({"seed": seed, "precision": precision,
                              "reading": readings(seed, precision)}),
                  flush=True)
        for name in (f for f in args.faults.split(",") if f):
            print(json.dumps({"seed": seed, "fault": name,
                              "reading": readings(seed, None, name)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
