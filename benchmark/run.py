"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. The cell, its configuration, its traffic mix,
its job kind and its metrics are found by name: ``BENCHMARK.json`` names the
cell's configuration and traffic; ``benchmark/workloads/<cell>.json`` its
job kind (``benchmark/jobs/<kind>.py``) and its limits;
``benchmark/traffic/<traffic>.json`` the traffic's parameters; and each
per-layer metric is read by ``benchmark/metrics/<metric>.py``. Adding a
cell, a mix, a job kind or a metric adds files and edits none.

The job loads the program, makes its inputs and weights from ``--seed``,
warms up every shape its traffic uses (set-up, reported as ``setup_s``:
process start to the window's opening), measures for ``--seconds``, then
checks what the timed path produced against the plain reference
(``benchmark/reference``). With ``--trace 1`` it also traces a bounded span
of the same work after the window and reports the per-layer metrics in
place of the end-to-end ones. The last line of standard output is one JSON
object; the compared numbers, each beside its limit, are the last lines of
standard error and the last key of that object.

Exits 2 without a result when CUDA is missing or has fewer cards than the
cell asks for, and 3 when the process holds JAX or the JAX package once the
window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# top-level module names the process may not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "metaasr_tpu")
CACHE_DIR = os.path.join(ROOT, ".bench_cache")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names (``metaasr_tpu_torch`` is not
    ``metaasr_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


class Cell:
    """A cell as the files describe it."""

    def __init__(self, name: str, manifest: dict | None = None):
        manifest = manifest or read_json(os.path.join(ROOT, "BENCHMARK.json"))
        entry = next((w for w in manifest["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.chips = name, int(entry["chips"])
        conf = next(c for c in manifest["configs"]
                    if c["name"] == entry["config"])
        self.config = read_json(os.path.join(ROOT, conf["file"]))
        self.traffic = read_json(os.path.join(HERE, "traffic",
                                              f"{entry['traffic']}.json"))
        self.workload = read_json(os.path.join(HERE, "workloads",
                                               f"{name}.json"))
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]

    @classmethod
    def of_parts(cls, name: str, chips: int, config: dict, traffic: dict,
                 workload: dict) -> "Cell":
        """A cell handed over whole (to a process a job starts), without
        reading the manifest; it reports no metrics itself."""
        cell = cls.__new__(cls)
        cell.name, cell.chips = name, chips
        cell.config, cell.traffic, cell.workload = config, traffic, workload
        cell.end_to_end, cell.per_layer = [], []
        return cell

    def override(self, **parts) -> "Cell":
        """Lay a test's values over the files' ({config: {section: {key:
        value}}, traffic: {...}, workload: {...}}), for runs at a size the
        CPU holds."""
        for part, values in parts.items():
            target = getattr(self, part)
            for key, value in values.items():
                if isinstance(value, dict):
                    target.setdefault(key, {}).update(value)
                else:
                    target[key] = value
        return self


class Context:
    """What a job gets: the cell, the run's arguments and device, and the
    set-up clock."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda"):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device = trace, device
        self.setup_s = None

    def window_opens(self) -> float:
        """Record the set-up time; -> the window's start on the clock."""
        now = time.perf_counter()
        self.setup_s = now - _T0
        return now


def run_cell(ctx: Context) -> dict:
    """Run the cell's job -> the result object, without the look for a
    card."""
    cell = ctx.cell
    job = load_module(os.path.join(HERE, "jobs",
                                   f"{cell.workload['job']}.py"),
                      f"benchmark_job_{cell.workload['job']}")
    out = job.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)} after the window",
              file=sys.stderr)
        raise SystemExit(3)
    if ctx.trace:
        metrics = {}
        for m in cell.per_layer:
            reader = load_module(os.path.join(HERE, "metrics",
                                              f"{m['name']}.py"),
                                 f"benchmark_metric_{m['name']}")
            value = reader.read(out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=ctx.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = out["checks"]
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks) and out["failed"] == 0
    device = {"platform": "gpu" if ctx.device == "cuda" else ctx.device,
              "kind": out["device_kind"], "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    trace = out.get("trace")
    if ctx.trace and trace is not None:
        device.update(busy_s=trace.busy_s(), window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine "
              f"has {have}", file=sys.stderr)
        return 2
    result = run_cell(Context(cell, args.seed, args.seconds,
                              bool(args.trace)))
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
