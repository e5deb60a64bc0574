"""A cell, a traffic mix, a job kind and a metric added as files, with
their entries in BENCHMARK.json, are found by name: no file of the harness
is edited."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import run

JOB = '''
def run(ctx):
    t0 = ctx.window_opens()
    return {"end_to_end": {"echo_per_s": ctx.cell.traffic["rate"]},
            "attempted": 3, "failed": 0, "memory_peak_bytes": 0,
            "device_kind": "cpu", "steps": 3, "trace": None,
            "checks": [{"name": "gap", "value": 0.0,
                        "limit": ctx.cell.workload["limits"]["gap"]}]}
'''
METRIC = '''
def read(out):
    return out["steps"] * 2.0
'''


def test_files_dropped_in_are_found(tmp_path):
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
    manifest["workloads"].append({
        "name": "echo-cell", "config": manifest["configs"][0]["name"],
        "traffic": "echo-mix", "chips": 1, "why": "a cell added as files"})
    manifest["end_to_end"].append({
        "name": "echo_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.05, "source": "host_clock", "workloads": ["echo-cell"]})
    manifest["per_layer"].append({
        "name": "echo_steps.x2", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "echo", "moves": "echo_per_s",
        "workloads": ["echo-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    b = tmp_path / "benchmark"
    (b / "traffic" / "echo-mix.json").write_text('{"rate": 7.5}')
    (b / "workloads" / "echo-cell.json").write_text(
        '{"job": "echo", "limits": {"gap": 0.1}}')
    (b / "jobs" / "echo.py").write_text(JOB)
    (b / "metrics" / "echo_steps.x2.py").write_text(METRIC)
    code = ("import json\nfrom benchmark import run\n"
            "for trace in (False, True):\n"
            "    c = run.Cell('echo-cell')\n"
            "    print(json.dumps(run.run_cell(run.Context(c, 1, 1.0, trace,"
            " device='cpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    plain, traced = (json.loads(line)
                     for line in out.stdout.strip().splitlines())
    assert plain["metrics"]["echo_per_s"]["value"] == 7.5
    assert "setup_s" in plain["metrics"] and plain["correct"] is True
    assert traced["metrics"] == {"echo_steps.x2": {"value": 6.0,
                                                   "unit": "steps"}}


def test_a_checkout_without_the_program_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no result, exit not
    0."""
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "blstm-train-b16", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    # past the look for a card it is the program that is missing
    code = ("from benchmark import run\n"
            "run.run_cell(run.Context(run.Cell('blstm-train-b16'), 1, 1.0,"
            " False, device='cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "metaasr_tpu_torch" in out.stderr
