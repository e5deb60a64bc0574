"""The port's acceptance drill (``metaasr_tpu_torch/scripts/acceptance.py``),
composition only, on the CPU: every stage (CV prep, meta-train, adapt,
adapted npz, export, serve) runs green as a subprocess of the port's entry
points, as ``tests/test_acceptance.py`` holds the reference's drill.

The stages inherit ``OMP_NUM_THREADS=1``: torch in each holds one
intra-op thread, as the port's in-process tests do
(``tests/torch_threads.py``)."""

import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_acceptance_drill_smoke(tmp_path):
    out = str(tmp_path / "acc")
    r = subprocess.run(
        [sys.executable, "-m", "metaasr_tpu_torch.scripts.acceptance",
         "--out", out, "--smoke", "--steps", "6", "--utts", "10",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "ACCEPTANCE GREEN" in r.stdout
    with open(os.path.join(out, "acceptance.json")) as f:
        summary = json.load(f)
    assert math.isfinite(summary["served_wer"])
    assert math.isfinite(summary["adapted_wer"])
    assert summary["device"] == "cpu"
    assert summary["stages"]["prepare_data"]["manifests"] == [
        "england.jsonl", "india.jsonl", "us.jsonl"]
    with open(os.path.join(out, "serve_out.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 8
    for rec in records:
        assert "text" in rec and "score" in rec
    # the drill writes no JAX programs: the port's bundle holds none
    with open(os.path.join(out, "bundle", "meta.json")) as f:
        assert json.load(f)["platforms"] == []
