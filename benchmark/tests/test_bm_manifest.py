"""BENCHMARK.json against the contract's shapes, and every name it gives
found as a file."""

import json
import os
import re

import pytest

from benchmark import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module", params=["listed", "with_waiting"])
def manifest(request):
    """BENCHMARK.json, and with the cells that wait for their proof added
    as a later PR would add them."""
    from benchmark import calibrate

    if request.param == "with_waiting":
        return calibrate.with_waiting()
    return json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape(manifest):
    assert set(manifest) == KEYS["top"]
    assert 1 <= manifest["run_seconds"] <= 51
    for p in manifest["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert len(manifest["command"]) <= 32
    assert all(_line(w) for w in manifest["command"])
    for c in manifest["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"])
        assert _line(c["why"]) and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/")
    for w in manifest["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4)
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert _line(w["why"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["end_to_end"]
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"]
        assert _line(m["layer"])
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for group in ("configs", "workloads"):
        names = [x["name"] for x in manifest[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert "setup_s" in names
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) < 65536


def test_every_name_is_a_file(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    for name in cells:
        cell = run.Cell(name, manifest)
        assert os.path.exists(os.path.join(
            run.HERE, "jobs", f"{cell.workload['job']}.py"))
        main = [m for m in cell.end_to_end if m["name"] != "setup_s"]
        assert main and cell.per_layer, name
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    for m in manifest["per_layer"]:
        assert os.path.exists(os.path.join(run.HERE, "metrics",
                                           f"{m['name']}.py"))
        reported = [e for e in manifest["end_to_end"]
                    if e["name"] == m["moves"]]
        assert reported
        for w in m.get("workloads", []):
            assert w in cells
            assert w in reported[0].get("workloads", [w])


def test_configs_hold_what_they_run(manifest):
    """Each configuration file is a complete program configuration: every
    key a setting of the program, nothing cut (``reduced`` empty)."""
    from benchmark import program

    for c in manifest["configs"]:
        conf = json.load(open(os.path.join(run.ROOT, c["file"])))
        assert conf["reduced"] == c["reduced"] == []
        program.config(conf)
