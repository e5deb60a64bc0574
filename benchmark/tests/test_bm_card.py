"""On the card, at each cell's own size: the control, the reference put in
the program's place in the precision below the configuration's, fails the
cell's limits, and the program's sound run meets them."""

import pytest

from benchmark import calibrate, run

CELLS = [w["name"] for w in
         run.read_json(f"{run.ROOT}/BENCHMARK.json")["workloads"]]


def _readings(name, seed, precision):
    cell = run.Cell(name)
    ctx = run.Context(cell, seed, 8.0, False)
    if cell.workload["job"] == "serve":
        return cell, calibrate.serve_readings(ctx, precision)
    job = run.load_module(f"{run.HERE}/jobs/{cell.workload['job']}.py", "j")
    return cell, calibrate.training_readings(ctx, job.CELL, precision)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cell, low = _readings(name, 2**31 + 101, cell_control(name))
    limits = cell.workload["limits"]
    assert any(low[k] > v for k, v in limits.items()), low
    _, sound = _readings(name, 2**31 + 101, None)
    assert all(sound[k] <= v for k, v in limits.items()), sound


def cell_control(name):
    return run.Cell(name).workload["control"]
