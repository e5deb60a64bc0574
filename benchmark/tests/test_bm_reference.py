"""The plain reference agrees with the program where both compute the same
arithmetic (float32 on the CPU, at a small size): the training steps' three
numbers and the served scores. Lower precisions part from it."""

import pytest
import torch

from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gaps(name, dtype, precision=None):
    from benchmark import calibrate, run

    c = tiny.cell(name).override(config={"model": {"dtype": dtype}})
    ctx = tiny.context(name, c=c)
    job = run.load_module(f"{run.HERE}/jobs/{c.workload['job']}.py", "j")
    return calibrate.training_readings(ctx, job.CELL, precision)


@pytest.mark.parametrize("name", ["xfmr-fomaml-4x16", "blstm-train-b16"])
def test_training_reference_is_the_programs_arithmetic(name):
    g = _gaps(name, "float32")
    assert g["loss_gap"] < 1e-5 and g["grad_gap"] < 1e-4
    assert g["change_gap"] < 0.05    # Adam moves never-reached elements


def test_lower_precision_parts_from_the_reference():
    low = _gaps("xfmr-fomaml-4x16", "float32", "fp8")
    same = _gaps("xfmr-fomaml-4x16", "float32")
    assert low["grad_gap"] > 10 * same["grad_gap"]


def test_served_scores_are_the_references():
    from benchmark import calibrate

    c = tiny.cell("xfmr-serve-poisson").override(
        config={"model": {"dtype": "float32"}})
    out = calibrate.serve_readings(tiny.context("", c=c, seconds=1.0), None)
    assert out["answered"] == out["requests"] > 0
    assert out["score_gap"] < 1e-3
    low = calibrate.serve_readings(tiny.context("", c=c, seconds=1.0), "fp8")
    assert low["score_gap"] > 10 * out["score_gap"]
