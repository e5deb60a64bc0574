"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, everything else as a run on the card
does it, at a size the CPU holds."""

import pytest
import torch

from benchmark import calibrate, faults, run
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name, fault=None):
    ctx = tiny.context(name)
    if fault is None:
        return run.run_cell(ctx)
    with faults.plant(fault):
        return run.run_cell(ctx)


@pytest.mark.parametrize("name,fault", [
    ("xfmr-fomaml-4x16", "unchanged"), ("xfmr-fomaml-4x16", "half_batch"),
    ("blstm-train-b16", "unchanged"), ("blstm-train-b16", "half_batch"),
    ("xfmr-serve-poisson", "altered_token")])
def test_a_fault_is_not_correct(name, fault):
    res = _run(name, fault)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("name", ["xfmr-fomaml-4x16", "blstm-train-b16",
                                  "xfmr-serve-poisson"])
def test_a_sound_run_prints_its_result(name):
    res = run.run_cell(tiny.context(name))
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert list(res)[-1] == "checks"
    assert res["failed"] == 0 and res["attempted"] > 0
    cell = tiny.cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def _dp_cell():
    """The four-rank cell, which ``BENCHMARK.json`` does not list yet: it
    has not been proven across cards (``waiting.json``)."""
    return run.Cell("xfmr-fomaml-dp4", calibrate.with_waiting()).override(
        config=tiny.TINY_XFMR, traffic={"tasks": 4, "k_support": 2,
                                        "k_query": 2, "samples": 16000,
                                        "tokens": 8, "pool": 4})


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_four_ranks_on_the_cpu(fault):
    """Four gloo ranks on the CPU: sound, every rank holds the same
    parameters; with the exchange left out, not correct."""
    ctx = tiny.context("", c=_dp_cell(), seconds=1.0)
    if fault is None:
        res = run.run_cell(ctx)
        assert res["checks"]["rank_gap"]["value"] == 0.0
        assert res["device"]["count"] == 4 and res["attempted"] >= 1
        return
    with faults.plant(fault):
        res = run.run_cell(ctx)
    assert res["correct"] is False
    assert res["checks"]["rank_gap"]["value"] > 0.0
