"""The yardstick's arithmetic against hand counts, and the load generator's
latency and failure counting."""

import math
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from benchmark.yardstick import bounds, flops, load, peaks
from benchmark.yardstick.trace import Trace

SXM = peaks.PEAKS["H100 SXM"]


def test_transformer_flops_by_hand():
    # frames 19 -> conv 9 x 39 -> conv 4 x 19; d 4, ff 8, 1 + 1 layers,
    # 3 decoder positions, vocab 5
    d, ff, t, u, v = 4, 8, 4, 3, 5
    conv = 2 * d * 9 * 39 * 9 + 2 * d * t * 19 * d * 9
    proj = 2 * t * 19 * d * d
    enc = 2 * t * d * 3 * d + 4 * t * t * d + 2 * t * d * d + 4 * t * d * ff
    dec = (2 * u * d * 3 * d + 4 * u * u * d + 2 * u * d * d + 2 * u * d * d
           + 4 * t * d * d + 4 * u * t * d + 2 * u * d * d + 4 * u * d * ff)
    heads = 2 * t * d * v + 2 * u * d * v
    assert flops.transformer_forward(19, u, d, ff, 1, 1, v) == \
        conv + proj + enc + dec + heads


def test_headline_step_flops():
    """4 tasks x (16 x 3 inner + 16 query) presentations of 4 s: 4.94
    TFLOP, within 0.2% of what torch's FlopCounterMode counted for the
    program's step."""
    fwd = flops.transformer_forward(398, 33, 256, 2048, 12, 6, 30)
    assert flops.train_step(fwd, 256) == pytest.approx(4.93e12, rel=2e-3)


def test_vgg_blstm_flops_by_hand():
    # frames 8, feat 8, channels (2,), hidden 3, 1 layer, vocab 4
    conv = 2 * 2 * 8 * 8 * 1 * 9 + 2 * 2 * 8 * 8 * 2 * 9
    t, d_in = 4, 4 * 2
    lstm = 2 * (2 * t * d_in * 12 + 2 * t * 3 * 12)
    head = 2 * t * 6 * 4
    assert flops.vgg_blstm_forward(8, 3, 1, (2,), 4, feat_dim=8) == \
        conv + lstm + head


def test_bounds_by_hand():
    # K2 at [2, 3, 5]: 30 elements
    assert bounds.k2_seconds(2, 3, 5, SXM) == max(
        16 * 30 / 67e12, 4 * (60 + 10 + 6) / 3.35e12)
    fwd, bwd = bounds.lstm_seconds(2, 1, 4, SXM)
    cell = 8
    assert fwd == max(2 * cell * 16 / 67e12, 4 * (cell * 10 + 64) / 3.35e12)
    assert bwd == max(4 * cell * 16 / 67e12,
                      4 * (cell * 11 + 128) / 3.35e12)
    # K1 on one full frame: 400 samples, 80 bins
    tables, nnz = bounds.k1_table_bytes()
    nbytes = 4 * 400 + 4 + tables + 4 * 80
    ops = max(bounds.K1_FP64_OPS / 67e12, (2 * nnz + 160) / 67e12)
    assert bounds.k1_seconds(1, 400, [1], SXM) == max(ops, nbytes / 3.35e12)


def test_k1_tables_match_the_kernels_layout():
    from metaasr_tpu_torch.frontend import fbank_kernel
    from metaasr_tpu_torch.frontend.fbank import FbankParams

    p = FbankParams.create()
    bins, _ = fbank_kernel.mel_ranges(p.mel_t)
    assert bounds.k1_table_bytes() == (fbank_kernel.pack_tables(p).size,
                                       int((bins[:, 1] - bins[:, 0]).sum()))


def test_peaks_by_name():
    assert peaks.part("NVIDIA H100 80GB HBM3") == "H100 SXM"
    assert peaks.part("NVIDIA H100 PCIe") == "H100 PCIe"
    assert peaks.peaks("NVIDIA A100-SXM4-80GB") is None


def test_schedule_same_work_every_seed():
    a_due, a_len = load.schedule(6.0, 30, 32000, 64000, 1)
    b_due, b_len = load.schedule(6.0, 30, 32000, 64000, 2**31 + 7)
    assert len(a_due) == len(b_due) == 180
    assert sorted(a_len) == sorted(b_len)
    assert not np.array_equal(a_len, b_len)
    assert sorted(np.diff(a_due)) == pytest.approx(sorted(np.diff(b_due)),
                                                   rel=0.2, abs=0.2)
    assert 0 <= a_due[0] and a_due[-1] < 30
    assert a_len.min() >= 32000 and a_len.max() <= 64000


def test_latency_from_due_time_and_failures():
    """A request answered late is timed from when it was due; one that
    fails or never comes counts as above every latency."""
    futs = []

    def submit(x):
        f = Future()
        futs.append((x, f))
        return f

    due = np.array([0.0, 0.05, 0.10, 0.15])
    w = load.Window(submit, ["ok", "late", "fail", "never"], due)
    t0 = time.perf_counter() + 0.3       # the submitter starts late
    t = threading.Thread(target=w.run, args=(t0 - 0.3,))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    time.sleep(0.05)
    futs[0][1].set_result({"text": ""})
    time.sleep(0.2)
    futs[1][1].set_result({"text": ""})
    futs[2][1].set_exception(RuntimeError("boom"))
    w.wait(time.perf_counter() + 0.1)
    lat = w.latencies(t0 - 0.3)
    assert lat[0] >= 0.05 and lat[1] >= 0.2
    assert math.isinf(lat[2]) and math.isinf(lat[3])
    assert w.errors[2] and w.results[3] is None
    assert load.p95(lat) == math.inf
    assert load.p95(np.array([1.0] * 19 + [2.0])) == pytest.approx(1.05)


def test_trace_sums():
    tr = Trace(1.0, [(0, 100, "a"), (50, 150, "b"), (300, 400, "a"),
                     (500, 510, "Memcpy HtoD")])
    assert tr.kernels == 3
    assert tr.busy_s() == pytest.approx(260e-9)
    assert tr.by_name()["a"] == (2, pytest.approx(200e-9))
    assert tr.idle_gaps(1) == [["before a", pytest.approx(150e-9)]]
