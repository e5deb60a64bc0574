"""The port's profiling tools against the reference's
(``metaasr_tpu_torch/scripts/{trace_summary,matmul_roofline}.py`` against
``scripts/{trace_summary,matmul_roofline}.py``).

- ``trace_summary.summarize`` on a hand-written Chrome trace (CPU ops,
  runtime calls and flow events beside kernels, a memcpy and a memset, two
  template instances of one kernel, K1's name as the card's trace gives
  it, in an anonymous namespace with its argument type):
  exact ms/step, %, count and order, and ``main``'s table in the
  reference's layout; a real ``torch.profiler`` trace of CPU work ends in
  the no-device-events ``SystemExit``, a missing trace in the message that
  names the bench command.
- ``matmul_roofline``: the rows, read from the reference by ``ast``, are
  the reference's, and the FLOP count of each is the reference's formula;
  without CUDA, ``main`` prints one JSON error line and exits 1.
"""

import ast
import json

import numpy as np
import pytest
import torch

from metaasr_tpu_torch.scripts import bench, matmul_roofline, trace_summary
from tests.test_torch_decode_bench import reference_ast
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# name, cat, dur (µs); "ph": "X" unless given
EVENTS = [
    ("aten::mm", "cpu_op", 900.0),
    ("cudaLaunchKernel", "cuda_runtime", 5.0),
    ("void ctc_kernel<false, 2, false>(Params)", "kernel", 30.0),
    ("void ctc_kernel<true, 2, false>(Params)", "kernel", 20.0),
    ("void ctc_kernel<false, 2, false>(Params)", "kernel", 30.0),
    ("(anonymous namespace)::fbank_fft_kernel((anonymous namespace)::Args)",
     "kernel", 12.0),
    ("void at::native::(anonymous namespace)::layer_norm_kernel<float>"
     "(int, float const*, float*)", "kernel", 8.0),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 40.0),
    ("Memset (Device)", "gpu_memset", 2.0),
    ("(anonymous namespace)::fbank_fft_kernel((anonymous namespace)::Args)",
     "kernel", 12.0),
    ("ProfilerStep#1", "user_annotation", 5000.0),
]


def write_trace(path, events=EVENTS):
    trace = [{"ph": "X", "name": n, "cat": c, "ts": 10.0 * i, "dur": d,
              "pid": 0, "tid": 0} for i, (n, c, d) in enumerate(events)]
    trace.append({"ph": "s", "name": "ac2g", "cat": "ac2g", "id": 1,
                  "ts": 0.0, "pid": 0, "tid": 0})
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": trace}, f)


def test_summarize_hand_written_trace(tmp_path, capsys):
    """154 µs of device ops over 2 steps: the rows by time, K2 and K2b
    apart, the memcpy and memset as rows, CPU events left out; ``top``
    cuts the rows, not the total; ``main`` prints the reference's table."""
    path = str(tmp_path / "t.json")
    write_trace(path)
    s = trace_summary.summarize(path, steps=2, top=None)
    assert (s["steps"], s["ops"], s["device_ms"]) == (2, 6, 0.154)
    assert s["device_ms_per_step"] == 0.154 / 2
    want = [("ctc_kernel<false, 2, false>", 60.0, 1),
            ("Memcpy HtoD", 40.0, 0),
            ("(anonymous namespace)::fbank_fft_kernel", 24.0, 1),
            ("ctc_kernel<true, 2, false>", 20.0, 0),
            ("at::native::(anonymous namespace)::layer_norm_kernel<float>",
             8.0, 0),
            ("Memset", 2.0, 0)]
    assert [(r["op"], r["count"]) for r in s["rows"]] == [
        (op, c) for op, _, c in want]
    assert [r["launches"] for r in s["rows"]] == [2, 1, 2, 1, 1, 1]
    for r, (_, us, _) in zip(s["rows"], want):
        assert r["ms_per_step"] == us / 2 / 1e3
        assert r["pct"] == 100 * us / 154.0
    top = trace_summary.summarize(path, steps=2, top=2)
    assert top["rows"] == s["rows"][:2] and top["device_ms"] == 0.154

    capsys.readouterr()
    trace_summary.main([path, "--steps", "2", "--top", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines == [
        f"trace: {path}",
        "device-op time: 0.08 ms/step (2 steps)",
        f"{'ms/step':>9}  {'%':>5}  {'count':>6}  op",
        "    0.030   39.0       1  ctc_kernel<false, 2, false>",
        "    0.020   26.0       0  Memcpy HtoD",
        "    0.012   15.6       1  (anonymous namespace)::fbank_fft_kernel"]


def test_table_layout_is_the_reference():
    """The reference's three print statements of the table, unparsed, are
    the port's with ``summarize``'s names in place of its locals."""
    ref = [ast.unparse(n) for n in ast.walk(reference_ast(
        "trace_summary.py")) if isinstance(n, ast.Call)
        and ast.unparse(n.func) == "print"]
    assert ref[-3:] == [
        "print(f'device-op time: {total / args.steps / 1000.0:.2f} ms/step "
        "({args.steps} steps)')",
        "print(f\"{'ms/step':>9}  {'%':>5}  {'count':>6}  op\")",
        "print(f'{t / args.steps / 1000.0:9.3f}  {100 * t / total:5.1f}  "
        "{cnt[name] // args.steps:6d}  {name}')"]
    assert ref[0] == "print(f'trace: {path}')"


def test_cpu_profile_and_missing_trace_exit(tmp_path, monkeypatch):
    """A real ``torch.profiler`` trace of CPU work has no device events;
    with no trace at the bench's path, the message names the bench
    command that writes one."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x = torch.randn(64, 64)
        (x @ x).relu().sum()
    path = str(tmp_path / "cpu.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    with pytest.raises(SystemExit, match="no device events"):
        trace_summary.summarize(path)

    monkeypatch.setattr(bench, "PROFILE_DIR", str(tmp_path / "profiles"))
    assert trace_summary.find_trace() == str(
        tmp_path / "profiles" / "bench_trace.json")
    with pytest.raises(SystemExit, match="BENCH_PROFILE=1 python -m "
                       "metaasr_tpu_torch.scripts.bench"):
        trace_summary.main([])


def _reference_rows():
    main = next(n for n in reference_ast("matmul_roofline.py").body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    rows = next(s for s in main.body if isinstance(s, ast.Assign)
                and ast.unparse(s.targets[0]) == "rows")
    return ast.literal_eval(rows.value)


def _reference_flops(a_shape, b_shape, iters):
    """The reference's count (``bench_matmul``'s last lines), verbatim."""
    m = int(np.prod(a_shape[:-1]))
    k = a_shape[-1]
    n = b_shape[-1]
    batch = 1
    if len(b_shape) == 3:
        batch = b_shape[0]
        m = int(np.prod(a_shape[1:-1]))
    return 2 * 2 * batch * m * k * n * iters


def test_roofline_rows_and_flops_are_the_reference():
    """Seven rows, names and shapes the reference's; the chain length its
    default ``iters``; each row's FLOPs the reference's formula, which
    ``bench_matmul``'s source is checked to hold."""
    assert matmul_roofline.ROWS == _reference_rows()
    assert len(matmul_roofline.ROWS) == 7
    fn = next(n for n in reference_ast("matmul_roofline.py").body
              if isinstance(n, ast.FunctionDef) and n.name == "bench_matmul")
    assert ast.literal_eval(fn.args.defaults[0]) == matmul_roofline.ITERS
    src = ast.unparse(fn)
    assert "flops = 2 * 2 * batch * m * k * n * iters" in src
    assert "m = int(np.prod(a_shape[1:-1]))" in src
    for _, a, b in matmul_roofline.ROWS:
        for iters in (1, matmul_roofline.ITERS):
            assert matmul_roofline.chain_flops(a, b, iters) == \
                _reference_flops(a, b, iters)
    assert matmul_roofline.chain_flops((64, 99, 64), (64, 64, 99)) == (
        4 * 64 * 99 * 64 * 99 * 50)


def test_roofline_without_cuda(capsys):
    """One JSON error line, exit 1, nothing of the card touched."""
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit) as e:
        matmul_roofline.main([])
    assert e.value.code == 1
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["bench"] == "matmul_roofline" and "no CUDA" in rec["error"]
