"""What the per-layer metric files of ``benchmark/metrics`` compute, from a
job's result: its facts (the cell's shapes, the steps and seconds of the
window, the FLOPs of a step) and the device trace of its traced span.
Each returns None where it finds nothing to read."""

from __future__ import annotations

import re

from benchmark.yardstick import bounds, peaks

# kernel names as the profiler reports them (demangled)
K1 = re.compile(r"\bfbank_fft_kernel\b")
K2 = re.compile(r"\bctc_kernel<\s*false\b")
K3 = re.compile(r"\blstm_fwd_kernel\b")
K3B = re.compile(r"\blstm_(bwd|du)_kernel\b")
K3B_LAUNCH = re.compile(r"\blstm_bwd_kernel\b")


def kernels_per(out: dict, unit: str) -> float | None:
    """Kernels launched in the traced span over its steps or groups."""
    trace, n = out.get("trace"), out.get(unit)
    if trace is None or not n:
        return None
    return trace.kernels / n


def mfu(out: dict) -> float | None:
    """Model FLOPs of the window's steps over its seconds, as % of the
    cards' peak at the step's compute type."""
    p = peaks.peaks(out["device_kind"])
    if p is None or not out.get("steps"):
        return None
    rate = out["flops_per_step"] * out["steps"] / out["window_s"]
    return 100.0 * rate / (p[out["peak_key"]] * out["chips"])


def idle_share(out: dict) -> float | None:
    trace = out.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def peak_gb(out: dict) -> float | None:
    return out["memory_peak_bytes"] / 1e9 if out["memory_peak_bytes"] \
        else None


def roofline(out: dict, pattern, least_s, launch=None) -> float | None:
    """The kernels matching ``pattern`` in the traced span: launches x their
    least time (``least_s(peaks)``) over their device time, in %. A launch
    is a kernel matching ``launch`` where one launch runs several kernels."""
    trace, p = out.get("trace"), peaks.peaks(out["device_kind"])
    if trace is None or p is None:
        return None
    launches, seconds = trace.matching(lambda n: bool(pattern.search(n)))
    if launch is not None:
        launches = trace.matching(lambda n: bool(launch.search(n)))[0]
    if not launches or seconds <= 0:
        return None
    return 100.0 * launches * least_s(p) / seconds


def k1_least(out: dict):
    k1 = out["k1"]
    return lambda p: bounds.k1_seconds(*k1["shape"], k1["frames"], p)


def k2_least(out: dict):
    return lambda p: bounds.k2_seconds(*out["k2"]["shape"], p)


def k3_least(out: dict, index: int):
    return lambda p: bounds.lstm_seconds(*out["k3"]["shape"], p)[index]
