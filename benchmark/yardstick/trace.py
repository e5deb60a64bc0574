"""Device spans from ``torch.profiler``, read in memory.

Only device activity is traced. The spans come from the profiler's raw
Kineto records (building ``prof.events()`` in Python takes tens of seconds
for a meta-step's ~55,000 kernels and yields the same spans); where that
private attribute is missing, from ``prof.events()``. No trace file is
written.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

NON_KERNEL = ("Memcpy", "Memset", "memcpy", "memset")


@dataclass
class Trace:
    window_s: float
    spans: list = field(default_factory=list)   # (start_ns, end_ns, name)

    @property
    def kernels(self) -> int:
        return sum(1 for *_, n in self.spans if not n.startswith(NON_KERNEL))

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union)."""
        total, end = 0, None
        for s, t, _ in sorted(self.spans):
            if end is None or s > end:
                total += t - s
                end = t
            elif t > end:
                total += t - end
                end = t
        return total / 1e9

    def by_name(self) -> dict:
        """{name: (launches, device seconds)}."""
        out: dict = {}
        for s, t, n in self.spans:
            c, sec = out.get(n, (0, 0.0))
            out[n] = (c + 1, sec + (t - s) / 1e9)
        return out

    def matching(self, test) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name passes
        ``test``."""
        hits = [v for n, v in self.by_name().items() if test(n)]
        return sum(c for c, _ in hits), sum(s for _, s in hits)

    def top_ops(self, k: int = 10) -> list:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][1])[:k]
        return [[n[:120], sec] for n, (_, sec) in ops]

    def idle_gaps(self, k: int = 10) -> list:
        """The longest gaps with nothing on the device, each named by the
        operation the host launched next."""
        gaps, end = [], None
        for s, t, n in sorted(self.spans):
            if end is not None and s > end:
                gaps.append(((s - end) / 1e9, n))
            end = t if end is None else max(end, t)
        gaps.sort(key=lambda g: -g[0])
        return [[f"before {n[:100]}", sec] for sec, n in gaps[:k]]


def traced(torch, fn) -> tuple[Trace, object]:
    """Run ``fn()`` under the profiler, device activity only, ending in a
    synchronise -> (its Trace, fn's result)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    trace = Trace(window)
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kineto is not None:
        from torch.autograd import DeviceType

        for e in kineto.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                trace.spans.append((s, s + e.duration_ns(), e.name()))
    else:
        for e in prof.events():
            if e.device_type.name == "CUDA":
                s = int(e.time_range.start * 1e3)
                trace.spans.append((s, int(e.time_range.end * 1e3), e.name))
    return trace, out
