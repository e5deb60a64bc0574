"""Open-loop request load, and the latency it met.

A traffic mix fixes how many requests a window sends (``rate`` x seconds),
their lengths (evenly spaced quantiles of a uniform range) and the gaps
between arrivals (quantiles of an exponential of mean 1 / ``rate``: a
Poisson stream). The seed only orders them, so every seed offers the same
work. A request's latency runs from when it was due, not from when it was
handed over, to its answer; one that fails or never comes counts as above
every latency.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np


def schedule(rate: float, seconds: float, min_samples: int,
             max_samples: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (due offsets in seconds from the window's start, lengths)."""
    n = max(1, round(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    lengths = np.round(min_samples + (max_samples - min_samples) * q).astype(
        np.int64)
    gaps = -np.log1p(-q) / rate
    rng = np.random.default_rng(int(seed))
    gaps = gaps[rng.permutation(n)]
    due = np.cumsum(gaps) - gaps[0] * 0.5
    due *= seconds / max(float(due[-1]) + gaps.mean() * 0.5, 1e-9)
    return due, lengths[rng.permutation(n)]


class Window:
    """Submits each request at its due time; records when each answer
    came."""

    def __init__(self, submit, payloads, due):
        self.submit, self.payloads, self.due = submit, payloads, due
        self.done = [math.inf] * len(due)
        self.results = [None] * len(due)
        self.errors = [None] * len(due)
        self._left = len(due)
        self._cv = threading.Condition()

    def _finish(self, i, fut):
        t = time.perf_counter()
        err = fut.exception()
        with self._cv:
            if err is None:
                self.results[i] = fut.result()
                self.done[i] = t
            else:
                self.errors[i] = repr(err)
            self._left -= 1
            self._cv.notify_all()

    def run(self, t0: float) -> None:
        """Send every request at ``t0 + due``."""
        for i, (x, d) in enumerate(zip(self.payloads, self.due)):
            wait = t0 + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            fut = self.submit(x)
            fut.add_done_callback(lambda f, i=i: self._finish(i, f))

    def wait(self, deadline: float) -> None:
        with self._cv:
            while self._left and time.perf_counter() < deadline:
                self._cv.wait(timeout=max(0.0, deadline
                                          - time.perf_counter()))

    def latencies(self, t0: float) -> np.ndarray:
        """Seconds from due to answer; inf where none came."""
        return np.asarray([d - (t0 + due) for d, due in
                           zip(self.done, self.due)])


def p95(latencies: np.ndarray) -> float:
    """The 95th percentile over all requests (linear between order
    statistics); inf when a failed request lies in the tail."""
    lat = np.sort(latencies)
    pos = 0.95 * (len(lat) - 1)
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if not math.isfinite(lat[hi]):
        return math.inf
    return float(lat[lo] + (lat[hi] - lat[lo]) * (pos - lo))
