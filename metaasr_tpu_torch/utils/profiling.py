"""Tracing and NaN debugging (counterpart of
``metaasr_tpu/utils/profiling.py``).

- ``trace(log_dir)``: a ``torch.profiler`` context over the host and, where
  CUDA is available, the device; on exit it writes a Chrome trace
  (``trace.json``, readable by chrome://tracing or Perfetto) into
  ``log_dir``.
- ``nan_check(enable)``: ``torch.autograd.set_detect_anomaly``. It stops
  at the backward op that produces a NaN and prints the traceback of the
  forward op that recorded it. It does not check the forward pass, which
  the reference's ``jax_debug_nans`` also does; PyTorch has no switch
  nearer to it.
- ``Timer``: wall-clock seconds of each ``with`` block, their median and
  items per second at the median; ``block(x)`` waits for the device work
  that makes ``x``, so the block's time covers it.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def nan_check(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


class Timer:
    """Median step timer: time each step as ``with timer:`` and end the
    step's body with ``timer.block(out)``."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def block(self, x):
        """Synchronize the CUDA device of each tensor in ``x`` (a tensor,
        or a dict, list or tuple of them); nothing on the CPU."""
        leaves = (x.values() if isinstance(x, dict)
                  else x if isinstance(x, (list, tuple)) else (x,))
        for t in leaves:
            if isinstance(t, (dict, list, tuple)):
                self.block(t)
            elif isinstance(t, torch.Tensor) and t.is_cuda:
                torch.cuda.synchronize(t.device)
        return x

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else float("nan")

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.median if self.times else float("nan")
