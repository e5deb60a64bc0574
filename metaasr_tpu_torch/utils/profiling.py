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
"""

from __future__ import annotations

import contextlib
import os

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
