"""Scalar and text logging (counterpart of ``metaasr_tpu/train/logging.py``):
one JSON record per call in ``<log_dir>/scalars.jsonl``, scalars optionally
echoed."""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, log_dir: str, print_every: int = 0):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a",
                       buffering=1)
        self.print_every = print_every

    def log(self, step: int, scalars: dict) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self.print_every and step % self.print_every == 0:
            msg = " ".join(f"{k}={float(v):.4g}" for k, v in scalars.items())
            print(f"[step {step}] {msg}", flush=True)

    def log_text(self, step: int, tag: str, text: str) -> None:
        self._f.write(json.dumps({"step": int(step), "tag": tag,
                                  "text": text}) + "\n")

    def close(self) -> None:
        self._f.close()
