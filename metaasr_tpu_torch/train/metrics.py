"""CER/WER metrics (counterpart of ``metaasr_tpu/train/metrics.py``).

Levenshtein distance through the first-party native helper
(``native/editdistance.cpp``, loaded by ``utils/native.py``) with a
pure-Python fallback when the library cannot be built. Host-side only.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from metaasr_tpu_torch.utils.native import get_native_lib


def _edit_distance_py(a: list[int], b: list[int]) -> int:
    if not a:
        return len(b)
    if not b:
        return len(a)
    if len(b) > len(a):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(cur[j - 1] + 1, prev[j] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def edit_distance(a, b) -> int:
    """Levenshtein distance between two token-id (or str-token) sequences."""
    if len(a) == 0 or len(b) == 0:
        return max(len(a), len(b))
    if not (isinstance(a[0], (int, np.integer))
            and isinstance(b[0], (int, np.integer))):
        vocab: dict = {}   # arbitrary hashables -> ints for the native path
        a = [vocab.setdefault(t, len(vocab)) for t in a]
        b = [vocab.setdefault(t, len(vocab)) for t in b]
    lib = get_native_lib()
    if lib is None:
        return _edit_distance_py(list(map(int, a)), list(map(int, b)))
    aa = np.ascontiguousarray(a, dtype=np.int32)
    bb = np.ascontiguousarray(b, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    return int(lib.metaasr_edit_distance(aa.ctypes.data_as(i32p), len(aa),
                                         bb.ctypes.data_as(i32p), len(bb)))


@dataclass
class ErrorRate:
    """Accumulator: sum of edit distances / sum of reference lengths."""

    errors: int = 0
    total: int = 0

    def update(self, hyp, ref) -> None:
        self.errors += edit_distance(hyp, ref)
        self.total += len(ref)

    @property
    def rate(self) -> float:
        return self.errors / max(self.total, 1)


def compute_wer(hyps: list[str], refs: list[str]) -> float:
    """Word error rate over parallel lists of strings."""
    acc = ErrorRate()
    for h, r in zip(hyps, refs):
        acc.update(h.split(), r.split())
    return acc.rate


def compute_cer(hyps: list[str], refs: list[str]) -> float:
    """Character error rate over parallel lists of strings."""
    acc = ErrorRate()
    for h, r in zip(hyps, refs):
        acc.update(list(h), list(r))
    return acc.rate
