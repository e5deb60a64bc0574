"""Seeds of a training step, as the trained system derives them.

A step's randomness is a pure function of one integer: ``fold_in(seed,
*data)`` hashes the seed and a path of integers through NumPy's
``SeedSequence`` to a new 63-bit seed, and each consumer (a task's
SpecAugment, an inner step's dropout, ...) gets its own ``torch.Generator``
on the batch's device seeded with it.
"""

from __future__ import annotations

import numpy as np
import torch


def fold_in(seed: int, *data: int) -> int:
    state = np.random.SeedSequence(
        [int(seed) & (2**63 - 1), *(int(d) for d in data)]).generate_state(
            1, np.uint64)[0]
    return int(state >> np.uint64(1))


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))
