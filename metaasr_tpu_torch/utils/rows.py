"""A rank's rows of a batch that several ranks share (the task mesh's data
axis).

Under a data axis each of a task group's D ranks runs k / D of a task's k
shots, yet its random draws must be the ones one process makes for the
whole batch at those rows, as GSPMD draws the global array in the
reference. ``Rows`` names a rank's rows of the whole batch; a
``RowGenerator`` is a ``torch.Generator`` that carries them; ``draw`` makes
a draw at the whole batch's leading size and keeps the rank's rows. Every
consumer of a batch's generator (dither, SpecAugment, dropout) draws
through ``draw``, so one generator handed down with ``train=True`` serves
all three; without rows it is a plain draw at the tensor's own size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Rows:
    """Rows ``[lo, hi)`` of each span, in order, of a batch of ``total``
    rows: a rank's shots of a task's support set, or of its support and
    query sets one after the other (``+``)."""

    spans: tuple[tuple[int, int], ...]
    total: int

    @classmethod
    def part(cls, index: int, size: int, total: int) -> "Rows":
        """The ``index``-th of ``size`` equal slices of ``total`` rows."""
        if total % size:
            raise ValueError(f"{total} rows do not split over {size} ranks")
        per = total // size
        return cls(((index * per, (index + 1) * per),), total)

    @property
    def count(self) -> int:
        return sum(hi - lo for lo, hi in self.spans)

    def __add__(self, other: "Rows") -> "Rows":
        """These rows, then ``other``'s after this batch's ``total``: the
        rows of the two batches concatenated."""
        return Rows(self.spans + tuple((lo + self.total, hi + self.total)
                                       for lo, hi in other.spans),
                    self.total + other.total)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """These rows of ``x`` (leading size ``total``)."""
        parts = [x[lo:hi] for lo, hi in self.spans]
        return parts[0] if len(parts) == 1 else torch.cat(parts)


class RowGenerator(torch.Generator):
    """A ``torch.Generator`` whose draws serve ``rows`` of a whole batch."""

    rows: Rows


def make_generator(seed: int, device, rows: Rows | None = None
                   ) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``; with ``rows``, one
    whose draws through ``draw`` are the whole batch's at those rows."""
    if rows is None:
        return torch.Generator(device=device).manual_seed(int(seed))
    g = RowGenerator(device=device)
    g.rows = rows
    return g.manual_seed(int(seed))


def draw(fn: Callable, shape, generator) -> torch.Tensor:
    """``fn(shape)`` (a draw from ``generator``), where ``shape[0]`` is the
    batch axis: with a ``RowGenerator`` drawn at the whole batch's rows and
    cut to the generator's, so the values and the generator's next state
    are those of one process drawing for the whole batch."""
    rows = getattr(generator, "rows", None)
    if rows is None:
        return fn(tuple(shape))
    if shape[0] != rows.count:
        raise ValueError(f"a draw for {shape[0]} rows from a generator of "
                         f"{rows.count} rows")
    return rows.take(fn((rows.total, *shape[1:])))
