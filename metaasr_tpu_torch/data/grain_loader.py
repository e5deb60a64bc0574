"""The worker-parallel, checkpointable loader behind ``data.loader: grain``
(counterpart of ``metaasr_tpu/data/grain_loader.py``, written on
``torch.utils.data``: grain itself imports JAX).

The stream is the reference's ``MapDataset.source -> shuffle(seed) ->
repeat() -> batch(B)`` over the (dataset, utterance) pairs in list order.
Stream item ``i`` is source item ``epoch_permutation(seed, i // N, N)[i %
N]``: every epoch is reshuffled, and a batch runs across an epoch boundary.
Batch ``b`` collates items ``[b·B, (b+1)·B)`` at fixed cap shapes
(``num_samples``, ``num_tokens``). ``num_epochs=None`` is endless; a finite
count keeps the last partial batch.

The iterator's state is the number of batches it has handed out,
``{"next_index": n}``; ``set_state`` restarts the stream there, so a run
resumed from a checkpoint and its state replays the stream exactly. With
``num_workers > 0`` a ``DataLoader`` of worker processes builds the numpy
batches in order; the workers never touch CUDA, and the caller copies each
batch to its device.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch.utils.data

from metaasr_tpu_torch.data.sampler import collate


def epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """The order of source items in ``epoch``: a pure function of (seed,
    epoch), drawn as ``BucketBatcher`` draws its epochs. (The reference's
    order comes from grain's compiled ``index_shuffle``, which numpy cannot
    reproduce.)"""
    return np.random.default_rng((int(seed), int(epoch))).permutation(n)


class _UttSource:
    """Random access over the (dataset index, utterance index) pairs."""

    def __init__(self, datasets):
        self.datasets = datasets
        self.index = [(di, ui) for di, ds in enumerate(datasets)
                      for ui in range(len(ds))]

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i):
        di, ui = self.index[i]
        return self.datasets[di][ui]


class _Batches(torch.utils.data.Dataset):
    """Map-style dataset of batch indices: ``[b]`` is batch ``b`` of the
    stream, collated to numpy arrays. Each process (worker) caches the
    permutation of the epoch it last read."""

    def __init__(self, source: _UttSource, batch_size: int, num_samples: int,
                 num_tokens: int, seed: int, num_items: int | None):
        self.source = source
        self.batch_size = batch_size
        self.num_samples = num_samples
        self.num_tokens = num_tokens
        self.seed = seed
        self.num_items = num_items        # None: endless
        self._epoch, self._perm = None, None

    @property
    def num_batches(self) -> int | None:
        if self.num_items is None:
            return None
        return -(-self.num_items // self.batch_size)

    def _item(self, i: int):
        epoch, j = divmod(i, len(self.source))
        if epoch != self._epoch:
            self._epoch = epoch
            self._perm = epoch_permutation(self.seed, epoch, len(self.source))
        return self.source[int(self._perm[j])]

    def __getitem__(self, b: int) -> dict:
        stop = (b + 1) * self.batch_size
        if self.num_items is not None:
            stop = min(stop, self.num_items)
        items = [self._item(i) for i in range(b * self.batch_size, stop)]
        return collate(items, self.num_samples, self.num_tokens)


def _keep(batch):
    """The DataLoader's collate_fn: the worker's numpy batch as it is."""
    return batch


class GrainLoader:
    """Iterator of collated batches with ``get_state`` / ``set_state``."""

    def __init__(self, batches: _Batches, num_workers: int = 0):
        self.batches = batches
        self.num_workers = int(num_workers)
        self._next = 0
        self._it = None

    def __iter__(self):
        return self

    def _indices(self):
        stop = self.batches.num_batches
        return (itertools.count(self._next) if stop is None
                else range(self._next, stop))

    def _open(self):
        if self.num_workers == 0:
            return (self.batches[b] for b in self._indices())
        return iter(torch.utils.data.DataLoader(
            self.batches, batch_size=None, sampler=self._indices(),
            num_workers=self.num_workers, collate_fn=_keep))

    def __next__(self) -> dict:
        if self._it is None:
            self._it = self._open()
        batch = next(self._it)
        # count what was handed out, not what the workers prefetched
        self._next += 1
        return batch

    def get_state(self) -> dict:
        return {"next_index": self._next}

    def set_state(self, state: dict) -> None:
        self.close()
        self._next = int(state["next_index"])

    def close(self) -> None:
        """Stop the workers; the position is kept, and the next ``next``
        starts new ones there."""
        self._it = None


def make_grain_loader(datasets, batch_size: int, num_samples: int,
                      num_tokens: int, seed: int = 0, num_workers: int = 0,
                      num_epochs: int | None = None) -> GrainLoader:
    """A checkpointable iterator of batches collated to [B, num_samples] /
    [B, num_tokens]. ``num_epochs``: None repeats without end; otherwise
    ``max(num_epochs, 1)`` epochs, the last batch possibly partial."""
    if not isinstance(datasets, (list, tuple)):
        datasets = [datasets]
    source = _UttSource(list(datasets))
    if not len(source):
        raise ValueError("make_grain_loader: the datasets hold no utterance")
    num_items = (None if num_epochs is None
                 else len(source) * max(int(num_epochs), 1))
    return GrainLoader(_Batches(source, batch_size, num_samples, num_tokens,
                                seed, num_items), num_workers)


def save_iterator_state(it) -> dict | None:
    get = getattr(it, "get_state", None)
    return get() if get else None


def restore_iterator_state(it, state) -> None:
    if state is not None and hasattr(it, "set_state"):
        it.set_state(state)
