"""Dynamic request batching for ``ServingDecoder`` (counterpart of
``metaasr_tpu/serve/batcher.py``, same semantics).

A thread-safe ``submit(waveform) -> Future`` front door groups pending
requests into one bucket dispatch under a latency budget:

- one dispatcher thread runs every decode, a second thread reads results
  back, so batch i+1 starts while batch i's results are converted;
- grouping waits at most ``max_wait_ms`` from the FIRST request of a group,
  and stops early at ``max_batch`` requests;
- at most ``max_inflight`` groups are dispatched and not yet read; while
  the dispatcher waits for a slot, the backlog joins the next group (up to
  ``max_batch``), so overload turns into full buckets;
- bucket choice is the decoder's own (``ServingDecoder._pick_bucket``). A
  group that fits no bucket is split and served singly, so only a request
  that fits no bucket on its own fails, and only its own future.

The input queue is unbounded, as in the reference (a bounded queue is a new
feature, listed in ROADMAP.md).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Sequence

import numpy as np


class DynamicBatcher:
    """Group concurrent single-utterance requests into bucket dispatches.

    Args:
      decoder: a loaded ``ServingDecoder``.
      max_wait_ms: grouping deadline measured from the first queued
        request of a batch. 0 dispatches every drain immediately.
      max_batch: group-size cap; defaults to the largest exported
        bucket's batch dimension (a bigger group could never fit).
      params: optional hot-swapped parameter pytree, passed through to
        every dispatch (the adapted-weights serving pattern).
      nbest: n-best depth of the returned results.

    ``submit`` returns a ``concurrent.futures.Future`` resolving to the
    same per-utterance dict ``ServingDecoder.transcribe`` returns. A
    request wider than every exported bucket fails ONLY its own future.
    """

    _STOP = object()

    def __init__(self, decoder, max_wait_ms: float = 5.0,
                 max_batch: int | None = None, params: Any = None,
                 nbest: int = 1, max_inflight: int = 2):
        self.decoder = decoder
        self.max_wait = max_wait_ms / 1e3
        self.max_batch = max_batch or max(b for b, _ in decoder.buckets)
        self.params = params
        self.nbest = nbest
        self._inflight = threading.BoundedSemaphore(max_inflight)
        self._stop_seen = False
        self._max_width = max(w for _, w in decoder.buckets)
        self._in: queue.Queue = queue.Queue()
        self._pending: queue.Queue = queue.Queue()
        self.stats = {"batches": 0, "requests": 0}
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="batcher-dispatch",
                                            daemon=True)
        self._reader = threading.Thread(target=self._read_loop,
                                        name="batcher-read", daemon=True)
        self._closed = False
        self._dispatcher.start()
        self._reader.start()

    # ---------- front door ----------

    def submit(self, x: np.ndarray) -> Future:
        if self._closed:
            raise RuntimeError("batcher is closed")
        fut: Future = Future()
        x = np.asarray(x, np.float32)
        if int(np.shape(x)[0]) > self._max_width:
            fut.set_exception(ValueError(
                f"request width {np.shape(x)[0]} exceeds every exported "
                f"bucket {self.decoder.buckets}"))
            return fut
        self._in.put((x, fut))
        return fut

    def submit_many(self, xs: Sequence[np.ndarray]) -> list[Future]:
        return [self.submit(x) for x in xs]

    def close(self):
        """Stop accepting work, flush everything queued, join threads."""
        if self._closed:
            return
        self._closed = True
        self._in.put(self._STOP)
        self._dispatcher.join()
        self._reader.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------- worker threads ----------

    def _collect(self, first):
        """Drain the queue into a group: first request + everything that
        arrives before the deadline, capped at max_batch. Returns (group,
        saw_stop)."""
        group = [first]
        deadline = time.monotonic() + self.max_wait
        while len(group) < self.max_batch:
            timeout = deadline - time.monotonic()
            try:
                item = self._in.get(block=timeout > 0,
                                    timeout=max(timeout, 0))
            except queue.Empty:
                return group, False
            if item is self._STOP:
                return group, True
            group.append(item)
        return group, False

    def _dispatch_loop(self):
        while not self._stop_seen:
            item = self._in.get()
            if item is self._STOP:
                break
            group, saw_stop = self._collect(item)
            self._stop_seen = self._stop_seen or saw_stop
            self._dispatch_group([x for x, _ in group],
                                 [f for _, f in group])
        self._pending.put(self._STOP)

    def _top_up(self, xs, futs):
        """Drain the backlog built while waiting for an inflight slot
        (non-blocking) into this group, up to max_batch — the
        backpressure-batching half of the design note above."""
        while len(xs) < self.max_batch:
            try:
                item = self._in.get_nowait()
            except queue.Empty:
                break
            if item is self._STOP:
                self._stop_seen = True
                break
            xs.append(item[0])
            futs.append(item[1])

    def _dispatch_group(self, xs, futs, top_up: bool = True):
        # stage (pad + copy to the device) BEFORE blocking on a slot; if the
        # backlog drained after the slot freed grows the group, it is
        # staged again
        try:
            staged = self.decoder._stage(list(xs), self.params)
        except Exception:
            staged = None  # the error re-raises in _dispatch below
        self._inflight.acquire()   # backpressure: wait for a device slot
        n_staged = len(xs)
        if top_up:
            self._top_up(xs, futs)
        try:
            # the reader thread copies results to the host and releases
            # the slot
            if staged is not None and len(xs) == n_staged:
                out, n = self.decoder._dispatch_staged(staged)
            else:
                out, n = self.decoder._dispatch(xs, self.params)
        except ValueError as e:
            self._inflight.release()
            # a group can be jointly unfittable while every member fits
            # alone (e.g. the wide bucket is batch-1 and three requests
            # arrived, one of them wide): split and serve singly so only
            # genuinely unservable requests fail
            if len(xs) > 1:
                for x, f in zip(xs, futs):
                    self._dispatch_group([x], [f], top_up=False)
                return
            futs[0].set_exception(e)
            return
        except Exception as e:
            self._inflight.release()
            for f in futs:
                f.set_exception(e)
            return
        self.stats["batches"] += 1
        self.stats["requests"] += len(futs)
        self._pending.put((out, n, futs))

    def _read_loop(self):
        while True:
            item = self._pending.get()
            if item is self._STOP:
                return
            out, n, futs = item
            try:
                results = self.decoder._read(out, n, self.nbest)
            except Exception as e:
                for f in futs:
                    f.set_exception(e)
                self._inflight.release()
                continue
            for f, r in zip(futs, results):
                f.set_result(r)
            self._inflight.release()
