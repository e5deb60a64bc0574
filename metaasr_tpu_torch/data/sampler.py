"""Collation, the length-bucketed batcher and the meta-task sampler
(counterpart of ``metaasr_tpu/data/sampler.py``: ``collate``,
``item_samples``, ``BucketBatcher``, ``TaskSampler``,
``support_query_split``, ``build_resident_store``,
``resident_store_bytes``).

``BucketBatcher`` groups utterances whose (audio bucket, token bucket)
match, so every batch has one of a small set of shapes; its order is a pure
function of (seed, epoch, batch index), so a resumed run replays the same
stream (``iter_from``). The mono and multitask trainers use it; multitask
pools the accents' utterances, which samples accents in proportion to
their size.

Each ``TaskSampler.sample(step)`` draws ``tasks_per_batch`` accents and,
per accent, disjoint support/query utterances, collated to numpy arrays
with a leading task axis ``[M, k, ...]`` at one (samples, tokens) shape per
step. The draw is a pure function of (seed, step), with the reference's
numpy calls in the reference's order, so both packages train on the same
batches.

Batch fields (audio mode): audio [B, S] float32, audio_lens [B] int32,
tokens [B, U] int32, token_lens [B] int32 (+ texts).
"""

from __future__ import annotations

import numpy as np

from metaasr_tpu_torch.frontend.fbank import num_frames
from metaasr_tpu_torch.utils.padding import bucket_length
from metaasr_tpu_torch.utils.rows import Rows


# Waveform-length buckets (samples at 16 kHz): 1, 2, 4, 8, 16 s.
DEFAULT_SAMPLE_BUCKETS = (16000, 32000, 64000, 128000, 256000)
DEFAULT_TOKEN_BUCKETS = (16, 32, 64, 128)


def collate(items: list[dict], num_samples: int, num_tokens: int) -> dict:
    """Pad dataset items to [B, num_samples] / [B, num_tokens].

    Precomputed-feature items ('feats' [T, 80]) pad to the frame count the
    same ``num_samples`` waveform cap would give."""
    bsz = len(items)
    feats_mode = "feats" in items[0]
    if any(("feats" in it) != feats_mode for it in items):
        raise ValueError(
            "collate: cannot mix precomputed-feature and raw-audio items "
            "in one batch (check that every manifest in the run uses the "
            "same payload mode)")
    tokens = np.zeros((bsz, num_tokens), dtype=np.int32)
    token_lens = np.zeros((bsz,), dtype=np.int32)
    texts = []
    if feats_mode:
        t_max = max(1, num_frames(num_samples))
        feat_dim = items[0]["feats"].shape[1]
        feats = np.zeros((bsz, t_max, feat_dim), dtype=np.float32)
        feat_lens = np.zeros((bsz,), dtype=np.int32)
        for i, it in enumerate(items):
            f = it["feats"][:t_max]
            feats[i, : len(f)] = f
            feat_lens[i] = len(f)
    else:
        audio = np.zeros((bsz, num_samples), dtype=np.float32)
        audio_lens = np.zeros((bsz,), dtype=np.int32)
        for i, it in enumerate(items):
            a = it["audio"][:num_samples]
            audio[i, : len(a)] = a
            audio_lens[i] = len(a)
    for i, it in enumerate(items):
        t = it["tokens"][:num_tokens]
        tokens[i, : len(t)] = t
        token_lens[i] = len(t)
        texts.append(it["text"])
    out = ({"feats": feats, "feat_lens": feat_lens} if feats_mode
           else {"audio": audio, "audio_lens": audio_lens})
    out.update({"tokens": tokens, "token_lens": token_lens, "texts": texts})
    if items and "cmvn_mean" in items[0]:  # speaker-level CMVN vectors
        out["cmvn_mean"] = np.stack([it["cmvn_mean"] for it in items])
        out["cmvn_std"] = np.stack([it["cmvn_std"] for it in items])
    return out


def item_samples(item: dict) -> int:
    """Waveform-sample length of a dataset item, either payload mode: a
    feature item maps its frames back to the sample count that gives exactly
    that frame count (the inverse of ``frontend.fbank.num_frames``)."""
    if "audio" in item:
        return len(item["audio"])
    return len(item["feats"]) * 160 + 240


class BucketBatcher:
    """Length-bucketed batch iterator over one or more accent datasets."""

    def __init__(self, datasets, batch_size: int,
                 sample_buckets=DEFAULT_SAMPLE_BUCKETS,
                 token_buckets=DEFAULT_TOKEN_BUCKETS,
                 seed: int = 0, drop_last: bool = True, tokenizer=None):
        if not isinstance(datasets, (list, tuple)):
            datasets = [datasets]
        self.datasets = list(datasets)
        self.batch_size = batch_size
        self.sample_buckets = tuple(sample_buckets)
        self.token_buckets = tuple(token_buckets)
        self.seed = int(seed)
        self.drop_last = drop_last
        # (dataset index, utterance index, bucket key): metadata only
        self.index = []
        for di, ds in enumerate(self.datasets):
            for ui, u in enumerate(ds.manifest.utts):
                sb = bucket_length(u.num_samples, self.sample_buckets)
                if tokenizer is not None:
                    # the exact token count: characters undercount a phone
                    # vocabulary and collate would cut the labels
                    tok_len = len(tokenizer.encode(ds.transcript(ui)))
                else:
                    tok_len = len(ds.transcript(ui))
                tb = bucket_length(max(tok_len, 1), self.token_buckets)
                self.index.append((di, ui, (sb, tb)))

    @property
    def batches_per_epoch(self) -> int:
        """The same in every epoch: bucket membership is fixed, only the
        order inside each bucket is permuted."""
        counts: dict[tuple, int] = {}
        for _, _, key in self.index:
            counts[key] = counts.get(key, 0) + 1
        full = sum(n // self.batch_size for n in counts.values())
        if self.drop_last:
            return full
        return full + sum(1 for n in counts.values() if n % self.batch_size)

    def _epoch_refs(self, epoch: int):
        """(key, refs) batch plan of one epoch: a pure function of
        (seed, epoch)."""
        order = np.random.default_rng(
            (self.seed, int(epoch))).permutation(len(self.index))
        pending: dict[tuple, list] = {}
        for oi in order:
            di, ui, key = self.index[oi]
            pending.setdefault(key, []).append((di, ui))
            if len(pending[key]) == self.batch_size:
                yield key, pending.pop(key)
        if not self.drop_last:
            for key, items in pending.items():
                if items:
                    yield key, items

    def __iter__(self):
        """One epoch (epoch 0). Training loops use ``iter_from``."""
        for key, refs in self._epoch_refs(0):
            yield self._emit(key, refs)

    def iter_from(self, global_step: int):
        """Endless batch stream starting at batch index ``global_step`` of
        the (seed, epoch)-indexed schedule. Skipped batches are planned but
        never loaded."""
        bpe = self.batches_per_epoch
        if bpe == 0:
            raise ValueError("BucketBatcher: dataset yields zero batches "
                             "(batch_size too large for every bucket?)")
        epoch, skip = divmod(int(global_step), bpe)
        while True:
            for bi, (key, refs) in enumerate(self._epoch_refs(epoch)):
                if bi < skip:
                    continue
                yield self._emit(key, refs)
            epoch, skip = epoch + 1, 0

    def _emit(self, key, refs):
        sb, tb = key
        return collate([self.datasets[di][ui] for di, ui in refs], sb, tb)


class TaskSampler:
    """Per-accent meta-task sampler: ``sample(step)`` -> {"accents",
    "support", "query"} with ``[M, k, ...]`` arrays."""

    def __init__(self, datasets: dict, k_support: int, k_query: int,
                 tasks_per_batch: int, num_samples: int, num_tokens: int,
                 seed: int = 0, sample_buckets=(), token_buckets=()):
        self.datasets = dict(datasets)
        self.accents = sorted(self.datasets)
        if tasks_per_batch > len(self.accents):
            raise ValueError(
                f"tasks_per_batch={tasks_per_batch} > {len(self.accents)} accents")
        self.k_support = k_support
        self.k_query = k_query
        self.tasks_per_batch = tasks_per_batch
        self.num_samples = num_samples
        self.num_tokens = num_tokens
        self.seed = seed
        # per step the batch pads to the smallest bucket that fits the
        # longest drawn utterance (buckets clamped to the caps; none = the
        # caps)
        self.sample_buckets = tuple(
            sorted({min(int(s), num_samples) for s in sample_buckets}))
        self.token_buckets = tuple(
            sorted({min(int(u), num_tokens) for u in token_buckets}))
        # per-accent (num_samples, token_len) metadata: the bucket choice
        # never loads audio
        self._meta = {}
        for a, ds in self.datasets.items():
            ns = np.asarray([min(u.num_samples, num_samples)
                             for u in ds.manifest.utts], np.int64)
            tl = np.asarray(
                [min(len(ds.tokenizer.encode(ds.transcript(i))), num_tokens)
                 for i in range(len(ds))], np.int64)
            self._meta[a] = (ns, tl)

    def sample_indices(self, step: int):
        """(accents [M], support_idx [M, ks], query_idx [M, kq]) for
        ``step``: a pure function of (seed, step)."""
        rng = np.random.default_rng((self.seed, int(step)))
        accents = rng.choice(self.accents, size=self.tasks_per_batch,
                             replace=False)
        sup_idx, qry_idx = [], []
        for a in accents:
            n = len(self.datasets[a])
            idx = rng.choice(n, size=min(self.k_support + self.k_query, n),
                             replace=n < self.k_support + self.k_query)
            s_idx, q_idx = idx[: self.k_support], idx[self.k_support:]
            if len(q_idx) < self.k_query:
                q_idx = np.concatenate(
                    [q_idx, rng.choice(n, size=self.k_query - len(q_idx))])
            sup_idx.append(s_idx.astype(np.int32))
            qry_idx.append(q_idx.astype(np.int32))
        return list(accents), np.stack(sup_idx), np.stack(qry_idx)

    def sample(self, step: int, rows: slice | None = None,
               shots: tuple[int, int] | None = None) -> dict:
        """Meta-batch for ``step``. ``rows``: collate only these task rows
        (a rank's task group's, ``parallel.Mesh.task_rows``); ``shots``:
        (d, D), collate only the d-th of D equal slices of each task's
        support and query shots (a rank's on the data axis). The draw
        stays global and the bucket shape is decided over all M x (ks +
        kq) utterances, so every rank pads alike and the ranks' rows
        together are the one-process batch. With ``shots`` each part also
        holds ``whole_token_lens`` [M, k]: the token counts of all k shots
        of each task (from the metadata, no audio read), from which the
        loss takes the whole task's denominators."""
        accents, sup_idx, qry_idx = self.sample_indices(int(step))
        num_samples, num_tokens = self.step_shape(accents, sup_idx, qry_idx)
        if rows is not None:
            accents = accents[rows]
            sup_idx, qry_idx = sup_idx[rows], qry_idx[rows]
        parts = {"support": sup_idx, "query": qry_idx}
        out = {"accents": accents}
        for name, idx in parts.items():
            picked = idx
            if shots is not None:
                (lo, hi), = Rows.part(*shots, idx.shape[1]).spans
                picked = idx[:, lo:hi]
            batches = []
            for a, i_row in zip(accents, picked):
                ds = self.datasets[a]
                batches.append(collate([ds[int(i)] for i in i_row],
                                       num_samples, num_tokens))
            out[name] = _stack_batches(batches)
            if shots is not None:
                out[name]["whole_token_lens"] = np.stack(
                    [np.minimum(self._meta[a][1][i_row], num_tokens)
                     for a, i_row in zip(accents, idx)]).astype(np.int32)
        return out

    def step_shape(self, accents, sup_idx, qry_idx) -> tuple[int, int]:
        """(num_samples, num_tokens) for this draw: the smallest buckets that
        fit its longest utterance (the caps when no buckets are set)."""
        if not self.sample_buckets and not self.token_buckets:
            return self.num_samples, self.num_tokens
        s_max, u_max = 1, 1
        for a, s_idx, q_idx in zip(accents, sup_idx, qry_idx):
            ns, tl = self._meta[a]
            idx = np.concatenate([s_idx, q_idx])
            s_max = max(s_max, int(ns[idx].max()))
            u_max = max(u_max, int(tl[idx].max()))
        s = (bucket_length(s_max, self.sample_buckets)
             if self.sample_buckets else self.num_samples)
        u = (bucket_length(u_max, self.token_buckets)
             if self.token_buckets else self.num_tokens)
        return s, u


def support_query_split(ds, k_support: int, num_samples: int, num_tokens: int,
                        seed: int = 0) -> tuple[dict, list[int]]:
    """k-shot adaptation split of a held-out accent: a fixed support batch
    and the remaining utterance indices as the test set."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    support = collate([ds[int(i)] for i in idx[:k_support]], num_samples,
                      num_tokens)
    return support, [int(i) for i in idx[k_support:]]


def build_resident_store(datasets: dict, num_samples: int, num_tokens: int):
    """Every utterance of every accent collated once at the caps, for the
    device-resident corpus (``data.resident``) -> (store: {key: [N, ...]
    numpy array}, {accent: offset}). Accents are taken in sorted order;
    accent a's utterance i is row offset[a] + i. The store holds the keys
    ``collate`` gives: audio or feats with their lengths, tokens, token
    lengths, and the speaker-CMVN vectors where the items carry them."""
    offsets, items = {}, []
    for a in sorted(datasets):
        offsets[a] = len(items)
        ds = datasets[a]
        items.extend(ds[i] for i in range(len(ds)))
    batch = collate(items, num_samples, num_tokens)
    return {k: v for k, v in batch.items() if k != "texts"}, offsets


def resident_store_bytes(datasets: dict, num_samples: int,
                         num_tokens: int) -> int:
    """The store's size as the ``auto`` budget reckons it: waveform,
    tokens and two lengths per utterance (the same figure for a feature
    corpus, so both packages decide alike)."""
    n = sum(len(ds) for ds in datasets.values())
    return n * (num_samples * 4 + num_tokens * 4 + 8)


def _stack_batches(batches: list[dict]) -> dict:
    out = {}
    for k in batches[0]:
        if k == "texts":
            out[k] = [b[k] for b in batches]
        else:
            out[k] = np.stack([b[k] for b in batches])
    return out
