"""Byte-pair-encoding subword tokenizer (a copy of
``metaasr_tpu/data/bpe.py``: the same merges, ids and JSON for the same
corpus).

The reference's attention models use char or BPE vocabularies (SURVEY.md
section 2.1 #15). This is a first-party, dependency-free BPE:
sentencepiece-style word-boundary marker (WORD_SEP prefixes each word),
classic highest-frequency pair merges at train time, lowest-rank greedy
merges at encode time. Same id layout as the other tokenizers
(blank=0, symbols 1..N, shared sos/eos last).
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from metaasr_tpu_torch.constants import BLANK_ID

WORD_SEP = "▁"  # sentencepiece-style word-boundary marker


def _word_to_units(word: str) -> tuple[str, ...]:
    return (WORD_SEP + word[0],) + tuple(word[1:])


def train_bpe(texts, num_merges: int = 200) -> tuple[list[str], list[tuple[str, str]]]:
    """Learn merges from a corpus. Returns (base symbols, ordered merges)."""
    words = Counter()
    for t in texts:
        for w in t.lower().split():
            words[w] += 1
    seqs = {w: list(_word_to_units(w)) for w in words}
    base = sorted({u for seq in seqs.values() for u in seq})
    merges: list[tuple[str, str]] = []
    for _ in range(num_merges):
        pairs = Counter()
        for w, seq in seqs.items():
            cnt = words[w]
            for a, b in zip(seq, seq[1:]):
                pairs[(a, b)] += cnt
        if not pairs:
            break
        (a, b), freq = pairs.most_common(1)[0]
        if freq < 2:
            break
        merges.append((a, b))
        ab = a + b
        for w, seq in seqs.items():
            i, out = 0, []
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                    out.append(ab)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            seqs[w] = out
    return base, merges


@dataclass(frozen=True)
class BPETokenizer:
    """Subword tokenizer over learned merges."""

    symbols: tuple[str, ...]                  # base units + merged units
    merges: tuple[tuple[str, str], ...] = field(default=())

    @classmethod
    def from_corpus(cls, texts, num_merges: int = 200) -> "BPETokenizer":
        base, merges = train_bpe(texts, num_merges)
        merged_units = [a + b for a, b in merges]
        return cls(symbols=tuple(base + merged_units), merges=tuple(merges))

    @property
    def vocab_size(self) -> int:
        return len(self.symbols) + 2  # blank + symbols + sos/eos

    @property
    def blank_id(self) -> int:
        return BLANK_ID

    @property
    def sos_eos_id(self) -> int:
        return self.vocab_size - 1

    def _ranks(self) -> dict[tuple[str, str], int]:
        return {m: i for i, m in enumerate(self.merges)}

    def _encode_word(self, word: str, ranks, sym_to_id) -> list[int]:
        seq = list(_word_to_units(word))
        while len(seq) > 1:
            best, best_rank = None, None
            for i, pair in enumerate(zip(seq, seq[1:])):
                r = ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            seq[best: best + 2] = [seq[best] + seq[best + 1]]
        return [sym_to_id[u] for u in seq if u in sym_to_id]

    def encode(self, text: str) -> np.ndarray:
        ranks = self._ranks()
        sym_to_id = {s: i + 1 for i, s in enumerate(self.symbols)}
        ids: list[int] = []
        for w in text.lower().split():
            ids.extend(self._encode_word(w, ranks, sym_to_id))
        return np.array(ids, dtype=np.int32)

    def decode(self, ids) -> str:
        parts = []
        for i in ids:
            i = int(i)
            if i == self.blank_id or i == self.sos_eos_id or i < 0:
                continue
            parts.append(self.symbols[i - 1])
        return "".join(parts).replace(WORD_SEP, " ").strip()

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"type": "BPETokenizer", "symbols": list(self.symbols),
                       "merges": [list(m) for m in self.merges]}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls(symbols=tuple(d["symbols"]),
                   merges=tuple(tuple(m) for m in d["merges"]))
