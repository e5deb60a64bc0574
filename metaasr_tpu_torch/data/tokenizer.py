"""Text/token pipeline (counterpart of ``metaasr_tpu/data/tokenizer.py``).

The reference has a vocab of phones (for the VGG-BLSTM CTC baseline,
BASELINE.json:7) or chars for the attention model, with tokenize/detokenize
helpers (R: src/text.py, SURVEY.md section 2.1 #15).

Vocabulary layout (ESPnet/Kaldi convention):
  id 0           : <blank> (CTC blank, also used as pad)
  ids 1..N       : symbols (chars or phones)
  id vocab_size-1: <sos>/<eos> (shared, attention decoder only)

``_BaseTokenizer.load`` reads any of the three vocabulary files
(``CharTokenizer``, ``PhoneTokenizer``, ``data.bpe.BPETokenizer``) by the
type it records.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from metaasr_tpu_torch.constants import BLANK_ID
from metaasr_tpu_torch.data.bpe import BPETokenizer


@dataclass(frozen=True)
class _BaseTokenizer:
    symbols: tuple[str, ...]  # indexable by (id - 1)

    @property
    def vocab_size(self) -> int:
        # blank + symbols + sos/eos
        return len(self.symbols) + 2

    @property
    def blank_id(self) -> int:
        return BLANK_ID

    @property
    def sos_eos_id(self) -> int:
        return self.vocab_size - 1

    def _sym_to_id(self) -> dict[str, int]:
        return {s: i + 1 for i, s in enumerate(self.symbols)}

    def ids_to_symbols(self, ids) -> list[str]:
        out = []
        for i in ids:
            i = int(i)
            if i == self.blank_id or i == self.sos_eos_id or i < 0:
                continue
            out.append(self.symbols[i - 1])
        return out

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"type": type(self).__name__, "symbols": list(self.symbols)}, f)

    @classmethod
    def load(cls, path: str):
        with open(path) as f:
            d = json.load(f)
        if d.get("type") == "BPETokenizer":
            return BPETokenizer.load(path)
        klass = {"CharTokenizer": CharTokenizer, "PhoneTokenizer": PhoneTokenizer}[d["type"]]
        return klass(symbols=tuple(d["symbols"]))


@dataclass(frozen=True)
class CharTokenizer(_BaseTokenizer):
    """Character vocab for the attention model (SURVEY.md section 2.1 #15)."""

    @classmethod
    def from_corpus(cls, texts) -> "CharTokenizer":
        chars = sorted({c for t in texts for c in t.lower()})
        return cls(symbols=tuple(chars))

    @classmethod
    def ascii_default(cls) -> "CharTokenizer":
        syms = [" ", "'"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
        return cls(symbols=tuple(syms))

    def encode(self, text: str) -> np.ndarray:
        m = self._sym_to_id()
        return np.array([m[c] for c in text.lower() if c in m], dtype=np.int32)

    def decode(self, ids) -> str:
        return "".join(self.ids_to_symbols(ids))


@dataclass(frozen=True)
class PhoneTokenizer(_BaseTokenizer):
    """Phone vocab for the CTC phone-recognizer baseline (BASELINE.json:7).

    Phones are space-separated strings in manifests (lexicon/g2p is an
    offline prep concern, SURVEY.md section 3.5).
    """

    @classmethod
    def from_corpus(cls, phone_seqs) -> "PhoneTokenizer":
        phones = sorted({p for seq in phone_seqs for p in seq.split()})
        return cls(symbols=tuple(phones))

    @classmethod
    def arpabet_default(cls) -> "PhoneTokenizer":
        phones = (
            "AA AE AH AO AW AY B CH D DH EH ER EY F G HH IH IY JH K L M N NG "
            "OW OY P R S SH T TH UH UW V W Y Z ZH sil"
        ).split()
        return cls(symbols=tuple(sorted(phones)))

    def encode(self, text: str) -> np.ndarray:
        m = self._sym_to_id()
        return np.array([m[p] for p in text.split() if p in m], dtype=np.int32)

    def decode(self, ids) -> str:
        return " ".join(self.ids_to_symbols(ids))
