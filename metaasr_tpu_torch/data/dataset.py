"""Per-accent dataset over JSONL manifests (counterpart of
``metaasr_tpu/data/dataset.py``).

The reference reads Common Voice tsv manifests per accent and loads
precomputed fbank or raw audio (R: src/dataset.py, SURVEY.md section 2.1 #12).
Here the manifest is JSONL, one utterance per line:

    {"id": "...", "wav": "rel/path.wav", "text": "...", "phones": "...",
     "num_samples": 48000}

Raw audio is the canonical payload: the front-end (fbank/CMVN/SpecAugment)
runs on the device over padded waveform batches, so the host side only
decodes, pads, and batches.
Precomputed-feature manifests ("feats": "rel/path.npy") are also supported
for parity with the reference's offline-extraction mode.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from metaasr_tpu_torch.data.audio_io import load_wav


@dataclass(frozen=True)
class Utterance:
    utt_id: str
    text: str
    phones: str
    num_samples: int
    wav: str | None = None
    feats: str | None = None
    speaker: str = ""


@dataclass
class Manifest:
    accent: str
    root: str
    utts: list[Utterance]

    @classmethod
    def load(cls, path: str, accent: str | None = None) -> "Manifest":
        root = os.path.dirname(os.path.abspath(path))
        name = accent or os.path.splitext(os.path.basename(path))[0]
        utts = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                utts.append(
                    Utterance(
                        utt_id=d["id"],
                        text=d.get("text", ""),
                        phones=d.get("phones", ""),
                        num_samples=int(d["num_samples"]),
                        wav=d.get("wav"),
                        feats=d.get("feats"),
                        speaker=d.get("speaker", ""),
                    )
                )
        return cls(accent=name, root=root, utts=utts)


class AccentDataset:
    """Random-access utterances of one accent: audio + transcript tokens."""

    def __init__(self, manifest: Manifest, tokenizer, vocab: str = "char",
                 sample_rate: int = 16000, speaker_cmvn: dict | None = None,
                 cache_audio: bool = False):
        self.manifest = manifest
        self.tokenizer = tokenizer
        self.vocab = vocab
        self.sample_rate = sample_rate
        # host RAM cache of decoded waveforms (the meta sampler re-draws
        # utterances every step; decode once)
        self._audio_cache: dict[int, np.ndarray] | None = (
            {} if cache_audio else None)
        # {speaker: {"mean": [...80], "var": [...80]}} (speaker-level CMVN,
        # SURVEY.md section 2.1 #16); falls back to the speaker "" entry
        # or utterance stats downstream when a speaker is missing
        self.speaker_cmvn = speaker_cmvn

    def split(self, dev_fraction: float, seed: int = 0):
        """Deterministic train/dev partition of this accent's utterances
        (the reference holds out a per-accent dev set; SURVEY.md section
        2.1 #3 'early stop on dev'). Returns (train_ds, dev_ds)."""
        import zlib

        n = len(self.manifest.utts)
        n_dev = max(1, int(n * dev_fraction)) if dev_fraction > 0 else 0
        # zlib.crc32: stable across processes (python hash() is salted)
        order = np.random.default_rng(
            (seed, zlib.crc32(self.accent.encode()))).permutation(n)
        dev_idx = set(int(i) for i in order[:n_dev])
        tr = [u for i, u in enumerate(self.manifest.utts) if i not in dev_idx]
        dv = [u for i, u in enumerate(self.manifest.utts) if i in dev_idx]
        mk = lambda utts: AccentDataset(  # noqa: E731
            Manifest(accent=self.accent, root=self.manifest.root, utts=utts),
            self.tokenizer, vocab=self.vocab, sample_rate=self.sample_rate,
            speaker_cmvn=self.speaker_cmvn,
            cache_audio=self._audio_cache is not None)
        return mk(tr), mk(dv)

    @property
    def accent(self) -> str:
        return self.manifest.accent

    def __len__(self) -> int:
        return len(self.manifest.utts)

    def transcript(self, i: int) -> str:
        u = self.manifest.utts[i]
        return u.phones if self.vocab == "phone" else u.text

    def __getitem__(self, i: int) -> dict:
        if self._audio_cache is not None:
            hit = self._audio_cache.get(i)
            if hit is not None:
                return hit
        u = self.manifest.utts[i]
        tokens = self.tokenizer.encode(self.transcript(i))
        if u.wav is not None:
            audio = load_wav(os.path.join(self.manifest.root, u.wav),
                             self.sample_rate)
            item = {"utt_id": u.utt_id, "audio": audio, "tokens": tokens,
                    "text": self.transcript(i)}
        else:
            feats = np.load(os.path.join(self.manifest.root, u.feats))
            item = {"utt_id": u.utt_id, "feats": feats.astype(np.float32),
                    "tokens": tokens, "text": self.transcript(i)}
        if self.speaker_cmvn is not None:
            st = self.speaker_cmvn.get(u.speaker) or self.speaker_cmvn.get("")
            if st is not None:
                item["cmvn_mean"] = np.asarray(st["mean"], np.float32)
                item["cmvn_std"] = np.sqrt(
                    np.asarray(st["var"], np.float32) + 1e-10)
        if self._audio_cache is not None:
            # cache the full item (audio + tokens are immutable; collate
            # only reads) — host pipeline cost drops to pad+stack
            self._audio_cache[i] = item
        return item


def discover_accents(data_dir: str) -> list[str]:
    """All accents with a ``<accent>.jsonl`` manifest under ``data_dir``."""
    out = []
    for fn in sorted(os.listdir(data_dir)):
        if fn.endswith(".jsonl"):
            out.append(fn[: -len(".jsonl")])
    return out


def load_accent_datasets(data_dir: str, tokenizer, accents=(), vocab="char",
                         sample_rate=16000, speaker_cmvn_path: str = "",
                         cache_audio: bool = False) -> dict[str, AccentDataset]:
    names = list(accents) or discover_accents(data_dir)
    speaker_cmvn = None
    if speaker_cmvn_path:
        with open(speaker_cmvn_path) as f:
            speaker_cmvn = json.load(f)
    return {
        name: AccentDataset(
            Manifest.load(os.path.join(data_dir, f"{name}.jsonl"), accent=name),
            tokenizer, vocab=vocab, sample_rate=sample_rate,
            speaker_cmvn=speaker_cmvn, cache_audio=cache_audio,
        )
        for name in names
    }
