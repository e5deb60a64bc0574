"""Synthetic multi-accent speech-like dataset (a copy of
``metaasr_tpu/data/synthetic.py``; numpy only, same manifests and samples
for the same seed).

Real Common Voice audio does not ship with the repo (SURVEY.md section 7
'hard parts'). This generator produces a
drop-in replacement with the SAME manifest interface as real data
(dataset.py), designed so the task is genuinely learnable and accents
genuinely differ (meta-learning has signal):

- a small fixed lexicon of pseudo-words; transcripts are word sequences
  (WER is meaningful);
- each character is rendered as a short harmonic tone burst whose base
  frequency encodes the character identity;
- each ACCENT applies a systematic transform: pitch scaling, harmonic tilt,
  speaking rate, and a fixed formant-like spectral envelope. Within-accent
  utterances share the transform; across accents it differs — exactly the
  structure MAML exploits (fast adaptation to a new accent's transform).
"""

from __future__ import annotations

import json
import os

import numpy as np

from metaasr_tpu_torch.data.audio_io import write_wav

LEXICON = (
    "aba bede cide dofu egi fona gute hiba ije kelo lumi mano nipe ogu "
    "pade qui rosa situ tule uvo wabe xen yolo zumi bro cla dri fle gno"
).split()

# hard profile: larger lexicon with many near-neighbors (single-char edits
# of each other), so one decode slip is one word error, not a detectable
# non-word
LEXICON_HARD = LEXICON + (
    "abe abi bade bida cida cido dafu dogu egu eki fena fono gude guto "
    "hibe huba iji ika kalo kilu lumo lami mono mani nipo nupe oga egu "
    "pado pede quo qua rose rasa sito satu tula tele uva evo wabo webe "
    "xin xan yole yulo zume zimi bra cle dra fli gna sno tro vle"
).split()

ACCENTS = ("alpha", "bravo", "echo", "delta", "india", "kilo", "oscar", "tango")

# >=12 accents for the hard regime: the quality benchmark
# saturated at WER 0.000 on the 8-accent easy set
ACCENTS_HARD = ACCENTS + ("juliet", "lima", "mike", "november", "papa",
                          "quebec", "romeo", "sierra")


def _accent_params(accent_idx: int, rng: np.random.Generator,
                   profile: str = "easy") -> dict:
    if profile == "bpe":
        profile = "hard"  # bpe = hard acoustics + big_lexicon text
    if profile == "hard":
        # Closer, OVERLAPPING transforms: pitch grid spacing ~3.5% (vs 8%
        # easy) with an interleaved ordering so accent id distance is not
        # parameter distance; with the tighter 14 Hz character spacing a
        # +-3.5% pitch shift moves high chars onto their neighbors'
        # frequencies — cross-accent char aliasing only resolvable once
        # the accent's transform is identified (exactly what few-shot
        # adaptation provides). Per-utterance rate jitter + a real noise
        # floor keep single utterances ambiguous.
        n = 16
        return {
            "pitch": 1.0 + 0.035 * (((accent_idx * 7) % n) - (n - 1) / 2)
            + 0.004 * rng.standard_normal(),
            "rate": 1.0 + 0.14 * ((((accent_idx * 5) % 8) - 3.5) / 3.5),
            "tilt": 0.40 + 0.07 * ((accent_idx * 3) % 5),
            "env_phase": 2 * np.pi * ((accent_idx * 11) % n) / n,
            # noise + per-utterance rate jitter are the IRREDUCIBLE
            # ambiguity: adaptation identifies the accent transform but
            # cannot remove per-utterance jitter or the noise floor, so
            # they set the floor of the adapted-model WER (the reference's
            # calibration puts the 5-shot WER in a 0.05-0.3 band).
            "noise": 0.13,
            "char_hz": 14.0,
            "rate_jitter": 0.10,
            "harmonics": 4,
        }
    return {
        "pitch": 1.0 + 0.08 * (accent_idx - 3.5) + 0.01 * rng.standard_normal(),
        "rate": 1.0 + 0.10 * ((accent_idx % 4) - 1.5),
        "tilt": 0.5 + 0.12 * (accent_idx % 3),
        "env_phase": 2 * np.pi * accent_idx / 8.0,
    }


def synth_utterance(text: str, accent_params: dict, rng: np.random.Generator,
                    sample_rate: int = 16000) -> np.ndarray:
    """Render ``text`` (chars a-z + space) to a waveform."""
    rate = accent_params["rate"]
    jitter = accent_params.get("rate_jitter", 0.0)
    if jitter:
        rate *= 1.0 + jitter * float(rng.standard_normal())
    seg_dur = 0.09 / max(rate, 0.5)
    seg_len = int(seg_dur * sample_rate)
    char_hz = accent_params.get("char_hz", 28.0)
    n_harm = accent_params.get("harmonics", 3)
    pieces = []
    t = np.arange(seg_len) / sample_rate
    for ch in text.lower():
        if ch == " ":
            pieces.append(np.zeros(seg_len // 2, dtype=np.float32))
            continue
        if not ("a" <= ch <= "z"):
            continue
        k = ord(ch) - ord("a")
        f0 = (180.0 + char_hz * k) * accent_params["pitch"]
        sig = np.zeros(seg_len)
        for h in range(1, n_harm + 1):
            amp = accent_params["tilt"] ** (h - 1)
            # formant-like accent envelope: fixed per accent, varies with harmonic
            amp *= 1.0 + 0.3 * np.sin(accent_params["env_phase"] + h)
            sig += amp * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
        # attack/decay envelope to avoid clicks
        env = np.minimum(np.arange(seg_len), seg_len - np.arange(seg_len))
        env = np.minimum(env / (0.1 * seg_len), 1.0)
        pieces.append((sig * env).astype(np.float32))
    if not pieces:
        pieces = [np.zeros(seg_len, dtype=np.float32)]
    wav = np.concatenate(pieces)
    noise = accent_params.get("noise", 0.01)
    wav += noise * rng.standard_normal(len(wav)).astype(np.float32)
    peak = np.abs(wav).max()
    return (0.6 * wav / max(peak, 1e-6)).astype(np.float32)


def big_lexicon(n_words: int = 700, seed: int = 7) -> list[str]:
    """Large pseudo-word lexicon for BPE-scale vocabularies the
    hand-written lexicons top out near ~130 distinct words, which caps a
    learned BPE vocab near ~150 — too small to exercise the >=512-token
    regime the beam search's ctc_candidates pruning exists for. Words are
    CVCV..-shaped (pronounceable under the per-char tone renderer) and
    deduplicated."""
    rng = np.random.default_rng(seed)
    cons, vow = "bcdfghjklmnprstvwz", "aeiou"
    words: set[str] = set()
    while len(words) < n_words:
        n_syll = int(rng.integers(2, 4))
        w = "".join(cons[int(rng.integers(len(cons)))]
                    + vow[int(rng.integers(len(vow)))]
                    for _ in range(n_syll))
        if int(rng.integers(2)):
            w += cons[int(rng.integers(len(cons)))]
        words.add(w)
    return sorted(words)


def generate_dataset(data_dir: str, accents=ACCENTS, utts_per_accent: int = 64,
                     words_per_utt: tuple[int, int] = (2, 5), seed: int = 0,
                     sample_rate: int = 16000, write_wavs: bool = True,
                     profile: str = "easy") -> None:
    """Write ``<accent>.jsonl`` manifests + WAVs under ``data_dir``.

    ``profile='hard'``: the de-saturated quality benchmark — 14 Hz char
    spacing (confusable under pitch shifts), near-neighbor lexicon, 8%
    noise floor, per-utterance rate jitter, overlapping accent transforms.
    Pair with ``accents=ACCENTS_HARD`` and longer ``words_per_utt``.
    ``profile='bpe'``: hard acoustics with the ``big_lexicon`` text
    distribution (700 distinct words) so a learned BPE vocab reaches the
    >=512-token regime.
    """
    os.makedirs(data_dir, exist_ok=True)
    lexicon = (big_lexicon() if profile == "bpe"
               else LEXICON_HARD if profile == "hard" else LEXICON)
    master = np.random.default_rng(seed)
    for ai, accent in enumerate(accents):
        rng = np.random.default_rng(master.integers(2**31) + ai)
        params = _accent_params(ai, rng, profile)
        wav_dir = os.path.join(data_dir, "wav", accent)
        if write_wavs:
            os.makedirs(wav_dir, exist_ok=True)
        lines = []
        for ui in range(utts_per_accent):
            n_words = int(rng.integers(words_per_utt[0], words_per_utt[1] + 1))
            words = [lexicon[int(rng.integers(len(lexicon)))] for _ in range(n_words)]
            text = " ".join(words)
            wav = synth_utterance(text, params, rng, sample_rate)
            utt_id = f"{accent}_{ui:04d}"
            rel = os.path.join("wav", accent, f"{utt_id}.wav")
            if write_wavs:
                write_wav(os.path.join(data_dir, rel), wav, sample_rate)
            lines.append(json.dumps({
                "id": utt_id,
                "wav": rel,
                "text": text,
                "phones": " ".join(c.upper() for c in text if c != " "),
                "num_samples": len(wav),
                "speaker": f"spk_{accent}",
            }))
        with open(os.path.join(data_dir, f"{accent}.jsonl"), "w") as f:
            f.write("\n".join(lines) + "\n")
