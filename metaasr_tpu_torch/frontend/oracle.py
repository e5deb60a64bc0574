"""Readable numpy reference implementation of the Kaldi-compliance fbank
(a copy of ``metaasr_tpu/frontend/oracle.py``).

This is the SPEC implementation: a direct, per-frame transcription of the
Kaldi `compute-fbank-feats` algorithm (the original system consumes it
through ``torchaudio.compliance.kaldi.fbank``, SURVEY.md section 2.1 #16),
the golden oracle for K1 and its plain version (chip_smoke.py,
tests/test_torch_frontend.py).

Spec (16 kHz defaults): snip_edges framing (25 ms window / 400 samples,
10 ms shift / 160 samples), optional dither, DC-offset removal, preemphasis
0.97 (in-frame, first sample against itself), povey window
(hann^0.85), zero-pad to 512, power spectrum, Kaldi mel banks
(mel = 1127 ln(1+f/700), low 20 Hz, high Nyquist, triangular in mel space,
Nyquist bin excluded), natural log with float-eps floor.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
FRAME_LEN = 400
FRAME_SHIFT = 160
N_FFT = 512
EPS = float(np.finfo(np.float32).eps)


def povey_window(n: int = FRAME_LEN) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))) ** 0.85


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def mel_banks(num_bins: int = 80, n_fft: int = N_FFT,
              sample_rate: int = SAMPLE_RATE, low_freq: float = 20.0,
              high_freq: float = 0.0) -> np.ndarray:
    """[num_bins, n_fft//2] triangular weights over fft bins 0..n_fft/2-1
    (Nyquist excluded, as Kaldi's MelBanks does)."""
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    num_fft_bins = n_fft // 2
    fft_bin_width = sample_rate / n_fft
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.zeros((num_bins, num_fft_bins), dtype=np.float64)
    fft_freqs = fft_bin_width * np.arange(num_fft_bins)
    mel = mel_scale(fft_freqs)
    for j in range(num_bins):
        left = mel_low + j * mel_delta
        center = left + mel_delta
        right = center + mel_delta
        up = (mel - left) / (center - left)
        down = (right - mel) / (right - center)
        bins[j] = np.clip(np.minimum(up, down), 0.0, None)
    return bins


def frame_signal(x: np.ndarray) -> np.ndarray:
    """snip_edges framing: [S] -> [F, 400], F = 1 + (S-400)//160 (0 if S<400)."""
    if len(x) < FRAME_LEN:
        return np.zeros((0, FRAME_LEN), dtype=np.float64)
    nf = 1 + (len(x) - FRAME_LEN) // FRAME_SHIFT
    return np.stack([x[f * FRAME_SHIFT: f * FRAME_SHIFT + FRAME_LEN] for f in range(nf)])


def fbank_oracle(audio: np.ndarray, num_mel_bins: int = 80,
                 preemphasis: float = 0.97, remove_dc_offset: bool = True,
                 dither: float = 0.0, low_freq: float = 20.0,
                 high_freq: float = 0.0,
                 sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """[S] float waveform -> [F, num_mel_bins] log-mel features (float64)."""
    frames = frame_signal(np.asarray(audio, dtype=np.float64))
    if dither:
        frames = frames + dither * np.random.standard_normal(frames.shape)
    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis:
        pre = np.empty_like(frames)
        pre[:, 1:] = frames[:, 1:] - preemphasis * frames[:, :-1]
        pre[:, 0] = frames[:, 0] - preemphasis * frames[:, 0]
        frames = pre
    frames = frames * povey_window()[None, :]
    spec = np.fft.rfft(frames, n=N_FFT, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, : N_FFT // 2]  # drop Nyquist
    mel = power @ mel_banks(num_mel_bins, N_FFT, sample_rate, low_freq, high_freq).T
    return np.log(np.maximum(mel, EPS))


def cmvn_oracle(feats: np.ndarray, norm_var: bool = False) -> np.ndarray:
    """Per-utterance cepstral mean (and optionally variance) normalization."""
    mu = feats.mean(axis=0, keepdims=True)
    out = feats - mu
    if norm_var:
        out = out / np.sqrt(feats.var(axis=0, keepdims=True) + 1e-10)
    return out
