"""Kaldi log-mel filterbank, per-utterance CMVN and SpecAugment.

The filterbank follows Kaldi's ``compute-fbank-feats`` at 16 kHz: frames of
400 samples every 160 (snip edges), DC offset removed, preemphasis 0.97
(the first sample against itself), the povey window, a 512-point power
spectrum without its Nyquist bin, 80 triangular mel filters from 20 Hz to
Nyquist (mel = 1127 ln(1 + f / 700)), the natural log floored at float32's
epsilon. Computed in float64 and returned in float32.

SpecAugment (Park et al., 2019) masks 2 frequency bands of width U[0, 27]
and 2 time spans of width U[0, min(70, 0.2 L)] to 0; widths and starts are
drawn as ``randint(0, 2**30) mod range`` from the step's generator, the
frequency draws first, widths before starts.
"""

from __future__ import annotations

import numpy as np
import torch

FRAME_LEN, FRAME_SHIFT, N_FFT = 400, 160, 512
PREEMPHASIS = 0.97
FLOOR = float(np.finfo(np.float32).eps)


def povey_window(n: int = FRAME_LEN) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))) ** 0.85


def mel_banks(num_bins: int = 80, sample_rate: int = 16000,
              low: float = 20.0) -> np.ndarray:
    """[num_bins, N_FFT / 2] filter weights over the FFT bins below
    Nyquist."""
    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    lo, hi = mel(low), mel(sample_rate / 2.0)
    delta = (hi - lo) / (num_bins + 1)
    freqs = mel(sample_rate / N_FFT * np.arange(N_FFT // 2))
    banks = np.zeros((num_bins, N_FFT // 2))
    for j in range(num_bins):
        left, centre, right = lo + j * delta, lo + (j + 1) * delta, \
            lo + (j + 2) * delta
        banks[j] = np.clip(np.minimum((freqs - left) / (centre - left),
                                      (right - freqs) / (right - centre)),
                           0.0, None)
    return banks


def frame_lengths(audio_lens: torch.Tensor) -> torch.Tensor:
    n = 1 + torch.div(audio_lens.long() - FRAME_LEN, FRAME_SHIFT,
                      rounding_mode="floor")
    return n.clamp_min(0)


def valid_mask(lens: torch.Tensor, length: int) -> torch.Tensor:
    return torch.arange(length, device=lens.device)[None, :] < \
        lens.long()[:, None]


def log_mel(audio: torch.Tensor, audio_lens: torch.Tensor,
            num_bins: int = 80):
    """[B, S] waveforms -> ([B, F, num_bins] float32 features, padded frames
    0; [B] frame counts)."""
    flen = frame_lengths(audio_lens)
    frames = audio.double().unfold(1, FRAME_LEN, FRAME_SHIFT)
    frames = frames - frames.mean(dim=2, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=2)
    frames = (frames - PREEMPHASIS * prev) * torch.from_numpy(
        povey_window()).to(audio.device)
    spec = torch.fft.rfft(frames, n=N_FFT, dim=2)[..., : N_FFT // 2]
    power = spec.real ** 2 + spec.imag ** 2
    banks = torch.from_numpy(mel_banks(num_bins)).to(audio.device)
    feats = torch.log(torch.clamp_min(power @ banks.T, FLOOR))
    mask = valid_mask(flen, feats.shape[1])[..., None]
    return torch.where(mask, feats, 0.0).float(), flen


def cmvn(feats: torch.Tensor, flen: torch.Tensor) -> torch.Tensor:
    """Subtract each utterance's mean over its valid frames."""
    mask = valid_mask(flen, feats.shape[1])[..., None]
    x = feats.double()
    mean = (x * mask).sum(1, keepdim=True) / flen.clamp_min(1).double()[
        :, None, None]
    return torch.where(mask, x - mean, 0.0).float()


def features(audio, audio_lens):
    """Waveforms -> CMVN'd log-mel features and frame counts."""
    feats, flen = log_mel(audio, audio_lens)
    return cmvn(feats, flen), flen


def _mask_axis(gen, valid, num, max_width):
    shape = (valid.shape[0], num)
    raw_w = torch.randint(0, 1 << 30, shape, generator=gen,
                          device=valid.device)
    width = raw_w % (max_width.clamp_min(0)[:, None] + 1)
    span = torch.clamp_min(valid[:, None] - width, 1)
    raw_s = torch.randint(0, 1 << 30, shape, generator=gen,
                          device=valid.device)
    return width, raw_s % span


def _keep(length, width, start):
    pos = torch.arange(length, device=width.device)[None, None, :]
    hit = (pos >= start[..., None]) & (pos < (start + width)[..., None])
    return ~hit.any(dim=1)


def spec_augment(gen, feats, flen, freq_masks=2, freq_width=27,
                 time_masks=2, time_width=70, time_ratio=0.2):
    bsz, t_len, dim = feats.shape
    dev = feats.device
    full = torch.full((bsz,), dim, dtype=torch.int64, device=dev)
    fw, fs = _mask_axis(gen, full, freq_masks,
                        torch.full((bsz,), freq_width, dtype=torch.int64,
                                   device=dev))
    cap = torch.clamp_max((time_ratio * flen.float()).long(), time_width)
    tw, ts = _mask_axis(gen, flen.long(), time_masks, cap)
    keep = _keep(t_len, tw, ts)[:, :, None] & _keep(dim, fw, fs)[:, None, :]
    return torch.where(keep, feats, 0.0)
