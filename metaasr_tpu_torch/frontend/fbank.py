"""Log-mel fbank front-end (counterpart of ``metaasr_tpu/frontend/fbank.py``).

Per frame, DC removal, preemphasis, the povey window and the DFT of the
zero-padded 512-point window are all linear maps of the 400 raw samples,
so they fold into two [400, 256] matrices (real and imaginary planes); the
mel banks are a [256, num_mel_bins] matrix. :class:`FbankParams` re-derives
them in numpy (the plain version's product), and keeps the unfolded values
(window, preemphasis, DC removal) that K1 applies one by one before its
FFT. The features themselves come from K1 (``fbank_kernel.fused_log_mel``:
the CUDA kernel on the card, its plain version on the CPU); masking and
per-utterance CMVN follow here.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from metaasr_tpu_torch.frontend import oracle
from metaasr_tpu_torch.frontend.fbank_kernel import fused_log_mel
from metaasr_tpu_torch.utils.padding import make_non_pad_mask

FRAME_LEN = oracle.FRAME_LEN      # 400
FRAME_SHIFT = oracle.FRAME_SHIFT  # 160
N_FFT = oracle.N_FFT              # 512
N_BINS = N_FFT // 2               # 256 (Nyquist excluded from mel anyway)


def num_frames(num_samples: int) -> int:
    """snip_edges frame count for a padded length."""
    return max(0, 1 + (num_samples - FRAME_LEN) // FRAME_SHIFT)


@dataclass(frozen=True)
class FbankParams:
    """Front-end matrices (built in float64, stored float32) and the
    unfolded front-end they fold."""

    c_cos: np.ndarray  # [400, 256]
    c_sin: np.ndarray  # [400, 256]
    mel_t: np.ndarray  # [256, num_mel_bins]
    num_mel_bins: int
    window: np.ndarray  # [400] povey window, float64
    preemphasis: float
    remove_dc_offset: bool

    @classmethod
    @functools.lru_cache(maxsize=8)
    def create(cls, num_mel_bins: int = 80, preemphasis: float = 0.97,
               remove_dc_offset: bool = True, low_freq: float = 20.0,
               high_freq: float = 0.0, sample_rate: int = 16000) -> "FbankParams":
        n = FRAME_LEN
        lin = np.eye(n)
        if remove_dc_offset:
            lin = lin - np.full((n, n), 1.0 / n)
        if preemphasis:
            pre = np.eye(n)
            idx = np.arange(1, n)
            pre[idx, idx - 1] = -preemphasis
            pre[0, 0] = 1.0 - preemphasis
            lin = pre @ lin
        window = oracle.povey_window(n)
        lin = window[:, None] * lin  # diag(w) @ pre @ dc
        ang = 2.0 * np.pi * np.outer(np.arange(n), np.arange(N_BINS)) / N_FFT
        mel = oracle.mel_banks(num_mel_bins, N_FFT, sample_rate, low_freq,
                               high_freq)
        return cls(c_cos=(lin.T @ np.cos(ang)).astype(np.float32),
                   c_sin=(lin.T @ -np.sin(ang)).astype(np.float32),
                   mel_t=mel.T.astype(np.float32),
                   num_mel_bins=num_mel_bins, window=window,
                   preemphasis=float(preemphasis),
                   remove_dc_offset=bool(remove_dc_offset))


def frame_lengths(audio_lens: torch.Tensor) -> torch.Tensor:
    """Valid frame counts (int32) from valid sample counts."""
    fl = 1 + torch.div(audio_lens.to(torch.int64) - FRAME_LEN, FRAME_SHIFT,
                       rounding_mode="floor")
    return torch.clamp(fl, min=0).to(torch.int32)


def apply_cmvn(feats: torch.Tensor, feat_lens: torch.Tensor,
               norm_var: bool = False) -> torch.Tensor:
    """Masked per-utterance CMVN over valid frames. [B, F, D] -> same."""
    mask = make_non_pad_mask(feat_lens, feats.shape[1])[..., None]
    denom = torch.clamp_min(feat_lens.to(feats.dtype), 1.0)[:, None, None]
    mu = torch.sum(feats * mask, dim=1, keepdim=True) / denom
    out = torch.where(mask, feats - mu, 0.0)
    if norm_var:
        var = torch.sum(out * out * mask, dim=1, keepdim=True) / denom
        out = torch.where(mask, out * torch.rsqrt(var + 1e-10), 0.0)
    return out


def log_mel_fbank(audio: torch.Tensor, audio_lens: torch.Tensor,
                  params: FbankParams | None = None,
                  cmvn: str = "utterance", cmvn_norm_var: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, S] waveforms -> ([B, F, num_mel_bins] log-mel feats, [B] lens).

    fp32 regardless of the model's compute dtype. ``cmvn`` is
    ``"utterance"`` or ``"none"``."""
    if cmvn not in ("utterance", "none"):
        raise ValueError(f"cmvn must be 'utterance' or 'none', got {cmvn!r}")
    if params is None:
        params = FbankParams.create()
    feat_lens = frame_lengths(audio_lens)
    feats = fused_log_mel(audio.to(torch.float32).contiguous(), feat_lens,
                          params)
    if cmvn == "utterance":
        feats = apply_cmvn(feats, feat_lens, norm_var=cmvn_norm_var)
    return feats, feat_lens
