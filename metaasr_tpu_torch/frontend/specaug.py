"""SpecAugment, batched on the device (counterpart of
``metaasr_tpu/frontend/specaug.py``).

Split into a draw and an apply: :func:`draw_spec_augment` makes the random
numbers (mask widths and starts, the warp centre and shift) from a
``torch.Generator`` with the reference's distributions;
:func:`apply_spec_augment` applies given draws. A test can therefore feed
the draws ``jax.random`` made and compare with the reference exactly.
Masked regions are set to 0 (the per-utterance CMVN mean). Every draw is
shaped by the batch; with a generator that carries a rank's rows of a
whole batch (``utils.rows``) it is made at the whole batch's rows and cut
to the rank's, so a rank masks its rows as one process would.
"""

from __future__ import annotations

import torch

from metaasr_tpu_torch.utils.rows import draw


def _draw_mask_axis(generator, valid: torch.Tensor, num_masks: int,
                    max_width: torch.Tensor):
    """[B] valid lengths -> (width [B, M], start [B, M]) int64: width ~
    U[0, max_width], start ~ U[0, max(valid - width, 1))."""
    shape = (valid.shape[0], num_masks)
    raw_w = _randint(generator, 0, 1 << 30, shape, valid.device)
    w = raw_w % (torch.clamp_min(max_width.to(torch.int64), 0)[:, None] + 1)
    s_range = torch.clamp_min(valid.to(torch.int64)[:, None] - w, 1)
    raw_s = _randint(generator, 0, 1 << 30, shape, valid.device)
    return w, raw_s % s_range


def _randint(generator, low: int, high: int, shape, dev) -> torch.Tensor:
    return draw(lambda s: torch.randint(low, high, s, generator=generator,
                                        device=dev), shape, generator)


def _keep_mask(length: int, width: torch.Tensor,
               start: torch.Tensor) -> torch.Tensor:
    """(width, start) [B, M] -> [B, length] bool keep-mask (False = masked)."""
    pos = torch.arange(length, device=width.device)[None, None, :]
    masked = (pos >= start[..., None]) & (pos < (start + width)[..., None])
    return ~masked.any(dim=1)


def time_mask_cap(feat_lens: torch.Tensor, time_mask_width: int,
                  time_mask_max_ratio: float) -> torch.Tensor:
    """Per-utterance time-mask width cap: min(width, int(ratio * len))."""
    ratio_cap = (time_mask_max_ratio * feat_lens.to(torch.float32)).to(
        torch.int64)
    return torch.clamp_max(ratio_cap, time_mask_width)


def draw_spec_augment(generator, feats_shape, feat_lens: torch.Tensor,
                      num_freq_masks: int = 2, freq_mask_width: int = 27,
                      num_time_masks: int = 2, time_mask_width: int = 70,
                      time_mask_max_ratio: float = 0.2,
                      time_warp: int = 0) -> dict:
    """Random draws for :func:`apply_spec_augment`: freq/time mask widths
    and starts [B, M] and, with ``time_warp``, the warp centre ``c`` [B]
    (U[W, max(L-W, W+1))) and ``shift`` [B] (U[-W, W]). Drawn on
    ``feat_lens``'s device."""
    bsz, _, d = feats_shape
    dev = feat_lens.device
    draws = {}
    if time_warp:
        lens = feat_lens.to(torch.float32)
        lo = float(time_warp)
        hi = torch.clamp_min(lens - time_warp, lo + 1.0)
        u = draw(lambda s: torch.rand(s, generator=generator, device=dev),
                 (bsz,), generator)
        draws["warp_c"] = lo + u * (hi - lo)
        draws["warp_shift"] = _randint(generator, -time_warp, time_warp + 1,
                                       (bsz,), dev)
    full = torch.full((bsz,), d, dtype=torch.int64, device=dev)
    draws["freq_w"], draws["freq_s"] = _draw_mask_axis(
        generator, full, num_freq_masks,
        torch.full((bsz,), freq_mask_width, dtype=torch.int64, device=dev))
    draws["time_w"], draws["time_s"] = _draw_mask_axis(
        generator, feat_lens, num_time_masks,
        time_mask_cap(feat_lens, time_mask_width, time_mask_max_ratio))
    return draws


def time_warp_apply(feats: torch.Tensor, feat_lens: torch.Tensor,
                    c: torch.Tensor, shift: torch.Tensor,
                    warp: int) -> torch.Tensor:
    """Piecewise-linear resampling of the time axis so frame ``c`` lands at
    ``c + shift``; utterances too short to warp (L <= 2W+2) and padding
    frames pass through unchanged."""
    t_len = feats.shape[1]
    lens = feat_lens.to(torch.float32)
    c = c.to(torch.float32)
    cw = torch.clamp(c + shift.to(torch.float32), min=1.0)
    cw = torch.minimum(cw, torch.clamp_min(lens - 1.0, 1.0))
    t = torch.arange(t_len, dtype=torch.float32, device=feats.device)[None, :]
    src_left = t * (c / cw)[:, None]
    src_right = (c[:, None] + (t - cw[:, None])
                 * ((lens - c) / torch.clamp_min(lens - cw, 1e-3))[:, None])
    src = torch.where(t < cw[:, None], src_left, src_right)
    warpable = (lens > 2.0 * warp + 2.0)[:, None]
    src = torch.where(warpable & (t < lens[:, None]), src, t)
    src = torch.clamp(src, 0.0, float(t_len - 1))
    i0 = torch.floor(src).to(torch.int64)
    i1 = torch.clamp_max(i0 + 1, t_len - 1)
    frac = (src - i0.to(torch.float32))[..., None]
    d = feats.shape[2]
    f0 = torch.gather(feats, 1, i0[..., None].expand(-1, -1, d))
    f1 = torch.gather(feats, 1, i1[..., None].expand(-1, -1, d))
    return f0 * (1.0 - frac) + f1 * frac


def apply_spec_augment(feats: torch.Tensor, feat_lens: torch.Tensor,
                       draws: dict, time_warp: int = 0) -> torch.Tensor:
    """[B, T, D] features + draws -> augmented features."""
    _, t_len, d = feats.shape
    if time_warp:
        feats = time_warp_apply(feats, feat_lens, draws["warp_c"],
                                draws["warp_shift"], time_warp)
    keep_f = _keep_mask(d, draws["freq_w"], draws["freq_s"])
    keep_t = _keep_mask(t_len, draws["time_w"], draws["time_s"])
    keep = keep_t[:, :, None] & keep_f[:, None, :]
    return torch.where(keep, feats, 0.0)


def spec_augment(generator, feats: torch.Tensor, feat_lens: torch.Tensor,
                 num_freq_masks: int = 2, freq_mask_width: int = 27,
                 num_time_masks: int = 2, time_mask_width: int = 70,
                 time_mask_max_ratio: float = 0.2,
                 time_warp: int = 0) -> torch.Tensor:
    """Draw and apply: [B, T, D] log-mel features -> masked features."""
    draws = draw_spec_augment(
        generator, feats.shape, feat_lens, num_freq_masks, freq_mask_width,
        num_time_masks, time_mask_width, time_mask_max_ratio, time_warp)
    return apply_spec_augment(feats, feat_lens, draws, time_warp)
