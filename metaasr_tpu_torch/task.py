"""ASRTask — front-end and model construction for decoding (counterpart of
``metaasr_tpu/train/task.py``: ``features``, ``_raw_fbank``, ``build_model``
and ``_greedy_from_feats``). SpecAugment and the losses belong to the
training slice and are not here.

The features always come from K1 (``frontend.fbank``): the CUDA kernel on
the card, its plain version on the CPU. ``frontend.use_pallas`` is kept in
the config for compatibility and not read.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.device import resolve_device
from metaasr_tpu_torch.frontend.fbank import FbankParams, log_mel_fbank
from metaasr_tpu_torch.models.transformer import TransformerASR
from metaasr_tpu_torch.utils.padding import make_non_pad_mask

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(cfg: Config) -> TransformerASR:
    """The port's model for ``cfg.model`` (randomly initialised; load
    weights with ``weights.flax_to_state_dict``)."""
    m = cfg.model
    if m.arch != "transformer" or m.encoder != "transformer":
        raise NotImplementedError(
            f"arch={m.arch!r} encoder={m.encoder!r} is not ported yet "
            "(ROADMAP.md, port queue); the port has the transformer "
            "joint CTC/attention model")
    return TransformerASR(vocab_size=m.vocab_size, d_model=m.d_model,
                          num_heads=m.num_heads, d_ff=m.d_ff,
                          num_encoder_layers=m.num_encoder_layers,
                          num_decoder_layers=m.num_decoder_layers,
                          feat_dim=cfg.frontend.num_mel_bins,
                          dtype=_DTYPES[m.dtype])


class ASRTask:
    """Front-end (fbank + CMVN) and model factory on one device."""

    def __init__(self, cfg: Config, sos_eos_id: int | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.sos_eos_id = (sos_eos_id if sos_eos_id is not None
                           else cfg.model.vocab_size - 1)
        f = cfg.frontend
        self.fbank_params = FbankParams.create(
            num_mel_bins=f.num_mel_bins, preemphasis=f.preemphasis,
            remove_dc_offset=f.remove_dc_offset, low_freq=f.low_freq,
            high_freq=f.high_freq, sample_rate=f.sample_rate)
        self._global_cmvn = None
        if f.cmvn == "global":
            with open(f.cmvn_stats_path) as fh:
                stats = json.load(fh)
            mean = np.asarray(stats["mean"], np.float32)
            std = np.sqrt(np.asarray(stats["var"], np.float32) + 1e-10)
            self._global_cmvn = (torch.from_numpy(mean).to(self.device),
                                 torch.from_numpy(std).to(self.device))

    def build_model(self) -> TransformerASR:
        return build_model(self.cfg).to(self.device).eval()

    def features(self, audio, audio_lens, cmvn_mean=None, cmvn_std=None):
        """[B, S] audio -> ([B, F, D] features, [B] int32 lengths) under the
        configured CMVN: utterance, none, global (corpus stats) or speaker
        (per-row mean/std; without them, utterance)."""
        f = self.cfg.frontend
        if f.cmvn == "speaker" and cmvn_mean is not None:
            feats, feat_lens = self._raw_fbank(audio, audio_lens, "none")
            mask = make_non_pad_mask(feat_lens, feats.shape[1])[..., None]
            feats = torch.where(
                mask, (feats - cmvn_mean[:, None, :]) / cmvn_std[:, None, :],
                0.0)
        elif f.cmvn == "global":
            feats, feat_lens = self._raw_fbank(audio, audio_lens, "none")
            mean, std = self._global_cmvn
            mask = make_non_pad_mask(feat_lens, feats.shape[1])[..., None]
            feats = torch.where(mask, (feats - mean) / std, 0.0)
        else:
            cm = "utterance" if f.cmvn == "speaker" else f.cmvn
            feats, feat_lens = self._raw_fbank(audio, audio_lens, cm)
        return feats, feat_lens

    def _raw_fbank(self, audio, audio_lens, cmvn: str):
        return log_mel_fbank(audio, audio_lens, self.fbank_params, cmvn=cmvn,
                             cmvn_norm_var=self.cfg.frontend.cmvn_norm_var)

    @staticmethod
    def _greedy_from_feats(model: TransformerASR, feats, feat_lens):
        from metaasr_tpu_torch.decode.greedy import ctc_greedy_decode

        logits, out_lens = model.ctc_logits_only(feats, feat_lens)
        return ctc_greedy_decode(logits, out_lens)
