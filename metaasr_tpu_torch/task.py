"""ASRTask — the bridge between data batches and the differentiable loss
(counterpart of ``metaasr_tpu/train/task.py``).

Everything trainable routes through ``ASRTask.loss_fn(params, batch,
generator, train)``: waveform -> fbank (K1) -> CMVN -> SpecAugment -> model
-> joint CTC/attention loss (transformer) or CTC loss (VGG-BLSTM, whose
recurrences run in K3/K3b, ``ops/lstm_kernel.py``, unless
``model.lstm_impl`` is ``scan``), with the CTC term through K2
(``ops/ctc_kernel.py``; twice differentiable through K2b) or the scan
backend (``model.ctc_impl``). ``params``
is a dict over the model's parameter names; the model runs through
``torch.func.functional_call``, so the meta-learning code adapts plain
tensors. Randomness (dither, SpecAugment, dropout) comes from the caller's
``torch.Generator``.

The features always come from K1 (``frontend.fbank``): the CUDA kernel on
the card, its plain version on the CPU. ``frontend.use_pallas`` is kept in
the config for compatibility and not read.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.decode.greedy import ctc_greedy_decode
from metaasr_tpu_torch.device import resolve_device
from metaasr_tpu_torch.frontend.fbank import FbankParams, log_mel_fbank
from metaasr_tpu_torch.frontend.specaug import spec_augment
from metaasr_tpu_torch.models.losses import (
    batch_mean,
    joint_ctc_attention_loss,
    prepare_decoder_targets,
    whole_counts,
)
from metaasr_tpu_torch.models.transformer import TransformerASR
from metaasr_tpu_torch.models.vgg_blstm import VGGBLSTMCTC
from metaasr_tpu_torch.ops.ctc import ctc_loss
from metaasr_tpu_torch.ops.ctc_kernel import ctc_loss_kernel
from metaasr_tpu_torch.utils.padding import make_non_pad_mask
from metaasr_tpu_torch.utils.rows import draw
from metaasr_tpu_torch.weights import random_state_dict

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def select_ctc_loss(impl: str):
    """'auto' | 'pallas' -> K2's loss (the kernel on CUDA tensors, its plain
    version on CPU tensors); 'scan' -> the autograd recursion."""
    if impl not in ("auto", "pallas", "scan"):
        raise ValueError(f"unknown ctc_impl {impl!r}")
    return ctc_loss if impl == "scan" else ctc_loss_kernel


def build_model(cfg: Config) -> TransformerASR | VGGBLSTMCTC:
    """The port's model for ``cfg.model`` (randomly initialised; load
    weights with ``weights.flax_to_state_dict``)."""
    m = cfg.model
    if m.arch == "vgg_blstm":
        return VGGBLSTMCTC(vocab_size=m.vocab_size,
                           blstm_hidden=m.blstm_hidden,
                           blstm_layers=m.blstm_layers,
                           vgg_channels=tuple(m.vgg_channels),
                           feat_dim=cfg.frontend.num_mel_bins,
                           dtype=_DTYPES[m.dtype], lstm_impl=m.lstm_impl)
    if m.arch != "transformer":
        raise ValueError(f"unknown arch {m.arch}")
    return TransformerASR(vocab_size=m.vocab_size, d_model=m.d_model,
                          num_heads=m.num_heads, d_ff=m.d_ff,
                          num_encoder_layers=m.num_encoder_layers,
                          num_decoder_layers=m.num_decoder_layers,
                          feat_dim=cfg.frontend.num_mel_bins,
                          dtype=_DTYPES[m.dtype], dropout=m.dropout,
                          encoder_type=m.encoder,
                          conformer_kernel=m.conformer_kernel)


class ASRTask:
    """Front-end, model and loss on one device."""

    def __init__(self, cfg: Config, sos_eos_id: int | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.arch = cfg.model.arch
        self._ctc_loss = select_ctc_loss(cfg.model.ctc_impl)
        self._module = None
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

    def build_model(self):
        return build_model(self.cfg).to(self.device).eval()

    def require_full_autodiff(self) -> None:
        """Make every op of the loss twice differentiable (second-order
        MAML differentiates through the loss gradient). The CTC Functions
        are (their second order is K2b); K3b's Function is first order only,
        so the BLSTM switches to the autograd loop."""
        if self.arch == "vgg_blstm" and self.cfg.model.lstm_impl != "scan":
            self.cfg.model.lstm_impl = "scan"
            self._module = None

    @property
    def model(self):
        """The module ``loss_fn`` calls functionally (its own parameters are
        never read: ``params`` replace them)."""
        if self._module is None:
            self._module = self.build_model()
        return self._module

    def init_params(self, seed: int) -> dict[str, torch.Tensor]:
        """Seeded fp32 parameters on the task's device (numpy RNG, see
        ``weights.random_state_dict``)."""
        sd = random_state_dict(self.model, seed)
        return {k: v.to(self.device) for k, v in sd.items()}

    def features(self, audio, audio_lens, cmvn_mean=None, cmvn_std=None, *,
                 generator: torch.Generator | None = None,
                 train: bool = False):
        """[B, S] audio -> ([B, F, D] features, [B] int32 lengths) under the
        configured CMVN: utterance, none, global (corpus stats) or speaker
        (per-row mean/std; without them, utterance). With ``train`` and a
        generator: dither before K1 and SpecAugment after CMVN."""
        f = self.cfg.frontend
        if train and f.dither and generator is not None:
            audio = audio + f.dither * draw(
                lambda s: torch.randn(s, generator=generator,
                                      device=audio.device),
                audio.shape, generator)
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
        return self._maybe_specaug(feats, feat_lens, generator, train), \
            feat_lens

    def _maybe_specaug(self, feats, feat_lens, generator, train: bool):
        if train and self.cfg.specaug.enabled and generator is not None:
            sa = self.cfg.specaug
            feats = spec_augment(
                generator, feats, feat_lens,
                num_freq_masks=sa.num_freq_masks,
                freq_mask_width=sa.freq_mask_width,
                num_time_masks=sa.num_time_masks,
                time_mask_width=sa.time_mask_width,
                time_mask_max_ratio=sa.time_mask_max_ratio,
                time_warp=sa.time_warp)
        return feats

    def _raw_fbank(self, audio, audio_lens, cmvn: str):
        return log_mel_fbank(audio, audio_lens, self.fbank_params, cmvn=cmvn,
                             cmvn_norm_var=self.cfg.frontend.cmvn_norm_var)

    def preprocess(self, batch: dict, generator=None,
                   train: bool = False) -> dict:
        """Audio batch -> feature batch (fbank + CMVN + SpecAugment). In
        meta-training this runs once per task batch, outside the inner
        loop. Feature batches pass through (SpecAugment still applies in
        training). A rank's share of a batch keeps its
        ``whole_token_lens`` for the loss."""
        if "feats" in batch:
            feats = self._maybe_specaug(batch["feats"], batch["feat_lens"],
                                        generator, train)
            feat_lens = batch["feat_lens"]
        else:
            feats, feat_lens = self.features(
                batch["audio"], batch["audio_lens"], batch.get("cmvn_mean"),
                batch.get("cmvn_std"), generator=generator, train=train)
        out = {"feats": feats, "feat_lens": feat_lens,
               "tokens": batch["tokens"], "token_lens": batch["token_lens"]}
        if "whole_token_lens" in batch:
            out["whole_token_lens"] = batch["whole_token_lens"]
        return out

    def loss_fn(self, params: dict, batch: dict, generator=None,
                train: bool = False):
        """-> (scalar loss, metrics). Differentiable w.r.t. ``params``.
        Takes raw-audio batches (features computed inline) or feature
        batches (key 'feats', used as they are: augmentation is
        ``preprocess``'s job). A batch with ``whole_token_lens`` is a
        rank's share of a task's shots: its loss divides by the whole
        batch's rows and tokens, so the ranks' losses add up to one
        process's, and its generator carries its rows (``utils.rows``)."""
        if train and generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        if "feats" in batch:
            feats, feat_lens = batch["feats"], batch["feat_lens"]
        else:
            feats, feat_lens = self.features(
                batch["audio"], batch["audio_lens"], batch.get("cmvn_mean"),
                batch.get("cmvn_std"), generator=generator, train=train)
        tokens, token_lens = batch["tokens"], batch["token_lens"]
        whole = whole_counts(batch)
        if self.arch == "vgg_blstm":
            logits, out_lens = torch.func.functional_call(
                self.model, params, (feats, feat_lens), {"train": train})
            lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            loss = batch_mean(self._ctc_loss(lp, out_lens, tokens,
                                             token_lens), whole)
            return loss, {"loss": loss, "ctc_loss": loss}
        tokens_in, _, _ = prepare_decoder_targets(
            tokens.to(torch.int64), token_lens, self.sos_eos_id)
        outputs = torch.func.functional_call(
            self.model, params, (feats, feat_lens, tokens_in, token_lens + 1),
            {"train": train, "generator": generator})
        m = self.cfg.model
        return joint_ctc_attention_loss(
            outputs, tokens, token_lens, self.sos_eos_id,
            ctc_weight=m.ctc_weight, label_smoothing=m.label_smoothing,
            ctc_loss_fn=self._ctc_loss, whole=whole)

    # ---------- greedy CTC decode (beam search lives in decode/) ----------

    @staticmethod
    def _greedy_from_feats(model, feats, feat_lens):
        logits, out_lens = model.ctc_logits_only(feats, feat_lens)
        return ctc_greedy_decode(logits, out_lens)

    def _ctc_logits(self, params: dict, feats, feat_lens):
        """CTC logits and lengths with ``params`` in place of the module's
        own (the encoder and head alone for the transformer)."""
        call = torch.func.functional_call
        if self.arch == "vgg_blstm":
            return call(self.model, params, (feats, feat_lens))

        def sub(prefix: str) -> dict:
            return {k[len(prefix):]: v for k, v in params.items()
                    if k.startswith(prefix)}

        enc, enc_lens = call(self.model.encoder, sub("encoder."),
                             (feats, feat_lens))
        return call(self.model.ctc_head, sub("ctc_head."), (enc,)), enc_lens

    def greedy_ctc_feats(self, params: dict, feats, feat_lens):
        """Greedy CTC on features -> (packed ids [B, T'], lens [B])."""
        with torch.no_grad():
            logits, out_lens = self._ctc_logits(params, feats, feat_lens)
            return ctc_greedy_decode(logits, out_lens)

    def greedy_ctc(self, params: dict, audio, audio_lens, cmvn_mean=None,
                   cmvn_std=None):
        """Greedy CTC on raw audio (features through K1, no augmentation)."""
        with torch.no_grad():
            feats, feat_lens = self.features(audio, audio_lens, cmvn_mean,
                                             cmvn_std)
        return self.greedy_ctc_feats(params, feats, feat_lens)

    def greedy_batch(self, params: dict, batch: dict):
        """Greedy CTC on a collated device batch, either payload mode."""
        if "feats" in batch:
            return self.greedy_ctc_feats(params, batch["feats"],
                                         batch["feat_lens"])
        return self.greedy_ctc(params, batch["audio"], batch["audio_lens"],
                               batch.get("cmvn_mean"), batch.get("cmvn_std"))
