"""Serving bundles: write them, read them and transcribe (counterpart of
``metaasr_tpu/serve/export.py``).

A bundle directory holds ``params.npz`` (flat ``a/b/c`` keys; bf16 leaves
stored as uint16 bit patterns listed under ``__bf16_keys__``),
``tokenizer.json`` and ``meta.json``. The JAX package also writes one
StableHLO program per bucket (``*.jexp``); the port ignores those and runs
its own modules, the fbank kernel included.

:func:`write_bundle` writes the same non-program files, so a bundle the
port writes loads in either package's reader. A bundle with a
shallow-fusion LM carries the LM's Flax-layout leaves under ``__lm__/...``
in ``params.npz`` (cast like the model's in a bf16 bundle) and
``has_lm: true``, as the reference's do. Its ``meta.json`` also
records the model dims and dtype (``model``), the front-end (``frontend``:
CMVN mode, mel bins, sample rate; global CMVN statistics are copied into
the bundle) and every beam option, so :class:`ServingDecoder` needs no
config for it. The JAX package's bundles keep those in their programs, so
they are served with the run's ``Config`` (``--config``).

:func:`decode_features` and :func:`read_decoded` are the decode and the
read-back that serving and the meta trainer's ``decode`` share;
:func:`pack_decode_outputs` / :func:`unpack_decode_outputs` fold a decode's
outputs into one int32 tensor so that its read-back is one copy to the host.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Sequence

import numpy as np
import torch

from metaasr_tpu_torch.config import Config
from metaasr_tpu_torch.data.bpe import BPETokenizer
from metaasr_tpu_torch.data.tokenizer import _BaseTokenizer
from metaasr_tpu_torch.decode.beam_search import (
    BeamSearchConfig,
    beam_search_transformer,
)
from metaasr_tpu_torch.models.lm import lm_from_flax
from metaasr_tpu_torch.task import ASRTask
from metaasr_tpu_torch.weights import (
    LM_KEY,
    flatten_tree,
    flax_to_state_dict,
    split_lm,
    unflatten,
)

BUNDLE_VERSION = 2
COMPATIBLE_BUNDLE_VERSIONS = (1, 2)


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """Round to nearest even, as a cast to bfloat16 does."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def round_to_bf16(a: np.ndarray) -> np.ndarray:
    """fp32 array of the bf16 values nearest to ``a``."""
    return _bf16_bits_to_f32(_f32_to_bf16_bits(a))


def load_bundle_params(path: str) -> dict:
    """params.npz (or any flat ``a/b/c`` params npz, such as the JAX
    package's ``save_params_npz`` output) -> nested dict of numpy arrays;
    bf16 leaves come back as float32 arrays holding the bf16 values."""
    out: dict = {}
    with np.load(path) as z:
        bf16 = set(np.asarray(z["__bf16_keys__"]).tolist()) \
            if "__bf16_keys__" in z.files else set()
        for key in z.files:
            if key == "__bf16_keys__":
                continue
            a = np.asarray(z[key])
            if key in bf16:
                a = _bf16_bits_to_f32(a)
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = a
    return out


def beam_config_from_train(cfg, lm_active: bool = False) -> BeamSearchConfig:
    """The joint beam search's options from ``cfg.train`` (max_len from
    ``cfg.data.max_tokens``), as the reference's decode and export build
    them; ``train.lm_weight`` goes in only when an LM is active."""
    t = cfg.train
    return BeamSearchConfig(
        beam_size=t.beam_size, max_len=cfg.data.max_tokens,
        ctc_weight=t.decode_ctc_weight, length_penalty=t.length_penalty,
        ctc_candidates=t.ctc_candidates, normalize_final=t.normalize_final,
        coverage_weight=t.coverage_weight, coverage_tau=t.coverage_tau,
        min_len=t.beam_min_len,
        lm_weight=t.lm_weight if lm_active else 0.0)


# runtime backends, chosen by whoever serves (ASRTask.require_full_autodiff
# switches lstm_impl for MAML training): not part of the recorded model
_UNRECORDED_MODEL_KEYS = ("ctc_impl", "lstm_impl")
_GLOBAL_CMVN_FILE = "cmvn_stats.json"


def write_bundle(out_dir: str, cfg, params, tokenizer: _BaseTokenizer,
                 buckets: Sequence[tuple[int, int]],
                 weights_dtype: str = "float32",
                 mode: str | None = None, lm_params=None,
                 from_feats: bool = False) -> dict:
    """Write params.npz, tokenizer.json and meta.json for a Flax-layout
    params tree (no programs: ``files`` is empty). ``mode`` is the decode
    algorithm, "beam" or "greedy"; None picks beam for the transformer and
    greedy for the CTC-only VGG-BLSTM. ``lm_params``, a Flax-layout LM
    tree, is fused (stored under ``__lm__``) when ``train.lm_weight`` is
    not 0. ``from_feats``: the bundle takes [T, num_mel_bins] features in
    place of waveforms, and its buckets are (batch, frames). Returns the
    manifest."""
    if mode is None:
        mode = "beam" if cfg.model.arch == "transformer" else "greedy"
    if mode == "greedy" and lm_params is not None:
        raise ValueError("shallow fusion needs the beam search; greedy "
                         "export does not take an LM")
    _check_mode(mode, cfg.model.arch)
    if weights_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"weights_dtype must be float32 or bfloat16, "
                         f"got {weights_dtype!r}")
    has_lm = lm_params is not None and cfg.train.lm_weight != 0.0
    beam = beam_config_from_train(cfg, lm_active=has_lm)
    os.makedirs(out_dir, exist_ok=True)
    flat = flatten_tree(params)
    if has_lm:
        flat.update(flatten_tree(lm_params, LM_KEY))
    arrays, bf16_keys = {}, []
    for key, a in flat.items():
        if weights_dtype == "bfloat16" and a.dtype.kind == "f":
            a = _f32_to_bf16_bits(a)
            bf16_keys.append(key)
        arrays[key] = a
    arrays["__bf16_keys__"] = np.asarray(bf16_keys, dtype=np.str_)
    np.savez(os.path.join(out_dir, "params.npz"), **arrays)
    tokenizer.save(os.path.join(out_dir, "tokenizer.json"))
    model = {k: v for k, v in dataclasses.asdict(cfg.model).items()
             if k not in _UNRECORDED_MODEL_KEYS}
    frontend = dataclasses.asdict(cfg.frontend)
    if cfg.frontend.cmvn == "global":
        shutil.copyfile(cfg.frontend.cmvn_stats_path,
                        os.path.join(out_dir, _GLOBAL_CMVN_FILE))
        frontend["cmvn_stats_path"] = _GLOBAL_CMVN_FILE
    manifest = {
        "version": BUNDLE_VERSION,
        "buckets": [list(b) for b in buckets],
        "platforms": [],
        "from_feats": from_feats,
        "mode": mode,
        "packed": True,
        "weights_dtype": weights_dtype,
        "files": {},
        "vocab_kind": cfg.data.vocab,
        "vocab_size": tokenizer.vocab_size,
        "sos_eos_id": tokenizer.sos_eos_id,
        "sample_rate": cfg.frontend.sample_rate,
        "num_mel_bins": cfg.frontend.num_mel_bins,
        "has_lm": has_lm,
        "beam": dataclasses.asdict(beam),
        "model": model,
        "frontend": frontend,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def bundle_config(bundle_dir: str, meta: dict, cfg=None) -> Config:
    """The config a bundle serves under: ``cfg`` (or, for a bundle that
    records its model, the defaults) with every value the bundle records
    laid over it."""
    if cfg is None:
        if "model" not in meta:
            raise ValueError(
                f"the bundle {bundle_dir} does not record its model dims "
                "(the JAX package's bundles, and the port's written before "
                "they did, keep them in their programs): serve it with its "
                "run's config (--config, or ServingDecoder(bundle, cfg))")
        cfg = Config()
    cfg = copy.deepcopy(cfg)
    for section in ("model", "frontend"):
        for k, v in meta.get(section, {}).items():
            setattr(getattr(cfg, section), k,
                    tuple(v) if isinstance(v, list) else v)
    f = cfg.frontend
    if "frontend" in meta and f.cmvn == "global":
        f.cmvn_stats_path = os.path.join(bundle_dir, f.cmvn_stats_path)
    cfg.model.vocab_size = meta["vocab_size"]
    f.num_mel_bins = meta["num_mel_bins"]
    f.sample_rate = meta["sample_rate"]
    return cfg


def _check_mode(mode: str, arch: str) -> None:
    if mode not in ("beam", "greedy"):
        raise ValueError(f"decode mode must be beam or greedy, got {mode!r}")
    if mode == "beam" and arch != "transformer":
        raise ValueError(f"arch {arch!r} has no attention decoder: its "
                         "bundles decode greedily (mode='greedy')")


def _load_tokenizer(bundle_dir: str, kind: str):
    """The bundle's ``tokenizer.json`` by the vocabulary kind its
    ``meta.json`` records, as the reference's ``_load_tokenizer`` reads it."""
    path = os.path.join(bundle_dir, "tokenizer.json")
    if kind == "bpe":
        return BPETokenizer.load(path)
    return _BaseTokenizer.load(path)  # dispatches on the recorded type


class ServingDecoder:
    """Load a bundle and transcribe on one device.

    ``transcribe`` pads each request to the smallest bucket that fits,
    runs fbank (K1) -> CMVN -> encoder -> CTC head -> joint beam search
    (or greedy CTC for a greedy bundle; the VGG-BLSTM's recurrences go
    through K3) and detokenizes. A bundle marked ``has_lm`` fuses its LM
    into the search. ``params`` hot-swaps an adapted Flax-layout tree; a
    tree without ``__lm__`` leaves is served with the bundle's LM; the
    converted modules are cached for the last tree object passed. ``cfg``,
    the run's config, is needed only for a bundle that does not record its
    own (the JAX package's); what a bundle records overrides it.
    """

    def __init__(self, bundle_dir: str, cfg=None, device=None):
        with open(os.path.join(bundle_dir, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta["version"] not in COMPATIBLE_BUNDLE_VERSIONS:
            raise ValueError(
                f"bundle version {self.meta['version']} not in "
                f"{COMPATIBLE_BUNDLE_VERSIONS}")
        beam = self.meta["beam"]
        self.tokenizer = _load_tokenizer(bundle_dir, self.meta["vocab_kind"])
        cfg = bundle_config(bundle_dir, self.meta, cfg)
        self.cfg = cfg
        self.task = ASRTask(cfg, self.meta["sos_eos_id"], device=device)
        self.device = self.task.device
        self.weights_dtype = self.meta.get("weights_dtype", "float32")
        self.from_feats = self.meta["from_feats"]
        self.mode = self.meta["mode"]
        _check_mode(self.mode, cfg.model.arch)
        # the options a bundle does not record come from the config
        self.beam_cfg = dataclasses.replace(beam_config_from_train(cfg),
                                            **beam)
        self.buckets = sorted(tuple(int(v) for v in b)
                              for b in self.meta["buckets"])
        tree, lm_tree = split_lm(load_bundle_params(
            os.path.join(bundle_dir, "params.npz")))
        self.lm = None
        if self.meta["has_lm"]:
            if lm_tree is None:
                raise ValueError(f"the bundle {bundle_dir} is marked has_lm "
                                 "but its params.npz holds no __lm__ leaves")
            self.lm = self._build_lm(lm_tree)
        self.model = self._build_model(tree)
        self._swap_cache = None
        self._swap_lock = threading.Lock()

    def _build_model(self, tree):
        sd = flax_to_state_dict(tree)
        if self.weights_dtype == "bfloat16":
            # the bundle's program takes bf16 weights: round hot-swapped
            # fp32 trees the same way (a no-op for the bundle's own leaves)
            sd = {k: torch.from_numpy(round_to_bf16(v.numpy()))
                  for k, v in sd.items()}
        model = self.task.build_model()
        model.load_state_dict(sd)
        return model

    def _build_lm(self, tree):
        """The fused LM on the serving device; a bf16 bundle's LM leaves
        are bf16 values, and a hot-swapped LM is rounded the same way. It
        computes in fp32."""
        if self.weights_dtype == "bfloat16":
            tree = unflatten({k: round_to_bf16(a)
                              for k, a in flatten_tree(tree).items()})
        return lm_from_flax(tree, self.device)

    def _pick_bucket(self, n: int, width: int):
        fits = [b for b in self.buckets if b[0] >= n and b[1] >= width]
        if not fits:
            raise ValueError(
                f"request ({n} utts, width {width}) exceeds every exported "
                f"bucket {self.buckets}")
        return min(fits, key=lambda b: (b[0] * b[1], b))

    def _resolve_params(self, params):
        """(model, LM) for a caller's tree; a tree without ``__lm__`` leaves
        keeps the bundle's LM. The single-entry cache keys on object
        identity: treat a tree as immutable once passed."""
        if params is None:
            return self.model, self.lm
        with self._swap_lock:
            if self._swap_cache is not None and self._swap_cache[0] is params:
                return self._swap_cache[1]
            tree, lm_tree = split_lm(params)
            built = (self._build_model(tree),
                     self.lm if lm_tree is None else self._build_lm(lm_tree))
            self._swap_cache = (params, built)  # holds params: id stays live
            return built

    def transcribe(self, xs: Sequence[np.ndarray], params: Any = None,
                   nbest: int = 1) -> list[dict]:
        """xs: 1-D float32 waveforms (audio mode) or [T, D] features (feats
        mode). Returns one {"text", "score"} (+ "nbest") dict per input."""
        out, n = self._dispatch(xs, params)
        return self._read(out, n, nbest)

    def transcribe_files(self, paths: Sequence[str], params: Any = None,
                         nbest: int = 1) -> list[dict]:
        if self.from_feats:
            raise ValueError("transcribe_files needs an audio-mode bundle "
                             "(this one was exported from_feats=True)")
        from metaasr_tpu_torch.data.audio_io import load_wav

        rate = self.meta["sample_rate"]
        return self.transcribe([load_wav(p, target_rate=rate)
                                for p in paths], params=params, nbest=nbest)

    def transcribe_stream(self, requests, params: Any = None,
                          nbest: int = 1):
        """``requests``: iterable of wave lists. Every batch is dispatched
        before any result is read; yields one result list per batch, in
        order."""
        pending = [self._dispatch(xs, params) for xs in requests]
        for out, n in pending:
            yield self._read(out, n, nbest)

    def _stage(self, xs, params):
        """Pad one request to its bucket and copy it to the device."""
        n = len(xs)
        widths = [int(np.shape(x)[0]) for x in xs]
        bsz, width = self._pick_bucket(n, max(widths))
        if self.from_feats:
            x = np.zeros((bsz, width, self.meta["num_mel_bins"]), np.float32)
        else:
            x = np.zeros((bsz, width), np.float32)
        for i, item in enumerate(xs):
            x[i, : widths[i]] = np.asarray(item, np.float32)
        lens = np.asarray(widths + [widths[-1]] * (bsz - n), np.int32)
        # pad rows repeat the last real utterance (never a zero-length row:
        # framing needs one full window); _read drops their outputs
        for j in range(n, bsz):
            x[j] = x[n - 1]
        modules = self._resolve_params(params)
        return ((bsz, width), modules,
                torch.from_numpy(x).to(self.device),
                torch.from_numpy(lens).to(self.device), n)

    def _dispatch_staged(self, staged):
        """Run the decode on staged inputs -> (outputs on the device, n)."""
        _, (model, lm), x, lens, n = staged
        with torch.inference_mode():
            if self.from_feats:
                feats, feat_lens = x, lens
            else:
                feats, feat_lens = self.task.features(x, lens)
            out = decode_features(self.task, model, feats, feat_lens,
                                  self.mode, self.beam_cfg, lm)
        return out, n

    def _dispatch(self, xs, params):
        return self._dispatch_staged(self._stage(xs, params))

    def _read(self, out, n: int, nbest: int):
        return read_decoded(out, n, self.tokenizer, nbest)


def decode_features(task: ASRTask, model, feats, feat_lens, mode: str,
                    beam_cfg: BeamSearchConfig, lm=None) -> dict:
    """Greedy CTC (``mode="greedy"``) or the joint beam search of ``model``
    (with ``lm``, an ``LSTMLM``, fused when ``beam_cfg.lm_weight`` is not 0)
    on features -> {"tokens" [B, K, L], "lengths" [B, K], "scores" [B, K]}
    on the device, K = 1 for greedy (scores 0)."""
    with torch.inference_mode():
        if mode == "greedy":
            packed, out_lens = task._greedy_from_feats(model, feats,
                                                       feat_lens)
            return {"tokens": packed[:, None, :],
                    "lengths": out_lens[:, None],
                    "scores": torch.zeros_like(out_lens,
                                               dtype=torch.float32)[:, None]}
        return beam_search_transformer(model, feats, feat_lens,
                                       task.sos_eos_id, beam_cfg,
                                       lm_model=lm)


def pack_decode_outputs(out: dict) -> torch.Tensor:
    """{tokens [B, K, L], lengths [B, K], scores [B, K] fp32} on the device
    -> one [B, K, L + 2] int32 tensor on the same device: the tokens, the
    lengths, and the scores' fp32 bits viewed as int32."""
    tokens = out["tokens"].to(torch.int32)
    lengths = out["lengths"].to(torch.int32)[:, :, None]
    scores = out["scores"].float().view(torch.int32)[:, :, None]
    return torch.cat([tokens, lengths, scores], dim=2)


def unpack_decode_outputs(packed) -> dict:
    """Inverse of :func:`pack_decode_outputs` on the host: a tensor on any
    device (one copy to the host) or a numpy array -> numpy {tokens,
    lengths, scores (float32)}."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    return {"tokens": packed[:, :, :-2],
            "lengths": packed[:, :, -2],
            "scores": packed[:, :, -1].view(np.float32)}


def read_decoded(out: dict, n: int, tokenizer, nbest: int = 1) -> list[dict]:
    """Read back the first ``n`` rows of :func:`decode_features`' outputs ->
    one {"text", "score"} dict per row, plus "nbest": [{"hyp", "score"},
    ...] when ``nbest`` > 1."""
    toks = out["tokens"].cpu().numpy()
    lengths = out["lengths"].cpu().numpy()
    scores = out["scores"].float().cpu().numpy()
    results = []
    k = min(max(1, nbest), toks.shape[1])
    for i in range(n):
        r = {"text": tokenizer.decode(toks[i, 0, : lengths[i, 0]]),
             "score": float(scores[i, 0])}
        if k > 1:
            r["nbest"] = [
                {"hyp": tokenizer.decode(toks[i, j, : lengths[i, j]]),
                 "score": float(scores[i, j])} for j in range(k)]
        results.append(r)
    return results
