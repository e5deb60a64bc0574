"""Experiment configuration.

The reference drives experiments from YAML configs plus argparse overrides
(R: config/*.yaml, SURVEY.md section 2.1 #2): model dims, optimizer, meta
params (inner-lr, inner-steps, k-shot, tasks-per-batch). Here the same idea
as typed dataclasses; ``load_config``/``save_config`` round-trip YAML, and
dotted-key overrides mirror the reference's CLI overrides.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

from metaasr_tpu_torch import constants


@dataclass
class FrontendConfig:
    sample_rate: int = constants.SAMPLE_RATE
    frame_length_ms: float = constants.FRAME_LENGTH_MS
    frame_shift_ms: float = constants.FRAME_SHIFT_MS
    n_fft: int = constants.N_FFT
    num_mel_bins: int = constants.FEAT_DIM
    low_freq: float = constants.MEL_LOW_FREQ
    high_freq: float = constants.MEL_HIGH_FREQ
    preemphasis: float = constants.PREEMPHASIS
    dither: float = 0.0          # pinned to 0 for bit-comparable tests
    remove_dc_offset: bool = True
    window: str = "povey"
    cmvn: str = "utterance"      # "utterance" | "global" | "none"
    cmvn_norm_var: bool = False
    # for cmvn="global": stats json from scripts/prepare_data.py features
    cmvn_stats_path: str = ""
    use_pallas: bool = True      # the reference's kernel switch; the port
                                 # always runs K1 (plain version on the CPU)


@dataclass
class SpecAugmentConfig:
    enabled: bool = True
    num_freq_masks: int = 2
    freq_mask_width: int = 27
    num_time_masks: int = 2
    time_mask_width: int = 70
    time_mask_max_ratio: float = 0.2  # cap mask at ratio * valid length
    # time-warp window W (SURVEY.md section 2.1 #17: W≈5, often disabled);
    # 0 = off
    time_warp: int = 0


@dataclass
class ModelConfig:
    arch: str = "transformer"  # "transformer" | "vgg_blstm"
    # encoder for arch=transformer: "transformer" | "conformer" (macaron
    # FFN + rel-pos attention + depthwise-conv module; models/conformer.py).
    # "conformer" is experimental in the reference (RESULTS.md): its
    # meta-training needs meta.adapt_filter=decoder (ANIL-decoder)
    encoder: str = "transformer"
    conformer_kernel: int = 15  # depthwise-conv kernel width
    feat_dim: int = constants.FEAT_DIM
    vocab_size: int = 30
    # transformer (ESPnet-lineage dims, SURVEY.md section 2.1 #9)
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 2048
    num_encoder_layers: int = 12
    num_decoder_layers: int = 6
    dropout: float = 0.1
    # vgg_blstm (SURVEY.md section 2.1 #8)
    blstm_hidden: int = 320
    blstm_layers: int = 4
    vgg_channels: tuple = (64, 128)
    # joint loss (SURVEY.md section 3.2)
    ctc_weight: float = 0.3
    label_smoothing: float = 0.1
    dtype: str = "bfloat16"  # compute dtype; params stay fp32
    # the reference's CTC loss backend (kept so the YAML configs load)
    ctc_impl: str = "auto"
    # the reference's LSTM backend for vgg_blstm (kept so the YAML
    # configs load)
    lstm_impl: str = "auto"


@dataclass
class OptimizerConfig:
    name: str = "adam"
    lr: float = 1e-3
    warmup_steps: int = 4000       # Noam-style warmup for transformer
    schedule: str = "noam"         # "noam" | "constant"
    grad_clip: float = 5.0
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.98
    adam_eps: float = 1e-9


@dataclass
class MetaConfig:
    algo: str = "fomaml"           # "no" | "multi" | "fomaml" | "maml" | "reptile"
    inner_lr: float = 1e-2
    inner_steps: int = 3
    k_support: int = 4             # utterances per inner (support) batch
    k_query: int = 4               # utterances per query batch
    tasks_per_batch: int = 4       # accents per meta-batch
    adapt_steps: int = 5           # k-shot adaptation steps at meta-test
    remat_inner: bool = True       # checkpoint each inner step (MAML memory)
    unroll_inner: bool = True      # unroll the inner loop
    grad_dtype: str = "float32"    # "bfloat16": run the whole meta-step
                                   # (fast weights + outer backward) in bf16,
                                   # converting to the fp32 masters once per
                                   # leaf; config3 sets it
    learn_inner_lr: bool = False   # Meta-SGD / MAML++-LSLR: learn one inner
                                   # rate per parameter tensor in the outer
                                   # loop (meta/maml.py MetaAlgoConfig
                                   # .learn_inner_lr); fomaml/maml only.
    inner_clip: float = 0.0        # global-norm clip on the inner-loop
                                   # gradient (0 = off); see meta/maml.py
                                   # MetaAlgoConfig.inner_clip — stabilizes
                                   # encoders whose support gradients are
                                   # large at the meta-point (conformer).
    inner_start_step: int = 0      # inner-loop gating: the inner SGD loop
                                   # is a no-op (scale 0) until this outer
                                   # step, then turns on at full inner_lr.
                                   # FOMAML before the gate reduces exactly
                                   # to query-batch training — lets an
                                   # encoder whose inner loop is chaotic at
                                   # init (conformer; docs/DESIGN.md sec. 8)
                                   # organize BEFORE adaptation engages.
                                   # 0 = inner loop always on. fomaml/maml.
    adapt_filter: str = ""         # ANIL partial inner adaptation: comma-
                                   # separated substrings of param paths the
                                   # inner loop may update ("" = all params;
                                   # e.g. "ctc_head,decoder" adapts the heads
                                   # and freezes the encoder). The outer loop
                                   # still trains everything. See meta/maml.py
                                   # MetaAlgoConfig.adapt_filter — required
                                   # for stable conformer meta-training
                                   # (docs/DESIGN.md section 8).
    adapt_widen_step: int = 0      # staged ANIL: leaves OUTSIDE
                                   # adapt_filter join the inner loop at
                                   # this outer step (traced 0/1 gate like
                                   # inner_start_step; one compiled step).
                                   # Composes the two working conformer
                                   # fixes: decoder-only inner adaptation
                                   # while the body organizes, full-body
                                   # adaptation once converged (DESIGN
                                   # section 8: a converged body tolerates
                                   # the inner SGD that destroys an
                                   # organizing one). Requires
                                   # adapt_filter; 0 = off. Eval/meta-test
                                   # adaptation uses the END-state inner
                                   # loop (all leaves). fomaml/maml only.


@dataclass
class DataConfig:
    data_dir: str = "data/synthetic"
    accents: tuple = ()            # empty -> all accents in the manifest dir
    heldout_accents: tuple = ()
    batch_size: int = 16
    max_frames: int = 1600         # pre-subsampling length cap
    max_tokens: int = 128
    frame_buckets: tuple = (256, 512, 1024, 1600)
    token_buckets: tuple = (32, 64, 128)
    # bucketed meta batches: each meta-step pads to the smallest
    # (frame_buckets x token_buckets) shape that fits its longest drawn
    # utterance instead of the global (max_frames, max_tokens) cap
    meta_buckets: bool = True
    vocab: str = "char"            # "char" | "phone" | "bpe"
    # worker processes of the grain loader (train/mono.py reads it; 0 =
    # batches built in the training process)
    num_workers: int = 0
    # the baseline trainers' feed (train/mono.py): "buckets"
    # (BucketBatcher, exact (seed, step) resume, bucketed shapes) or
    # "grain" (data/grain_loader.py: worker-parallel, at the caps, its
    # iterator state checkpointed beside the train state)
    loader: str = "buckets"
    seed: int = 0
    # per-accent dev split for training accents (0 = use held-out accents
    # as dev, as in the meta setting)
    dev_fraction: float = 0.0
    # keep decoded waveforms in host RAM (meta-training re-draws utterances
    # every step; decode once). Disable for corpora larger than RAM.
    cache_audio: bool = True
    # device-resident corpus for meta-training (MetaASRTrainer.meta_train):
    # the corpus, collated once at the caps, is copied to the trainer's
    # device, and each step copies only its index arrays and gathers its
    # batch there. "auto" = resident when the packed corpus, reckoned by
    # data/sampler.py::resident_store_bytes, is within resident_max_gb
    # (10^9 bytes); "off" (or auto over the budget) streams collated
    # batches from a producer thread. YAML's unquoted on / off count.
    resident: str = "auto"         # "auto" | "on" | "off"
    resident_max_gb: float = 4.0


@dataclass
class MeshConfig:
    # Logical mesh axes: meta tasks shard over "task", within-task batch over
    # "data" (BASELINE.json:11; SURVEY.md section 2.3 / 5.8).
    task_axis: int = 1
    data_axis: int = -1            # -1: use all remaining devices


@dataclass
class TrainConfig:
    mode: str = "train"            # "train" | "adapt" | "test"
    max_steps: int = 10000
    eval_every: int = 1000
    log_every: int = 100
    ckpt_every: int = 1000
    ckpt_dir: str = "ckpts"
    # latest checkpoints retained (best is kept separately); must be
    # >= the N used with --avg-last model averaging
    keep_ckpts: int = 5
    keep_best_metric: str = "dev_wer"
    seed: int = 0
    beam_size: int = 10
    decode_ctc_weight: float = 0.3
    length_penalty: float = 0.0
    # suppress eos while decode step < beam_min_len (static-shape
    # analogue of ESPnet's minlenratio; 0 = off)
    beam_min_len: int = 0
    # CTC-score only the top-N attention candidates per hypothesis
    # (ESPnet candidate pruning; 0 = full vocab)
    ctc_candidates: int = 0
    # rank final beam hypotheses by score/length (ESPnet length norm)
    normalize_final: bool = False
    # coverage penalty at final beam ranking (0 = off): reward per valid
    # encoder frame with accumulated cross-attention > coverage_tau
    coverage_weight: float = 0.0
    coverage_tau: float = 0.5
    # shallow fusion at beam decode (0 = off): score lm_weight *
    # log p_LM(token) from the LSTM LM checkpoint at lm_ckpt (an npz
    # written by scripts/train_lm.py; architecture recovered from the
    # parameter shapes)
    lm_weight: float = 0.0
    lm_ckpt: str = ""
    # decode mode for periodic held-out eval / best-ckpt selection:
    # "beam" (greedy for non-transformer archs) or "greedy"
    eval_decode_mode: str = "beam"
    # utterances per held-out accent scored at periodic evals (bounds the
    # cost of beam-mode best-ckpt tracking)
    eval_max_utts: int = 32
    # k-shot support draws averaged per held-out eval: a single draw's WER
    # is too noisy for best-checkpoint selection
    eval_support_draws: int = 3
    # the reference's persistent compile cache (kept so configs load)
    compile_cache_dir: str = "~/.cache/metaasr_tpu/jax_cache"
    # the reference's PRNG implementation (kept so configs load)
    prng_impl: str = "rbg"
    # stop after N dev evals without improvement (0 = off) — the
    # reference's early stop on dev (SURVEY.md section 2.1 #3)
    early_stop_patience: int = 0
    # log N decoded dev samples per eval (SURVEY.md section 2.1 #19)
    log_text_samples: int = 2


@dataclass
class Config:
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    specaug: SpecAugmentConfig = field(default_factory=SpecAugmentConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    meta: MetaConfig = field(default_factory=MetaConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def _coerce_scalar(s: str):
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def _from_dict(cls, d: dict):
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown config key {cls.__name__}.{k}")
        ftype = fields[k].type
        default = (fields[k].default_factory()
                   if fields[k].default_factory is not dataclasses.MISSING
                   else fields[k].default)
        if isinstance(v, dict):
            kwargs[k] = (_from_dict(type(default), v)
                         if dataclasses.is_dataclass(default) else v)
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        elif isinstance(default, tuple) and isinstance(v, str):
            # CLI override of a list field: comma-separated string;
            # numeric elements keep their numeric type
            kwargs[k] = tuple(_coerce_scalar(s) for s in v.split(",") if s)
        elif isinstance(default, tuple) and isinstance(v, (int, float)):
            # CLI override of a list field with a single scalar
            kwargs[k] = (v,)
        else:
            kwargs[k] = v
        del ftype
    return cls(**kwargs)


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def load_config(path: str | None = None, overrides: dict[str, Any] | None = None) -> Config:
    """Load YAML config; apply dotted-key overrides (e.g. ``meta.inner_lr``)."""
    cfg = Config()
    if path:
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        merged = to_dict(cfg)
        _deep_update(merged, raw)
        cfg = _from_dict(Config, merged)
    if overrides:
        d = to_dict(cfg)
        for key, val in overrides.items():
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown override {key}")
            node[parts[-1]] = val
        cfg = _from_dict(Config, d)
    return cfg


def save_config(cfg: Config, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)


def _deep_update(base: dict, upd: dict) -> None:
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
