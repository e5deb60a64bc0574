"""Port vs reference: the training path around the meta-gradients.

The teacher-forced transformer, SpecAugment (with the reference's draws
injected), the outer optimizer against optax, the synthetic corpus and the
task sampler, then the port's trainer end to end on the CPU (one
``meta_train`` step, checkpoint restore, ``meta_adapt``, the adapted
parameters served through a hot swap, the ``--mode train`` CLI). Small
shapes: d=32, 2 heads, 2+2 layers.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metaasr_tpu.config import OptimizerConfig as RefOptConfig
from metaasr_tpu.data import sampler as ref_sampler
from metaasr_tpu.data import synthetic as ref_synthetic
from metaasr_tpu.data.audio_io import load_wav as ref_load_wav
from metaasr_tpu.data.dataset import load_accent_datasets as ref_load
from metaasr_tpu.data.tokenizer import CharTokenizer as RefCharTokenizer
from metaasr_tpu.frontend.specaug import spec_augment as ref_spec_augment
from metaasr_tpu.models.losses import prepare_decoder_targets as ref_targets
from metaasr_tpu.train.optimizer import make_optimizer as ref_make_optimizer
from metaasr_tpu_torch import cli, device
from metaasr_tpu_torch.config import Config, OptimizerConfig
from metaasr_tpu_torch.data import sampler, synthetic
from metaasr_tpu_torch.data.audio_io import load_wav
from metaasr_tpu_torch.data.dataset import load_accent_datasets
from metaasr_tpu_torch.data.tokenizer import CharTokenizer
from metaasr_tpu_torch.frontend import specaug
from metaasr_tpu_torch.models.losses import prepare_decoder_targets
from metaasr_tpu_torch.serve.export import ServingDecoder, write_bundle
from metaasr_tpu_torch.train import optimizer
from metaasr_tpu_torch.train.checkpoint import load_params_npz, save_params_npz
from metaasr_tpu_torch.task import ASRTask
from metaasr_tpu_torch.train.meta_train import MetaASRTrainer, to_device
from metaasr_tpu_torch.train.mono import MonoASRTrainer
from metaasr_tpu_torch.weights import flax_to_params, params_to_flax
from tests.test_torch_transformer import VOCAB, flax_and_port
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


# ---------------- teacher-forced transformer ----------------

def test_teacher_forced_forward_matches_flax():
    fm, params, pm, feats, lens = flax_and_port("float32")
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, VOCAB - 1, (2, 5)).astype(np.int32)
    tok_lens = np.array([5, 3], np.int32)
    tokens *= np.arange(5)[None, :] < tok_lens[:, None]
    t_in, _, _ = ref_targets(jnp.asarray(tokens), jnp.asarray(tok_lens),
                             VOCAB - 1)
    want = fm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(lens),
                    t_in, jnp.asarray(tok_lens) + 1, False)
    p_in, _, _ = prepare_decoder_targets(torch.from_numpy(tokens).long(),
                                         torch.from_numpy(tok_lens), VOCAB - 1)
    with torch.no_grad():
        got = pm(torch.from_numpy(feats), torch.from_numpy(lens), p_in,
                 torch.from_numpy(tok_lens) + 1, train=False)
    np.testing.assert_array_equal(got["enc_lens"].numpy(),
                                  np.asarray(want["enc_lens"]))
    for k in ("ctc_logits", "att_logits", "encoder_out"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=0)
    # the serving decoder's incremental steps reproduce the teacher-forced
    # log-probs of the same prefix
    with torch.no_grad():
        enc, enc_lens = pm.encode(torch.from_numpy(feats),
                                  torch.from_numpy(lens))
        caches = pm.decoder_init_state(2, 8)
        cross = pm.decoder_precompute_cross(enc)
        lp_tf = torch.log_softmax(got["att_logits"], -1)
        for step in range(4):
            lp, caches = pm.decoder_step(p_in[:, step: step + 1], step,
                                         caches, enc_lens, cross)
            np.testing.assert_allclose(lp.numpy(), lp_tf[:, step].numpy(),
                                       atol=1e-4, rtol=0)


def test_dropout_draws_from_the_generator():
    pm_args = dict(vocab_size=VOCAB, d_model=32, num_heads=2, d_ff=64,
                   num_encoder_layers=1, num_decoder_layers=1)
    from metaasr_tpu_torch.models.transformer import TransformerASR

    feats = torch.randn(2, 40, 80, generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([40, 31])
    toks = torch.tensor([[VOCAB - 1, 3, 4], [VOCAB - 1, 5, 0]])
    tlens = torch.tensor([3, 2])

    def run(dropout, train, seed):
        torch.manual_seed(0)
        m = TransformerASR(dropout=dropout, **pm_args)
        return m(feats, lens, toks, tlens, train=train,
                 generator=torch.Generator().manual_seed(seed))["att_logits"]

    off = run(0.1, False, 0)
    torch.testing.assert_close(run(0.0, True, 0), off, rtol=0, atol=0)
    torch.testing.assert_close(run(0.1, True, 1), run(0.1, True, 1),
                               rtol=0, atol=0)
    assert not torch.allclose(run(0.1, True, 1), off)
    assert not torch.allclose(run(0.1, True, 1), run(0.1, True, 2))


# ---------------- SpecAugment ----------------

def _reference_draws(key, bsz, d, feat_lens, n_f, w_f, n_t, w_t, ratio,
                     warp):
    """The random numbers the reference's spec_augment draws for ``key``,
    made with the same jax.random calls in the same order."""
    k_f, k_t, k_w = jax.random.split(key, 3)

    def axis(k, valid, n, max_width):
        k_w2, k_s = jax.random.split(k)
        w = jax.random.randint(k_w2, (bsz, n), 0, 1 << 30)
        w = w % (jnp.maximum(max_width, 0)[..., None].astype(jnp.int32) + 1)
        s = jax.random.randint(k_s, (bsz, n), 0, 1 << 30) % jnp.maximum(
            valid[:, None] - w, 1)
        return np.asarray(w), np.asarray(s)

    lens = jnp.asarray(feat_lens)
    lf = lens.astype(jnp.float32)
    draws = {}
    if warp:
        k_c, k_d = jax.random.split(k_w)
        hi = jnp.maximum(lf - warp, warp + 1.0)
        draws["warp_c"] = np.asarray(
            warp + jax.random.uniform(k_c, (bsz,)) * (hi - warp))
        draws["warp_shift"] = np.asarray(
            jax.random.randint(k_d, (bsz,), -warp, warp + 1))
    draws["freq_w"], draws["freq_s"] = axis(
        k_f, jnp.full((bsz,), d, jnp.int32), n_f,
        jnp.full((bsz,), w_f, jnp.int32))
    t_cap = jnp.minimum(jnp.full((bsz,), w_t, jnp.int32),
                        (ratio * lf).astype(jnp.int32))
    draws["time_w"], draws["time_s"] = axis(k_t, lens, n_t, t_cap)
    return draws


@pytest.mark.parametrize("warp", [0, 5])
def test_spec_augment_matches_reference_with_injected_draws(warp):
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((4, 120, 80)).astype(np.float32)
    lens = np.array([120, 97, 40, 11], np.int32)
    kw = dict(num_freq_masks=2, freq_mask_width=27, num_time_masks=2,
              time_mask_width=70, time_mask_max_ratio=0.2, time_warp=warp)
    key = jax.random.PRNGKey(7)
    want = ref_spec_augment(key, jnp.asarray(feats), jnp.asarray(lens), **kw)
    draws = _reference_draws(key, 4, 80, lens, 2, 27, 2, 70, 0.2, warp)
    got = specaug.apply_spec_augment(
        torch.from_numpy(feats), torch.from_numpy(lens),
        {k: torch.tensor(v) for k, v in draws.items()}, warp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # the masks themselves agree exactly
    np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)


def test_spec_augment_draws_respect_caps_and_lengths():
    lens = torch.tensor([200, 120, 30, 6])
    draws = specaug.draw_spec_augment(
        torch.Generator().manual_seed(0), (4, 200, 80), lens,
        num_freq_masks=3, freq_mask_width=27, num_time_masks=4,
        time_mask_width=70, time_mask_max_ratio=0.2, time_warp=5)
    assert draws["freq_w"].shape == (4, 3) and draws["time_w"].shape == (4, 4)
    assert int(draws["freq_w"].max()) <= 27
    assert (draws["freq_s"] < torch.clamp_min(80 - draws["freq_w"], 1)).all()
    cap = specaug.time_mask_cap(lens, 70, 0.2)
    assert torch.equal(cap, torch.tensor([40, 24, 6, 1]))
    assert (draws["time_w"] <= cap[:, None]).all()
    assert (draws["time_s"] < torch.clamp_min(lens[:, None]
                                              - draws["time_w"], 1)).all()
    assert (draws["warp_shift"].abs() <= 5).all()
    out = specaug.apply_spec_augment(torch.ones(4, 200, 80), lens, draws, 5)
    assert out.shape == (4, 200, 80)


# ---------------- optimizer ----------------

@pytest.mark.parametrize("name,schedule,wd", [
    ("adam", "noam", 0.0), ("adam", "constant", 0.01),
    ("sgd", "noam", 0.0), ("adadelta", "constant", 0.0)])
def test_optimizer_matches_optax(name, schedule, wd):
    kw = dict(name=name, lr=0.5 if schedule == "noam" else 0.1,
              schedule=schedule, warmup_steps=3, grad_clip=1.0,
              weight_decay=wd)
    ref_opt = ref_make_optimizer(RefOptConfig(**kw), d_model=32)
    opt = optimizer.make_optimizer(OptimizerConfig(**kw), d_model=32)
    rng = np.random.default_rng(6)
    params_np = {"a": rng.standard_normal((3, 4)).astype(np.float32),
                 "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    ref_p = jax.tree.map(jnp.asarray, params_np)
    ref_s = ref_opt.init(ref_p)
    p = {"a": torch.from_numpy(params_np["a"]),
         "b": {"c": torch.from_numpy(params_np["b"]["c"])}}
    s = opt.init(p)
    for step in range(5):
        # norms straddle the clip: scaled 0.2x .. 3x
        g_np = jax.tree.map(
            lambda x: ((0.2 + 0.7 * step) * rng.standard_normal(x.shape))
            .astype(np.float32), params_np)
        u, ref_s = ref_opt.update(jax.tree.map(jnp.asarray, g_np), ref_s,
                                  ref_p)
        ref_p = optax.apply_updates(ref_p, u)
        g = {"a": torch.from_numpy(g_np["a"]),
             "b": {"c": torch.from_numpy(g_np["b"]["c"])}}
        u_t, s = opt.update(g, s, p)
        p = optimizer.apply_updates(p, u_t)
        np.testing.assert_allclose(p["a"].numpy(), np.asarray(ref_p["a"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(p["b"]["c"].numpy(),
                                   np.asarray(ref_p["b"]["c"]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(optimizer.global_norm(g)),
        float(optax.global_norm(jax.tree.map(jnp.asarray, g_np))), rtol=1e-6)


# ---------------- data ----------------

ACCENTS = ("alpha", "bravo", "echo", "delta")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    ref_dir = str(tmp_path_factory.mktemp("ref_corpus"))
    dir_ = str(tmp_path_factory.mktemp("port_corpus"))
    kw = dict(accents=ACCENTS, utts_per_accent=8, words_per_utt=(1, 2),
              seed=3)
    ref_synthetic.generate_dataset(ref_dir, **kw)
    synthetic.generate_dataset(dir_, **kw)
    return ref_dir, dir_


def test_generate_dataset_matches_reference(corpora):
    ref_dir, dir_ = corpora
    for a in ACCENTS:
        with open(os.path.join(ref_dir, f"{a}.jsonl")) as f:
            want = f.read()
        with open(os.path.join(dir_, f"{a}.jsonl")) as f:
            assert f.read() == want
        for line in want.splitlines():
            rel = json.loads(line)["wav"]
            np.testing.assert_array_equal(
                load_wav(os.path.join(dir_, rel)),
                ref_load_wav(os.path.join(ref_dir, rel)))


def test_task_sampler_matches_reference(corpora):
    ref_dir, dir_ = corpora
    kw = dict(k_support=2, k_query=3, tasks_per_batch=3, num_samples=32240,
              num_tokens=16, seed=4, sample_buckets=(8240, 16240, 32240),
              token_buckets=(8, 16))
    ref = ref_sampler.TaskSampler(
        ref_load(ref_dir, RefCharTokenizer.ascii_default()), **kw)
    got = sampler.TaskSampler(
        load_accent_datasets(dir_, CharTokenizer.ascii_default()), **kw)
    for step in range(10):
        want_i, got_i = ref.sample_indices(step), got.sample_indices(step)
        assert want_i[0] == got_i[0]
        for w, g in zip(want_i[1:], got_i[1:]):
            np.testing.assert_array_equal(g, w)
        want_b, got_b = ref.sample(step), got.sample(step)
        assert got_b["accents"] == want_b["accents"]
        for part in ("support", "query"):
            assert got_b[part]["texts"] == want_b[part]["texts"]
            for k, v in want_b[part].items():
                if k != "texts":
                    np.testing.assert_array_equal(got_b[part][k], v)
    s_ref, idx_ref = ref_sampler.support_query_split(
        ref.datasets["echo"], 3, 32240, 16, seed=2)
    s_got, idx_got = sampler.support_query_split(
        got.datasets["echo"], 3, 32240, 16, seed=2)
    assert idx_got == idx_ref
    np.testing.assert_array_equal(s_got["audio"], s_ref["audio"])


# ---------------- trainer, end to end on the CPU ----------------

def _train_cfg(data_dir: str) -> Config:
    cfg = Config()
    m = cfg.model
    m.d_model, m.num_heads, m.d_ff = 32, 2, 64
    m.num_encoder_layers = m.num_decoder_layers = 2
    m.dtype, m.dropout = "float32", 0.1
    cfg.frontend.dither = 1e-3
    cfg.specaug.time_warp = 2
    mc = cfg.meta
    mc.k_support = mc.k_query = mc.tasks_per_batch = 2
    mc.inner_steps, mc.adapt_steps = 2, 2
    mc.grad_dtype = "bfloat16"
    cfg.data.data_dir = data_dir
    cfg.data.heldout_accents = ("delta",)
    cfg.data.max_frames, cfg.data.max_tokens = 200, 16
    cfg.data.frame_buckets, cfg.data.token_buckets = (100, 200), (16,)
    cfg.optimizer.warmup_steps = 10
    cfg.train.log_every = 1
    cfg.train.ckpt_every = 1
    cfg.train.keep_ckpts = 2
    return cfg


def test_meta_train_adapt_and_serve_on_cpu(corpora, tmp_path):
    _, data_dir = corpora
    cfg = _train_cfg(data_dir)
    trainer, tok = cli.make_trainer(cfg, str(tmp_path / "wd"), device="cpu")
    assert sorted(trainer.accent_datasets) == ["alpha", "bravo", "echo"]
    state = trainer.meta_train(max_steps=1)
    assert state["step"] == 1
    recs = [json.loads(line)
            for line in open(tmp_path / "wd" / "logs" / "scalars.jsonl")]
    assert np.isfinite(recs[-1]["meta_loss"]) and recs[-1]["grad_norm"] > 0
    assert trainer.ckpt.all_steps() == [1]
    restored, step = trainer.ckpt.restore()
    assert step == 1
    for k, v in state["params"].items():
        assert torch.equal(restored["params"][k], v)
    trainer.ckpt.save(1, state, is_best=True)
    assert trainer.ckpt.restore_best()["step"] == 1
    init = trainer.init_state()["params"]
    assert any(not torch.equal(init[k], state["params"][k]) for k in init)
    # a second call resumes from the checkpoint and runs one more step
    assert trainer.meta_train(max_steps=2)["step"] == 2
    assert trainer.ckpt.all_steps() == [1, 2]

    adapted, test_idx = trainer.meta_adapt(
        state["params"], trainer.heldout_datasets["delta"], seed=1)
    assert len(test_idx) == 8 - cfg.meta.k_support
    assert any(not torch.equal(adapted[k], state["params"][k])
               for k in adapted)
    npz = str(tmp_path / "adapted.npz")
    save_params_npz(npz, adapted, cfg.model.num_heads)
    tree = load_params_npz(npz)
    back = flax_to_params(tree)
    for k, v in adapted.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)

    bundle = str(tmp_path / "bundle")
    write_bundle(bundle, cfg, params_to_flax(state["params"], 2), tok,
                 [(2, 16240)])
    dec = ServingDecoder(bundle, cfg, device="cpu")
    wave = load_wav(os.path.join(data_dir, "wav", "delta", "delta_0000.wav"))
    swapped = dec.transcribe([wave], params=tree)
    base = dec.transcribe([wave])
    assert isinstance(swapped[0]["text"], str)
    assert swapped[0]["score"] != base[0]["score"]


def test_learn_inner_lr_tree_round_trips(corpora, tmp_path):
    _, data_dir = corpora
    cfg = _train_cfg(data_dir)
    cfg.meta.learn_inner_lr = True
    trainer, _ = cli.make_trainer(cfg, str(tmp_path), device="cpu")
    params = trainer.init_state()["params"]
    assert set(params) == {"model", "inner_lr"}
    tree = params_to_flax(params, 2)
    assert tree["inner_lr"]["encoder"]["layer_0"]["ff"]["Dense_0"][
        "kernel"] == np.float32(cfg.meta.inner_lr)
    back = flax_to_params(tree)
    for part in ("model", "inner_lr"):
        for k, v in params[part].items():
            torch.testing.assert_close(back[part][k], v, rtol=0, atol=0)


def test_cli_train_mode(corpora, tmp_path, capsys):
    _, data_dir = corpora
    rc = cli.main(["--mode", "train", "--device", "cpu", "--data-dir",
                   data_dir, "--workdir", str(tmp_path), "--max-steps", "1",
                   "--algo", "reptile",
                   "-o", "model.d_model=32", "-o", "model.num_heads=2",
                   "-o", "model.d_ff=64", "-o", "model.num_encoder_layers=1",
                   "-o", "model.num_decoder_layers=1",
                   "-o", "meta.tasks_per_batch=2", "-o", "meta.k_support=1",
                   "-o", "meta.k_query=1", "-o", "meta.inner_steps=1",
                   "-o", "data.max_frames=200", "-o", "data.max_tokens=16"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 1
    assert os.path.exists(tmp_path / "ckpts" / "step_1.pt")
    assert os.path.exists(tmp_path / "config.yaml")


def test_cli_trains_config4_maml_at_small_width(corpora, tmp_path, capsys):
    """configs/config4_maml.yaml (algo maml, bf16 compute and meta-step, 2
    inner steps) through the CLI, cut to a small width for the CPU: a
    second-order step with dropout and SpecAugment on."""
    _, data_dir = corpora
    config4 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "configs", "config4_maml.yaml")
    rc = cli.main(["--mode", "train", "--device", "cpu", "--config", config4,
                   "--data-dir", data_dir,
                   "--workdir", str(tmp_path), "--max-steps", "1",
                   "-o", "model.d_model=32", "-o", "model.num_heads=2",
                   "-o", "model.d_ff=64", "-o", "model.num_encoder_layers=1",
                   "-o", "model.num_decoder_layers=1",
                   "-o", "meta.tasks_per_batch=2", "-o", "meta.k_support=2",
                   "-o", "meta.k_query=2", "-o", "train.log_every=1",
                   "-o", "data.max_frames=200", "-o", "data.max_tokens=16"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 1
    from metaasr_tpu_torch.config import load_config

    saved = load_config(str(tmp_path / "config.yaml"))
    assert saved.meta.algo == "maml" and saved.meta.inner_steps == 2
    rec = json.loads(open(tmp_path / "logs" / "scalars.jsonl").readline())
    assert np.isfinite(rec["meta_loss"]) and rec["grad_norm"] > 0


@pytest.mark.parametrize("arch", ["transformer", "vgg_blstm"])
def test_maml_trainer_step_differs_from_fomaml(corpora, tmp_path, arch):
    """MetaASRTrainer with algo maml: the step runs at second order (its
    gradient differs from FOMAML's on the same batch and seed), and a
    VGG-BLSTM task is switched to the twice-differentiable LSTM loop."""
    _, data_dir = corpora
    grads = {}
    for algo in ("fomaml", "maml"):
        cfg = _train_cfg(data_dir)
        cfg.meta.algo, cfg.meta.grad_dtype = algo, "float32"
        cfg.model.dropout, cfg.frontend.dither = 0.0, 0.0
        cfg.specaug.enabled = False
        if arch == "vgg_blstm":
            cfg.model.arch, cfg.model.blstm_hidden = arch, 16
            cfg.model.blstm_layers, cfg.model.vgg_channels = 1, (4, 8)
        trainer, _ = cli.make_trainer(cfg, str(tmp_path / algo), device="cpu")
        if arch == "vgg_blstm":
            assert (cfg.model.lstm_impl == "scan") == (algo == "maml")
        state = trainer.init_state()
        batch = to_device(trainer.sampler.sample(0), "cpu")
        new_state, metrics = trainer.step(state, batch)
        assert np.isfinite(float(metrics["meta_loss"]))
        grads[algo] = torch.cat([
            (new_state["params"][k] - state["params"][k]).flatten()
            for k in state["params"]])
    assert not torch.allclose(grads["maml"], grads["fomaml"], rtol=1e-3,
                              atol=1e-9)


def test_trainer_defaults_to_cuda_without_fallback(corpora, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    _, data_dir = corpora
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.make_trainer(_train_cfg(data_dir), str(tmp_path))
    from metaasr_tpu_torch.task import ASRTask

    task = ASRTask(_train_cfg(data_dir), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MetaASRTrainer(_train_cfg(data_dir), task, {}, {},
                       CharTokenizer.ascii_default(), str(tmp_path))


# ---------------- resuming through the CLI; the precision policy ----------------

@pytest.fixture
def tf32_off():
    """Both TF32 flags off before the test, and as they were after it."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    before = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    yield
    for f, b in zip(flags, before):
        f.allow_tf32 = b


def _under_policy() -> bool:
    return (torch.backends.cuda.matmul.allow_tf32
            == torch.backends.cudnn.allow_tf32 == device.ALLOW_TF32 is True)


def test_cli_resume_keeps_the_recorded_config(corpora, tmp_path, capsys,
                                              tf32_off):
    """--mode train without --config resumes under <workdir>/config.yaml, as
    the reference's CLI does (metaasr_tpu/cli.py), instead of saving
    Config() defaults over it; the run goes on from its checkpoint. The CLI
    runs under the precision policy."""
    _, data_dir = corpora
    config3 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "configs", "config3_fomaml.yaml")
    rc = cli.main(["--mode", "train", "--device", "cpu", "--config", config3,
                   "--data-dir", data_dir, "--workdir", str(tmp_path),
                   "--max-steps", "2",
                   "-o", "model.d_model=32", "-o", "model.num_heads=2",
                   "-o", "model.d_ff=64", "-o", "model.num_encoder_layers=1",
                   "-o", "model.num_decoder_layers=1",
                   "-o", "meta.tasks_per_batch=2", "-o", "meta.k_support=1",
                   "-o", "meta.k_query=1", "-o", "meta.inner_steps=1",
                   "-o", "train.log_every=1", "-o", "train.ckpt_every=1",
                   "-o", "data.max_frames=200", "-o", "data.max_tokens=16"])
    assert rc == 0 and _under_policy()
    recorded = (tmp_path / "config.yaml").read_bytes()
    rc = cli.main(["--mode", "train", "--device", "cpu",
                   "--workdir", str(tmp_path), "--max-steps", "4"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 4
    assert (tmp_path / "config.yaml").read_bytes() == recorded
    # restored at step 2: the second run logged steps 3 and 4, no others
    with open(tmp_path / "logs" / "scalars.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3, 4]


@pytest.mark.parametrize("entry", ["meta_trainer", "mono_trainer", "serving"])
def test_entry_points_run_under_the_precision_policy(corpora, tmp_path,
                                                     tf32_off, entry):
    """MetaASRTrainer, MonoASRTrainer and ServingDecoder set the port's one
    fp32 policy (device.py) where they resolve their device."""
    _, data_dir = corpora
    cfg = _train_cfg(data_dir)
    tok = CharTokenizer.ascii_default()
    cfg.model.vocab_size = tok.vocab_size
    task = ASRTask(cfg, tok.sos_eos_id, device="cpu")
    if entry == "serving":
        write_bundle(str(tmp_path / "b"), cfg,
                     params_to_flax(task.init_params(0), 2), tok, [(2, 16240)])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if entry == "meta_trainer":
        MetaASRTrainer(cfg, task, {}, {}, tok, str(tmp_path), device="cpu")
    elif entry == "mono_trainer":
        MonoASRTrainer(cfg, task, [], None, tok, str(tmp_path), device="cpu")
    else:
        ServingDecoder(str(tmp_path / "b"), cfg, device="cpu")
    assert _under_policy()
