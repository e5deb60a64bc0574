"""Port vs reference: config2's path, the multitask transformer.

``configs/config2_multitask_transformer.yaml`` (joint CTC-attention
transformer, ``algo: multi``, Adam on Noam with the yaml's lr 1.0 and 4,000
warm-up steps, clip 5) through both packages' ``cli.make_trainer`` at the
port tests' width (d 32, 2 heads, 2 + 2 layers, d_ff 64) on three accents
of the port's synthetic corpus, batches of 4. Dropout 0, SpecAugment off
and dither 0, so the step's ``train=True`` draws nothing in either package.
The port's seeded weights go into the reference through
``weights.params_to_flax``; three steps of the reference's ``_jit_step``
against the port's ``MultitaskASRTrainer.step`` in fp32, then one step in
bf16, config2's own ``model.dtype``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaasr_tpu import cli as ref_cli
from metaasr_tpu.config import load_config as ref_load_config
from metaasr_tpu.train.mono import TrainState, device_batch, init_track
from metaasr_tpu_torch import cli
from metaasr_tpu_torch.config import load_config
from metaasr_tpu_torch.data import synthetic
from metaasr_tpu_torch.models.transformer import TransformerASR
from metaasr_tpu_torch.train.meta_train import to_device
from metaasr_tpu_torch.train.mono import MultitaskASRTrainer
from metaasr_tpu_torch.train.optimizer import noam_schedule
from metaasr_tpu_torch.weights import flatten_tree, params_to_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG2 = os.path.join(REPO, "configs", "config2_multitask_transformer.yaml")
ACCENTS = ("alpha", "bravo", "echo")
SMALL = {"model.d_model": 32, "model.num_heads": 2, "model.d_ff": 64,
         "model.num_encoder_layers": 2, "model.num_decoder_layers": 2,
         "model.dropout": 0.0, "specaug.enabled": False,
         "frontend.dither": 0.0,
         "frontend.use_pallas": False,   # the reference's jnp front-end
         "data.batch_size": 4}
STEPS = 3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("config2_corpus"))
    synthetic.generate_dataset(d, accents=ACCENTS, utts_per_accent=14,
                               words_per_utt=(1, 3), seed=3)
    return d


def _trainers(corpus, tmp_path, dtype):
    """(reference trainer, its TrainState, port trainer, its state), both
    at the port's seeded weights."""
    over = {**SMALL, "model.dtype": dtype, "data.data_dir": corpus}
    ref, _ = ref_cli.make_trainer(ref_load_config(CONFIG2, dict(over)),
                                  str(tmp_path / "ref"))
    port, _ = cli.make_trainer(load_config(CONFIG2, dict(over)),
                               str(tmp_path / "port"), device="cpu")
    state = port.init_state()
    params = jax.tree.map(jnp.asarray, params_to_flax(state["params"], 2))
    ref_state = TrainState(params=params,
                           opt_state=ref.optimizer.init(params), step=0,
                           rng=jax.random.PRNGKey(0), **init_track())
    return ref, ref_state, port, state


def _step_both(ref, ref_state, port, state, batch):
    ref_state, ref_m = ref._jit_step(ref_state,
                                     jax.device_put(device_batch(batch)))
    state, m = port.step(state, to_device(batch, "cpu"))
    return ref_state, ref_m, state, m


def key_bias(name: str, shape) -> slice | None:
    """The components of a leaf that are an attention key's bias: all of a
    cross-attention ``k/bias``, the middle third of a self-attention
    ``qkv/bias`` (output order (3, H, Dh))."""
    if name.endswith("/k/bias"):
        return slice(None)
    if name.endswith("/qkv/bias"):
        d = shape[0] // 3
        return slice(d, 2 * d)
    return None


def test_config2_trainer_matches_reference(corpus, tmp_path):
    """The trainer both packages build from config2: same class, same
    pooled index, same batches; three fp32 steps from the same weights.
    Loss within rtol 1e-4 and ``grad_norm`` within rtol 1e-3 at every step.
    After step 3 each leaf's update (its value less its start) is compared
    with the reference's, so that a wrong step shows however small Noam's
    early rate makes it (a step moves a weight matrix by ~1e-5 of its
    norm): relative L2 within 1e-3 for every leaf, and every leaf moved.
    The bound is 1e-3, not 1e-4: Adam's first step is lr * g / (|g| + eps)
    per component, ~lr * sign(g) in both packages, but its second and third
    divide by running moments of gradients that differ in the last bits,
    and components with a gradient near zero carry that difference into the
    update. Measured: loss 1.4e-7 and ``grad_norm`` 1.4e-6 relative; the
    worst update 3.0e-4 (encoder layer 1's attention output kernel), most
    leaves below 1e-4.

    An attention key's bias adds the same ``q . b`` to every logit of a
    query's row, which softmax ignores: its exact gradient is zero, both
    packages compute rounding noise, and Adam turns the noise into a step of
    up to the rate either way. Those components (and the leaves that are
    nothing else) are left out of the comparison and held instead to
    Adam's step size: |update| <= 1.01 x the sum of Noam's three rates, in
    either package (Adam's bias-corrected |m| / sqrt(v) stays below 1.01 in
    the first three steps at b1 0.9, b2 0.98). Measured: at most 0.13 of
    that bound."""
    ref, ref_state, port, state = _trainers(corpus, tmp_path, "float32")
    assert type(port).__name__ == type(ref).__name__ == "MultitaskASRTrainer"
    assert isinstance(port, MultitaskASRTrainer)
    assert port.accents == sorted(ACCENTS)
    assert port.batcher.index == ref.batcher.index
    assert len(port.batcher.index) == 3 * 14
    start = flatten_tree(params_to_flax(state["params"], 2))
    feed, ref_feed = port.batcher.iter_from(0), ref.batcher.iter_from(0)
    for _ in range(STEPS):
        batch, ref_batch = next(feed), next(ref_feed)
        assert batch["texts"] == ref_batch["texts"]
        np.testing.assert_array_equal(batch["audio"], ref_batch["audio"])
        ref_state, ref_m, state, m = _step_both(ref, ref_state, port, state,
                                                batch)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-3)
    assert state["step"] == STEPS == int(ref_state.step)
    want = flatten_tree(jax.tree.map(np.asarray, ref_state.params))
    got = flatten_tree(params_to_flax(state["params"], 2))
    assert got.keys() == want.keys() == start.keys()
    lr = noam_schedule(1.0, SMALL["model.d_model"], 4000)
    max_step = 1.01 * sum(lr(t) for t in range(STEPS))
    worst = ("", 0.0)
    for k, w in want.items():
        moved, want_moved = got[k] - start[k], w - start[k]
        keys = key_bias(k, moved.shape)
        if keys is not None:
            # the key bias's gradient is rounding noise (see the docstring)
            for d in (moved[keys], want_moved[keys]):
                assert np.abs(d).max() <= max_step, (k, np.abs(d).max())
            moved[keys] = want_moved[keys] = 0.0
            if not want_moved.any():
                continue
        assert np.linalg.norm(want_moved) > 0, k
        l2rel = np.linalg.norm(moved - want_moved) / np.linalg.norm(want_moved)
        worst = max(worst, (k, l2rel), key=lambda x: x[1])
    assert worst[1] <= 1e-3, worst


def test_config2_bf16_step_matches_reference(corpus, tmp_path):
    """One step in bf16 compute with fp32 weights (config2's own
    ``model.dtype``). bf16 keeps 8 significant bits (a relative ulp of
    3.9e-3), and the two frameworks round at different places: XLA fuses
    and keeps fp32 intermediates where PyTorch rounds each op's output.
    The loss and the norm are sums over many such terms, so their gaps
    stay far below one ulp. Measured: loss 8.1e-5, ``grad_norm`` 6.0e-4
    relative. Bounds: loss rtol 1e-3, ``grad_norm`` rtol 5e-3. The
    parameters are not compared: Adam's first update is ~lr * sign(g),
    so components whose gradient is near zero take either sign in either
    package (LayerNorm biases, which start at zero, differ by up to 0.35
    relative L2 after the step)."""
    ref, ref_state, port, state = _trainers(corpus, tmp_path, "bfloat16")
    batch = next(port.batcher.iter_from(0))
    _, ref_m, state, m = _step_both(ref, ref_state, port, state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=5e-3)
    assert all(torch.isfinite(v).all() for v in state["params"].values())


def test_config2_yaml_builds_the_multitask_transformer(corpus, tmp_path):
    """``make_trainer`` on the yaml itself, width untouched: a
    ``MultitaskASRTrainer`` over ``TransformerASR`` at d 256, 12 + 6 layers,
    bf16; without CUDA and without ``device="cpu"`` it raises."""
    cfg = load_config(CONFIG2, {"data.data_dir": corpus})
    trainer, tok = cli.make_trainer(cfg, str(tmp_path / "wd"), device="cpu")
    assert isinstance(trainer, MultitaskASRTrainer)
    model = trainer.task.model
    assert isinstance(model, TransformerASR)
    m = cfg.model
    assert (m.d_model, m.num_heads, m.d_ff, m.num_encoder_layers,
            m.num_decoder_layers, m.dtype) == (256, 4, 2048, 12, 6,
                                               "bfloat16")
    assert (cfg.optimizer.schedule, cfg.optimizer.warmup_steps,
            cfg.data.batch_size, m.vocab_size) == ("noam", 4000, 32,
                                                   tok.vocab_size)
    assert len(model.encoder.layers) == 12
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.make_trainer(load_config(CONFIG2, {"data.data_dir": corpus}),
                             str(tmp_path / "wd2"))
